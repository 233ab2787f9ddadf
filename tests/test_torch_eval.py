"""The port's evaluation (desire_tpu_torch/eval) against the JAX package's
on the CPU: every metric function at float32, the per-batch eval step,
``evaluate`` and ``fit_rank_blend`` over a toy tree with the JAX draws of
the latent noise pinned batch by batch, and the eval-time latent
temperature through ``desire_forward``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desire_tpu.config import DesireConfig as JConfig
from desire_tpu.data.loader import SDDLoader as JLoader
from desire_tpu.eval import metrics as JM
from desire_tpu.eval import sampler as jsampler
from desire_tpu.models import desire as jdesire
from desire_tpu_torch.config import DesireConfig as TConfig
from desire_tpu_torch.data.loader import SDDLoader as TLoader
from desire_tpu_torch.eval import metrics as TM
from desire_tpu_torch.eval import sampler as tsampler
from desire_tpu_torch.models import desire as tdesire
from desire_tpu_torch.params import from_jax, init_desire, to_numpy

# metric functions at float32: the same formulas, other summation orders
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
# a whole forward and the metrics on it (the forward's own float32
# tolerance is 2e-4 relative on scores, tests/test_torch_desire.py)
EVAL_TOL = dict(rtol=1e-4, atol=1e-4)

_MODEL = dict(max_num_obj=4, obs_len=4, pred_len=3, num_samples=3,
              d_dim=16, latent_size=8, embedding_size=8,
              channel_multiplier=10, scene_grid=8, scene_channels=4,
              num_refine=2, compute_dtype="float32", rnn_size=128)


@pytest.fixture(scope="module")
def jax_params():
    """The port's init, converted (tests/test_torch_desire.py), with the
    zero-init heads made non-zero."""
    p = to_numpy(init_desire(TConfig(**_MODEL),
                             torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(1)
    for sub, name in (("sgm", "prior"), ("sgm", "ztemp_fc2"),
                      ("ioc", "delta"), ("ioc", "gate")):
        w = p[sub][name]["w"]
        p[sub][name]["w"] = (0.3 * rng.standard_normal(w.shape)).astype(
            np.float32)
    return jax.tree_util.tree_map(jnp.asarray, p)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# -- the metric functions -------------------------------------------------------

def _metric_inputs(seed=0, b=3, a=4, k=5, t=6):
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(0, 2.0, (b, a, t, 2)), axis=2) + 50.0
    pred = gt[:, :, None] + rng.normal(0, 3.0, (b, a, k, t, 2))
    sm = (rng.random((b, a, t)) > 0.2).astype(np.float32)
    sm[0, 0] = 0.0                       # an agent without a future
    sm[0, 1, 3:] = 0.0                   # one whose future ends early
    gt[0, 2, 2] = gt[0, 2, 1]            # a step without a tangent
    am = (rng.random((b, a)) > 0.2).astype(np.float32)
    scores = rng.normal(size=(b, a, k))
    scores[1, 1, :2] = 3.0               # a tie: the first maximum
    scale = rng.uniform(0.5, 2.0, (b,))
    raw5 = rng.normal(0, 0.5, (b, a, k, t, 5))
    raw5[..., :2] += gt[:, :, None] / 50.0
    f = lambda x: np.asarray(x, np.float32)
    return dict(pred=f(pred / 50.0), gt=f(gt / 50.0), sm=f(sm), am=f(am),
                scores=f(scores), scale=f(scale * 50.0), raw5=f(raw5))


def _metric_cases():
    return {
        "displacement_errors": lambda M, d: M.displacement_errors(
            d["pred"], d["gt"], d["sm"]),
        "min_ade_fde": lambda M, d: M.min_ade_fde(
            d["pred"], d["gt"], d["sm"], d["am"], d["scale"]),
        "per_agent_min_ade_fde": lambda M, d: M.per_agent_min_ade_fde(
            d["pred"], d["gt"], d["sm"], d["scale"]),
        "track_decomposition": lambda M, d: M.track_decomposition(
            d["pred"], d["gt"], d["sm"], d["scale"]),
        "best_of_k_by_score": lambda M, d: M.best_of_k_by_score(
            d["pred"], d["scores"]),
        "best_of_k_by_score_blend": lambda M, d: M.best_of_k_by_score(
            d["pred"], d["scores"], blend=0.5),
        "horizon_ade_fde_fractional": lambda M, d: M.horizon_ade_fde(
            d["pred"], d["gt"], d["sm"], d["am"], 2.5, d["scale"]),
        "horizon_ade_fde_whole": lambda M, d: M.horizon_ade_fde(
            d["pred"], d["gt"], d["sm"], d["am"], 3.0, d["scale"]),
        "per_agent_horizon": lambda M, d: M.per_agent_horizon(
            d["pred"], d["gt"], d["sm"], 1.25, d["scale"]),
        "per_agent_ranking": lambda M, d: M.per_agent_ranking(
            d["scores"], d["pred"], d["gt"], d["sm"]),
        "ranking_quality": lambda M, d: M.ranking_quality(
            d["scores"], d["pred"], d["gt"], d["sm"], d["am"]),
        "pit_values": lambda M, d: M.pit_values(
            d["raw5"], d["gt"], d["sm"], d["am"]),
        "pit_values_tau": lambda M, d: M.pit_values(
            d["raw5"], d["gt"], d["sm"], d["am"], sigma_temp=0.7),
        "pit_values_pair": lambda M, d: M.pit_values(
            d["raw5"], d["gt"], d["sm"], d["am"], sigma_temp=(0.2, 1.3)),
        "pit_values_weighted_pair": lambda M, d: M.pit_values(
            d["raw5"], d["gt"], d["sm"], d["am"],
            sigma_temp=(0.1, 1.7, 0.65)),
        "pit_histogram": lambda M, d: M.pit_histogram(
            *M.pit_values(d["raw5"], d["gt"], d["sm"], d["am"]), 10),
        "coverage": lambda M, d: tuple(M.coverage(
            *M.pit_values(d["raw5"], d["gt"], d["sm"], d["am"])).values()),
    }


@pytest.mark.parametrize("name", sorted(_metric_cases()))
def test_metric_matches_jax(name):
    fn = _metric_cases()[name]
    d = _metric_inputs()
    ref = fn(JM, {k: jnp.asarray(v) for k, v in d.items()})
    got = fn(TM, {k: _t(v) for k, v in d.items()})
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(r), err_msg=name,
                                   **METRIC_TOL)


# -- the eval step, evaluate and fit_rank_blend --------------------------------

def _eps(cfg, key, rows):
    """The latent draw of the JAX eval step called with ``key`` (its
    forward takes split(key)[0], the sampler split(.., 3)[0])."""
    k1, _ = jax.random.split(key)
    return np.array(jax.random.normal(jax.random.split(k1, 3)[0],
                                      (rows, cfg.num_samples,
                                       cfg.latent_size)))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b, a, t = cfg.batch_size, cfg.max_num_obj, cfg.total_len
    xy = np.cumsum(rng.normal(0, 0.02, (b, t, a, 2)), axis=1) + 0.5
    xy = xy.astype(np.float32)
    mask = np.ones((b, t, a), np.float32)
    mask[:, :, -1] = 0.0
    mask[0, 0, 0] = 0.0
    mask[1, -2:, 1] = 0.0
    ids = np.tile(np.arange(1, a + 1), (b, 1)).astype(np.float32)
    ids[:, -1] = 0.0
    scale = np.array([400.0, 900.0][:b], np.float32)
    return xy, mask, ids, scale


STEP_KW = dict(horizon_steps=(1.5, 3.0), calibration=True,
               sigma_temps=(1.0, 0.7, (0.2, 1.3, 0.6)), rank_blend=0.4,
               z_temp_fast=1.5, z_temp_px=3.0)


def test_eval_step_matches_jax(jax_params):
    """Every per-batch metric of make_eval_step, with the speed-dependent
    latent temperature, horizons and calibration on."""
    kw = dict(_MODEL, batch_size=2)
    jc, tc = JConfig(**kw), TConfig(**kw)
    xy, mask, ids, scale = _batch(tc)
    key = jax.random.PRNGKey(11)
    ref = jax.device_get(jsampler.make_eval_step(jc, **STEP_KW)(
        jax_params, *map(jnp.asarray, (xy, mask, ids)), key,
        jnp.asarray(scale)))
    got = tsampler.make_eval_step(tc, **STEP_KW)(
        from_jax(jax_params), *map(_t, (xy, mask, ids, scale)),
        eps=_t(_eps(tc, key, xy.shape[0] * xy.shape[2])))
    assert set(got) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], np.stack(r) if isinstance(
            r, tuple) else np.asarray(r), err_msg=name, **EVAL_TOL)
    # the fast agents sampled hotter: the noise reached the forward
    assert np.any(got["speed"] >= STEP_KW["z_temp_px"])


def _micro_tree(root):
    """One scene of two videos, agents on straight lines (as
    tests/test_train.py builds it), 8 windows at the geometry below."""
    rng = np.random.RandomState(0)
    for vid in ("video0", "video1"):
        path = os.path.join(str(root), f"scene/{vid}/annotations_processed.csv")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        recs = []
        for aid in range(1, 7):
            v, p0 = rng.uniform(-1.5, 1.5, 2), rng.uniform(20, 80, 2)
            recs += [(f, aid, *(p0 + v * f)) for f in range(60)]
        with open(path, "w") as f:
            for row in np.asarray(recs, np.float64).T:
                f.write(",".join(f"{x:g}" for x in row) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _micro_tree(tmp_path_factory.mktemp("eval_tree"))


def _loaders(tree, monkeypatch, tmp_path, **kw):
    """The JAX and the port's loader over the same windows; batches of 3
    with a short last one."""
    monkeypatch.setenv("DESIRE_CACHE_DIR", str(tmp_path / "j"))
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", str(tmp_path / "t"))
    base = dict(_MODEL, batch_size=3, subsample=2, window_hop=3,
                holdout="none", data_dir=tree, seed=4, **kw)
    jc, tc = JConfig(**base), TConfig(**base)
    jl = JLoader(jc, use_native=False, drop_remainder=False)
    tl = TLoader(tc, use_native=False, drop_remainder=False)
    assert jl.num_windows % 3 and tl.num_batches == jl.num_batches > 2
    return jc, tc, jl, tl


def _key_chain(seed, n):
    """The per-batch keys of the JAX harness: key, sub = split(key)."""
    key, subs = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def _batch_rows(loader):
    """Agent rows (windows x slots) of each batch of an epoch."""
    bs, n = loader.cfg.batch_size, loader.num_windows
    return [min(bs, n - i * bs) * loader.cfg.max_num_obj
            for i in range(loader.num_batches)]


def _assert_tree_close(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_tree_close(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_tree_close(g, r, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(ref, np.float64),
                                   err_msg=path, **EVAL_TOL)


def test_evaluate_matches_jax(jax_params, tree, monkeypatch, tmp_path):
    """evaluate over every batch (the short last one included), with every
    breakdown on: all keys within 1e-4 relative."""
    jc, tc, jl, tl = _loaders(tree, monkeypatch, tmp_path)
    kw = dict(per_scene=True, horizons=(0.1, 0.2), calibration=True,
              speed_bins=(1.0, 3.0), rank_blend=0.4, z_temp_fast=1.5,
              z_temp_px=2.0, sigma_temps=(1.0, 0.8))
    ref = jsampler.evaluate(jax_params, jc, jl, **kw)
    eps = [_eps(tc, k, rows) for k, rows in zip(
        _key_chain(jc.seed + 1, tl.num_batches), _batch_rows(tl))]
    got = tsampler.evaluate(from_jax(jax_params), tc, tl, eps=eps, **kw)
    _assert_tree_close(got, ref)
    assert ref["num_agents"] > 0 and "horizons" in got


def test_fit_rank_blend_matches_jax(jax_params, tree, monkeypatch,
                                    tmp_path):
    """The same blend chosen, the same top-1 ADE at every blend."""
    jc, tc, jl, tl = _loaders(tree, monkeypatch, tmp_path)
    blends = (0.0, 0.5, 1.0, 2.0)
    bl_j, diag_j = jsampler.fit_rank_blend(jax_params, jc, jl,
                                           blends=blends)
    eps = [_eps(tc, k, rows) for k, rows in zip(
        _key_chain(jc.seed + 7, tl.num_batches), _batch_rows(tl))]
    bl_t, diag_t = tsampler.fit_rank_blend(from_jax(jax_params), tc, tl,
                                           blends=blends, eps=eps)
    assert bl_t == bl_j
    _assert_tree_close(diag_t, diag_j)


@pytest.mark.parametrize("variant", [dict(), dict(use_pallas=False)])
def test_z_temp_forward_matches_jax(variant, jax_params):
    """desire_forward(train=False) with a per-agent latent temperature,
    through the fused sampler's plain version and layer by layer."""
    kw = dict(_MODEL, batch_size=2, **variant)
    jc, tc = JConfig(**kw), TConfig(**kw)
    xy, mask, ids, _ = _batch(tc)
    zt = np.random.default_rng(2).uniform(0.5, 2.0, (2, tc.max_num_obj)
                                           ).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, *a: jdesire.desire_forward(
        p, jc, *a[:3], key=key, train=False, z_temp=a[3]))(
            jax_params, *map(jnp.asarray, (xy, mask, ids, zt)))
    eps = np.array(jax.random.normal(jax.random.split(key, 3)[0],
                                     (2 * tc.max_num_obj, tc.num_samples,
                                      tc.latent_size)))
    got = tdesire.desire_forward(from_jax(jax_params), tc,
                                 *map(_t, (xy, mask, ids)), eps=_t(eps),
                                 z_temp=_t(zt))
    plain = tdesire.desire_forward(from_jax(jax_params), tc,
                                   *map(_t, (xy, mask, ids)), eps=_t(eps))
    for name in ("raw5", "sgm_traj", "refined_traj", "scores"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   err_msg=name, rtol=2e-4, atol=2e-4)
    assert not torch.allclose(got["sgm_traj"], plain["sgm_traj"])
