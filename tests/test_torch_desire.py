"""Port parity of the whole serving slice: desire_forward(train=False) and
serve.Predictor against the JAX package on the same parameters, inputs and
latent noise (f32)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desire_tpu.config import DesireConfig
from desire_tpu.models import desire as jdesire
from desire_tpu.serve import Predictor as JaxPredictor
from desire_tpu_torch.models import desire as tdesire
from desire_tpu_torch.params import from_jax, init_desire, to_numpy
from desire_tpu_torch.serve import Predictor, forecast_to_json

# the JAX kernel suite's f32 tolerances (tests/test_kernels.py)
TOL = dict(rtol=2e-4, atol=2e-5)
SCORE_TOL = dict(rtol=2e-4, atol=2e-4)


def _cfg(**kw):
    base = dict(batch_size=2, max_num_obj=4, obs_len=4, pred_len=3,
                num_samples=3, d_dim=16, latent_size=8, embedding_size=8,
                channel_multiplier=10, scene_grid=8, scene_channels=4,
                num_refine=2, compute_dtype="float32", rnn_size=128)
    base.update(kw)
    return DesireConfig(**base)


@pytest.fixture(scope="module")
def jax_params():
    """One JAX parameter tree for every case of this file (the variants and
    the Predictor's config change no parameter shape). It is drawn by the
    port's init, whose tree is the JAX init's (tests/test_torch_params.py),
    which is much quicker on the CPU than JAX's op-by-op init. The zero-init
    heads (prior, latent temperature, IOC delta and gate) are made non-zero,
    so that no branch is trivially zero."""
    p = to_numpy(init_desire(_cfg(), torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(1)
    for sub, name in (("sgm", "prior"), ("sgm", "ztemp_fc2"),
                      ("ioc", "delta"), ("ioc", "gate")):
        w = p[sub][name]["w"]
        p[sub][name]["w"] = (0.3 * rng.standard_normal(w.shape)).astype(
            np.float32)
    return jax.tree_util.tree_map(jnp.asarray, p)


def _toy_batch(cfg, seed=0):
    """tests/test_model.py _toy_batch, from numpy: the last agent is dead,
    and one observed step of agent 0 is masked."""
    b, a, t = cfg.batch_size, cfg.max_num_obj, cfg.total_len
    rng = np.random.default_rng(seed)
    xy = (rng.uniform(size=(b, t, a, 2)) * 0.5 + 0.25).astype(np.float32)
    mask = np.ones((b, t, a), np.float32)
    mask[:, :, -1] = 0.0
    mask[0, 0, 0] = 0.0
    ids = np.tile(np.arange(1, a + 1), (b, 1)).astype(np.float32)
    ids[:, -1] = 0.0
    return xy, mask, ids


def _eps(cfg, key, rows):
    """The latent draw of JAX desire_forward(train=False)."""
    return np.array(jax.random.normal(
        jax.random.split(key, 3)[0],
        (rows, cfg.num_samples, cfg.latent_size)))


@pytest.mark.parametrize("variant", [
    dict(), dict(use_pallas=False), dict(social_freeze=True),
    dict(use_social=False)])
def test_desire_forward_matches_jax(variant, jax_params):
    """use_pallas / use_social select the port's fused-kernel path (plain
    versions on the CPU) or its layer-by-layer path. The JAX reference is
    jitted: one compile costs less on the CPU than its op-by-op first run."""
    cfg = _cfg(**variant)
    jp = jax_params
    xy, mask, ids = _toy_batch(cfg)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, *batch: jdesire.desire_forward(
        p, cfg, *batch, key=key, train=False))(
            jp, jnp.asarray(xy), jnp.asarray(mask), jnp.asarray(ids))
    t = lambda x: torch.from_numpy(np.array(x, np.float32))
    eps = _eps(cfg, key, xy.shape[0] * xy.shape[2])
    got = tdesire.desire_forward(from_jax(jp), cfg, t(xy), t(mask), t(ids),
                                 eps=t(eps))
    for name in ("raw5", "sgm_traj", "refined_traj", "zp_mu", "zp_logvar",
                 "live"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), **SCORE_TOL)


def _window(cfg, na, seed, scale=100.0):
    """tests/test_serve.py _window: na straight-line agents in raw pixels."""
    rng = np.random.RandomState(seed)
    to = cfg.obs_len
    t = np.arange(to, dtype=np.float32)
    p0 = rng.uniform(20, 60, (na, 2)).astype(np.float32)
    v = rng.uniform(-2.0, 2.0, (na, 2)).astype(np.float32)
    oxy = p0[:, None] + v[:, None] * t[None, :, None]
    om = np.ones((na, to), np.float32)
    ids = np.arange(1, na + 1, dtype=np.int64)
    return oxy * (scale / 100.0), om, ids


@pytest.mark.parametrize("blend", [-1.0, 0.5])
def test_predictor_matches_jax(blend, jax_params):
    """Same windows and pinned noise through both Predictors: traj, scores
    and the top-1 pick (with and without the fitted rank blend)."""
    cfg = _cfg(max_num_obj=8, pred_len=4, rank_blend_fit=blend)
    jp = jax_params
    windows = [_window(cfg, 3, 0), _window(cfg, 5, 1)]
    windows[1][1][4, :2] = 0.0          # one agent entered late
    windows[1][2][2] = 0                # one empty slot
    key = jax.random.PRNGKey(7)
    ref = JaxPredictor(params=jp, cfg=cfg, max_windows=2).predict_windows(
        windows, [100.0, 50.0], key)
    eps = _eps(cfg, key, 2 * cfg.max_num_obj)
    pred = Predictor(from_jax(jp), cfg, device="cpu", max_windows=2)
    got = pred.predict_windows(windows, [100.0, 50.0], eps=eps)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["ids"], r["ids"])
        np.testing.assert_array_equal(g["live"], r["live"])
        # positions in pixels: the f32 tolerance scaled by 100 px per unit
        np.testing.assert_allclose(g["traj"], r["traj"], rtol=2e-4,
                                   atol=2e-3)
        np.testing.assert_allclose(g["best"], r["best"], rtol=2e-4,
                                   atol=2e-3)
        np.testing.assert_allclose(g["scores"], r["scores"], **SCORE_TOL)
    assert pred.stats()["calls"] == 1
    rec = json.loads(forecast_to_json(got[1], top_k=2))
    assert [a["id"] for a in rec["agents"]] == [1, 2, 4, 5]
    assert all(len(a["hypotheses"]) == 2 for a in rec["agents"])


def test_predictor_layer_by_layer_bf16(jax_params):
    """In bfloat16 with use_social=False the layer-by-layer IOC (through the
    scene-pool op) scores in bfloat16; the Predictor hands back float32
    arrays, finite, of the forecast shapes."""
    cfg = _cfg(compute_dtype="bfloat16", use_social=False)
    pred = Predictor(from_jax(jax_params), cfg, device="cpu", max_windows=1)
    got = pred.predict_windows([_window(cfg, 3, 0)], 100.0)[0]
    assert got["scores"].dtype == np.float32
    assert got["scores"].shape == (3, cfg.num_samples)
    assert got["traj"].shape == (3, cfg.num_samples, cfg.pred_len, 2)
    assert all(np.isfinite(got[k]).all() for k in ("traj", "scores", "best"))
