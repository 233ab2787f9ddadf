"""The port's sampling tools (desire_tpu_torch/eval/sampler.py) against the
JAX package's on the CPU, at float32 on a toy model: ``make_sampler``
(deterministic and stochastic), ``make_rollout``, ``dump_trajectories``
and ``fit_sigma_temperature`` (scalar and two-parameter), with the JAX
draws pinned (the latent noise of each forward, the two standard normals
of each stochastic draw). Reuses tests/test_torch_eval.py's toy model,
tree and latent pinning."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from desire_tpu.config import DesireConfig as JConfig
from desire_tpu.eval import sampler as jsampler
from desire_tpu_torch.config import DesireConfig as TConfig
from desire_tpu_torch.eval import sampler as tsampler
from desire_tpu_torch.params import from_jax
from test_torch_eval import (_MODEL, _batch, _batch_rows, _eps, _key_chain,
                             _loaders, _t, jax_params, tree)  # noqa: F401

# positions, scores and picks of one forward: float32 on both sides, the
# same arithmetic in other summation orders
SAMPLE_ATOL = 1e-5


def _cfgs(**kw):
    base = dict(_MODEL, batch_size=2, **kw)
    return JConfig(**base), TConfig(**base)


def _draws(key, shape):
    """The standard normals of the JAX stochastic draw made with ``key``
    (make_sampler's split(key)[1], split again in sample_bivariate)."""
    k_a, k_b = jax.random.split(jax.random.split(key)[1])
    return tuple(_t(jax.random.normal(k, shape)) for k in (k_a, k_b))


@pytest.mark.parametrize("stochastic", [False, True])
def test_make_sampler_matches_jax(stochastic, jax_params):
    jc, tc = _cfgs(rank_blend_fit=0.4)
    xy, mask, ids, _ = _batch(tc)
    key = jax.random.PRNGKey(21)
    ref = jsampler.make_sampler(jc, stochastic=stochastic)(
        jax_params, *map(jnp.asarray, (xy, mask, ids)), key)
    b, a = xy.shape[0], xy.shape[2]
    draws = (_draws(key, (b, a, tc.num_samples, tc.pred_len))
             if stochastic else None)
    got = tsampler.make_sampler(tc, stochastic=stochastic)(
        from_jax(jax_params), *map(_t, (xy, mask, ids)),
        eps=_t(_eps(tc, key, b * a)), draws=draws)
    assert set(got) == set(ref)
    for name in ("traj", "scores", "best"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=0, atol=SAMPLE_ATOL, err_msg=name)
    for name in ref:
        assert tuple(got[name].shape) == ref[name].shape, name
    if stochastic:
        # the draw moved the lanes off the refined means
        det = tsampler.make_sampler(tc)(
            from_jax(jax_params), *map(_t, (xy, mask, ids)),
            eps=_t(_eps(tc, key, b * a)))
        assert not np.allclose(got["traj"].numpy(), det["traj"].numpy())


def test_make_rollout_matches_jax(jax_params):
    """Two chunks: each slides the window over the last chunk's top pick."""
    jc, tc = _cfgs()
    xy, mask, ids, _ = _batch(tc)
    to = tc.obs_len
    obs_xy = np.swapaxes(xy[:, :to], 1, 2)
    obs_mask = np.swapaxes(mask[:, :to], 1, 2)
    key = jax.random.PRNGKey(8)
    ref = jsampler.make_rollout(jc)(
        jax_params, *map(jnp.asarray, (obs_xy, obs_mask, ids)), key,
        num_chunks=2)
    # each chunk draws with key, sub = split(key)
    subs, k = [], key
    for _ in range(2):
        k, sub = jax.random.split(k)
        subs.append(sub)
    rows = xy.shape[0] * xy.shape[2]
    got = tsampler.make_rollout(tc)(
        from_jax(jax_params), *map(_t, (obs_xy, obs_mask, ids)),
        num_chunks=2, eps=[_t(_eps(tc, s, rows)) for s in subs])
    assert tuple(got.shape) == ref.shape == (2, tc.max_num_obj,
                                             to + 2 * tc.pred_len, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=SAMPLE_ATOL)


def test_dump_trajectories_matches_jax(jax_params, tree, monkeypatch,
                                       tmp_path):
    """The same .npz: keys, shapes, dtypes (float32 for every float
    array) and values, over two batches of the toy tree."""
    jc, tc, jl, tl = _loaders(tree, monkeypatch, tmp_path)
    n_j = jsampler.dump_trajectories(jax_params, jc, jl,
                                     str(tmp_path / "j.npz"), num_batches=2)
    eps = [_eps(tc, k, rows) for k, rows in zip(
        _key_chain(jc.seed + 2, 2), _batch_rows(tl))]
    n_t = tsampler.dump_trajectories(from_jax(jax_params), tc, tl,
                                     str(tmp_path / "t.npz"), num_batches=2,
                                     eps=eps)
    assert n_t == n_j == 2 * tc.batch_size
    ref, got = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert list(got.files) == list(ref.files)
    for name in ref.files:
        r, g = ref[name], got[name]
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if g.dtype.kind == "f":
            assert g.dtype == np.float32, name
        np.testing.assert_allclose(g, r, rtol=0, atol=SAMPLE_ATOL,
                                   err_msg=name)


def _fit_both(jax_params, tc, jc, jl, tl, **kw):
    ref = jsampler.fit_sigma_temperature(jax_params, jc, jl, **kw)
    eps = [_eps(tc, k, rows) for k, rows in zip(
        _key_chain(jc.seed + 3, tl.num_batches), _batch_rows(tl))]
    got = tsampler.fit_sigma_temperature(from_jax(jax_params), tc, tl,
                                         eps=eps, **kw)
    return got, ref


def _assert_fit_close(got, ref):
    (tau_t, diag_t), (tau_j, diag_j) = got, ref
    np.testing.assert_allclose(tau_t, tau_j, rtol=1e-5, atol=0)
    assert diag_t["temps"] == diag_j["temps"]
    for k in ("coverage_50", "coverage_90", "fit_weight"):
        np.testing.assert_allclose(diag_t[k], diag_j[k], rtol=0, atol=1e-6,
                                   err_msg=k)


# the toy model's random heads spread far wider than its errors (coverage
# 0.92 at tau = 1e-3): the fits run on grids of small temperatures, where
# its coverage@50 runs from a floor near 0.6 (not monotone there) to 0.92
_SMALL_TEMPS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3)
_SMALL_PAIRS = tuple((tc, tt, w) for tc in (1e-5, 1e-4, 1e-3)
                     for tt in (3e-5, 3e-4, 3e-3) for w in (0.35, 0.65))


def test_fit_sigma_temperature_scalar_matches_jax(jax_params, tree,
                                                  monkeypatch, tmp_path):
    """The scalar fit at a target inside the grid's coverage, so the root
    is interpolated after the running max; the default grid is the JAX
    package's."""
    assert tsampler._FIT_TEMPS == jsampler._FIT_TEMPS
    jc, tc, jl, tl = _loaders(tree, monkeypatch, tmp_path)
    got, ref = _fit_both(jax_params, tc, jc, jl, tl, temps=_SMALL_TEMPS,
                         target=0.75)
    assert _SMALL_TEMPS[0] < ref[0] < _SMALL_TEMPS[-1]
    assert ref[0] not in _SMALL_TEMPS            # interpolated
    _assert_fit_close(got, ref)


def test_fit_sigma_temperature_two_param_matches_jax(jax_params, tree,
                                                     monkeypatch, tmp_path):
    """The two-parameter fit picks the same grid point; the default grid
    is the JAX package's."""
    assert tsampler._FIT_PAIRS == jsampler._FIT_PAIRS
    jc, tc, jl, tl = _loaders(tree, monkeypatch, tmp_path)
    got, ref = _fit_both(jax_params, tc, jc, jl, tl, temps=_SMALL_PAIRS,
                         two_param=True)
    assert got[0] == ref[0] and isinstance(got[0], tuple)
    assert len(set(np.round(ref[1]["coverage_50"], 6))) > 3
    _assert_fit_close(got, ref)
