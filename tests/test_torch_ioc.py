"""Port parity of IOC rank-and-refine: the fused kernel's plain version
against the JAX Pallas kernel's inference variant (in-kernel messages,
interpret mode) and against the JAX ioc_forward, and the port's ioc_forward
against the JAX one (f32). The CUDA kernel is held against the plain
version in tests/test_torch_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desire_tpu.config import DesireConfig
from desire_tpu.models import ioc as jioc
from desire_tpu.models import scf as jscf
from desire_tpu.ops.ioc_fused import ioc_refine_fused
from desire_tpu_torch.models import ioc as tioc
from desire_tpu_torch.models import scf as tscf
from desire_tpu_torch.ops import ioc_fused as tops
from desire_tpu_torch.params import from_jax, to_numpy

# the JAX kernel suite's f32 tolerances (tests/test_kernels.py)
TRAJ_TOL = dict(rtol=2e-4, atol=2e-5)
SCORE_TOL = dict(rtol=2e-4, atol=2e-4)
CASES = [("mixed", False), ("mixed", True), ("single", False),
         ("single", True)]


def _env(live_mode, social_freeze, b=2, a=5, k=3, t=6, d=16, g=8, c=8):
    """tests/test_kernels.py _ioc_env, from numpy. live_mode 'single'
    leaves one live agent per batch row, whose social block is zero."""
    cfg = DesireConfig(d_dim=d, scene_grid=g, scene_channels=c,
                       num_refine=2, compute_dtype="float32",
                       max_num_obj=a, num_samples=k, pred_len=t,
                       social_freeze=social_freeze)
    # params drawn by the port's init, whose tree is the JAX init's
    # (tests/test_torch_params.py), which is much quicker on the CPU than
    # JAX's op-by-op init
    gen = torch.Generator().manual_seed(0)
    p_ioc = to_numpy(tioc.init_ioc(gen, cfg, "cpu"))
    p_scf = to_numpy(tscf.init_scf(gen, cfg, "cpu"))
    rng = np.random.default_rng(0)
    # break the zero-init of delta/gate so refinement actually moves
    p_ioc["delta"]["w"] = 0.3 * rng.standard_normal((d, 2))
    p_ioc["gate"]["w"] = 0.3 * rng.standard_normal((d, 1))
    p_ioc, p_scf = (jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float32), t) for t in (p_ioc, p_scf))
    f = lambda x: np.asarray(x, np.float32)
    traj = f(rng.uniform(0.2, 0.8, (b, a, k, t, 2)))
    dec_h = f(rng.standard_normal((b, a, k, t, d)))
    feat_map = f(rng.standard_normal((b, g, g, c)))
    if live_mode == "single":
        live = np.zeros((b, a), np.float32)
    else:
        live = f(rng.random((b, a)) > 0.3)
    live[:, 0] = 1.0
    fut_mask = np.ones((b, a, t), np.float32)
    fut_mask[:, :, -1] = 0.0
    return cfg, p_ioc, p_scf, (traj, dec_h, feat_map, live, fut_mask)


def _plain(cfg, p_ioc, p_scf, arrays):
    return tops.ioc_refine_plain(
        from_jax(p_ioc), from_jax(p_scf), *map(torch.from_numpy, arrays),
        num_refine=cfg.num_refine, delta_scale=tioc._DELTA_SCALE,
        social_freeze=cfg.social_freeze)


def _check(got, ref):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               **TRAJ_TOL)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]),
                               **SCORE_TOL)


@pytest.mark.parametrize("live_mode,social_freeze", CASES)
def test_ioc_plain_matches_pallas_interpret(live_mode, social_freeze):
    cfg, p_ioc, p_scf, arrays = _env(live_mode, social_freeze)
    ref = ioc_refine_fused(p_ioc, p_scf, *map(jnp.asarray, arrays[:2]),
                           None, *map(jnp.asarray, arrays[2:]),
                           num_refine=cfg.num_refine,
                           delta_scale=jioc._DELTA_SCALE, interpret=True,
                           social_freeze=social_freeze)
    _check(_plain(cfg, p_ioc, p_scf, arrays), ref)


@functools.cache
def _ioc_forward_ref(live_mode, social_freeze):
    """The JAX ioc_forward on one case, shared by the two tests below. It is
    jitted: one compile costs less on the CPU than its op-by-op first run."""
    cfg, p_ioc, p_scf, arrays = _env(live_mode, social_freeze)
    return jax.jit(lambda *a: jioc.ioc_forward(p_ioc, p_scf, cfg, *a))(
        *map(jnp.asarray, arrays))


@pytest.mark.parametrize("live_mode,social_freeze", CASES)
def test_ioc_plain_matches_jax_ioc_forward(live_mode, social_freeze):
    cfg, p_ioc, p_scf, arrays = _env(live_mode, social_freeze)
    _check(_plain(cfg, p_ioc, p_scf, arrays),
           _ioc_forward_ref(live_mode, social_freeze))


@pytest.mark.parametrize("live_mode,social_freeze", CASES)
def test_ioc_forward_matches_jax(live_mode, social_freeze):
    cfg, p_ioc, p_scf, arrays = _env(live_mode, social_freeze)
    ref = _ioc_forward_ref(live_mode, social_freeze)
    got = tioc.ioc_forward(from_jax(p_ioc), from_jax(p_scf), cfg,
                           *map(torch.from_numpy, arrays))
    _check(got, ref)
    assert len(got[2]) == len(ref[2]) == cfg.num_refine
    for g_it, r_it in zip(got[2], ref[2]):
        np.testing.assert_allclose(g_it.numpy(), np.asarray(r_it),
                                   **TRAJ_TOL)


def test_social_pool_lone_agent_is_zero():
    cfg, _, p_scf, (traj, dec_h, _, live, _) = _env("single", False)
    msg = tscf.social_messages(from_jax(p_scf), torch.from_numpy(dec_h))
    out = tscf.social_pool(from_jax(p_scf), torch.from_numpy(traj), msg,
                           torch.from_numpy(live))
    ref = jscf.social_pool(p_scf, jnp.asarray(traj), jnp.asarray(msg.numpy()),
                           jnp.asarray(live))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TRAJ_TOL)
    assert float(out[:, 0].abs().max()) == 0.0
