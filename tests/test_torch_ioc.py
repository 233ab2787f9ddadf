"""Port parity of IOC rank-and-refine: the fused kernel's plain version
against the JAX Pallas kernel's inference variant (in-kernel messages,
interpret mode) and against the JAX ioc_forward, the port's ioc_forward
against the JAX one, and the gradients of the port's trainable IOC and of
its ioc_forward against jax.grad of the JAX ioc_forward (f32). The CUDA
kernels are held against the plain versions in tests/test_torch_cuda.py."""

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
from desire_tpu_torch.ops import ioc_bwd
from desire_tpu_torch.ops import ioc_fused as tops
from desire_tpu_torch.ops import ioc_refine_train
from desire_tpu_torch.params import from_jax, to_numpy
from desire_tpu_torch.train.state import tree_leaves

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


# the JAX kernel suite's gradient tolerances (tests/test_kernels.py), f32
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _grad_loss(refined, scores, iters, wts, xp):
    """tests/test_kernels.py's IOC gradient test loss."""
    return (xp.sum(refined ** 2) + xp.sum(scores * wts) + xp.sum(iters ** 2)
            + xp.sum(xp.sin(refined)))


@functools.cache
def _ioc_grad_ref(live_mode, social_freeze):
    """jax.grad of that loss through the JAX ioc_forward, for every
    parameter leaf and the traj, dec_h and feat_map inputs (jitted once)."""
    cfg, p_ioc, p_scf, arrays = _env(live_mode, social_freeze)
    traj, dec_h, feat_map, live, fut = map(jnp.asarray, arrays)
    wts = np.random.default_rng(9).standard_normal(
        live.shape + (cfg.num_samples,)).astype(np.float32)

    def loss(p_ioc, p_scf, traj, dec_h, feat_map):
        refined, scores, per_iter = jioc.ioc_forward(
            p_ioc, p_scf, cfg, traj, dec_h, feat_map, live, fut)
        return _grad_loss(refined, scores, jnp.stack(per_iter), wts, jnp)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        p_ioc, p_scf, traj, dec_h, feat_map)
    return wts, grads


@pytest.mark.parametrize("path", ["trainable", "ioc_forward"])
@pytest.mark.parametrize("live_mode,social_freeze", CASES)
def test_ioc_gradients_match_jax(path, live_mode, social_freeze):
    """Gradients of the port's trainable IOC (ops.ioc_refine_train; its
    plain version on CPU tensors) and of its ioc_forward against jax.grad
    of the JAX ioc_forward, for every parameter and input leaf."""
    cfg, p_ioc, p_scf, arrays = _env(live_mode, social_freeze)
    wts, ref = _ioc_grad_ref(live_mode, social_freeze)
    tp_ioc, tp_scf = from_jax(p_ioc), from_jax(p_scf)
    # the leaves in JAX's flattening order, which the reference grads use
    param_leaves = tree_leaves([tp_ioc, tp_scf])
    for x in param_leaves:
        x.requires_grad_(True)
    traj, dec_h, feat_map, live, fut = (torch.from_numpy(x) for x in arrays)
    ins = [x.requires_grad_(True) for x in (traj, dec_h, feat_map)]
    if path == "trainable":
        refined, scores, iters = ioc_refine_train(
            tp_ioc, tp_scf, *ins, live, fut, num_refine=cfg.num_refine,
            delta_scale=tioc._DELTA_SCALE, social_freeze=social_freeze)
    else:
        refined, scores, per_iter = tioc.ioc_forward(
            tp_ioc, tp_scf, cfg, *ins, live, fut)
        iters = torch.stack(per_iter)
    loss = _grad_loss(refined, scores, iters, torch.from_numpy(wts), torch)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    got = torch.autograd.grad(loss, param_leaves + ins, allow_unused=True)
    assert len(got) == len(flat_ref)
    for (kp, r), g in zip(flat_ref, got):
        g = np.zeros(r.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(r), err_msg=str(kp),
                                   **GRAD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_weight_pack_layouts(dtype):
    """pack_ioc_bwd against the unpacked weights: the GRU matrices in the
    compute dtype as they are and transposed (a product's second operand is
    read row by row), contiguous; the heads in the order [score | gate | dx
    | dy]; the float32 velocity rows, biases and soc_logtau."""
    cfg, p_ioc, p_scf, _ = _env("mixed", False)
    pt, st = from_jax(p_ioc), from_jax(p_scf)
    w = ioc_bwd.pack_ioc_bwd(pt, st, dtype, torch.device("cpu"))
    assert tuple(w) == ioc_bwd._PACK_ORDER
    gp = pt["gru"][0]
    d, f = cfg.d_dim, 2 + cfg.scene_channels + 2 * cfg.d_dim
    assert w["wi"].shape == (f, 3 * d) and w["wiT"].shape == (3 * d, f)
    assert w["wh"].shape == (d, 3 * d) and w["whT"].shape == (3 * d, d)
    for name, ref in (("wi", gp["wi"]), ("wiT", gp["wi"].t()),
                      ("wh", gp["wh"]), ("whT", gp["wh"].t())):
        assert w[name].dtype == dtype and w[name].is_contiguous()
        assert torch.equal(w[name], ref.to(dtype))
    heads = torch.cat([pt["score"]["w"], pt["gate"]["w"], pt["delta"]["w"]],
                      dim=-1)
    assert torch.equal(w["heads_c"], heads.to(dtype))
    assert w["heads_w"].dtype == torch.float32
    assert torch.equal(w["heads_w"], heads)
    assert torch.equal(w["heads_b"], torch.cat(
        [pt["score"]["b"], pt["gate"]["b"], pt["delta"]["b"]]))
    assert torch.equal(w["wiv"], gp["wi"][:2]) and w["wiv"].is_contiguous()
    assert torch.equal(w["bi"], gp["bi"]) and torch.equal(w["bh"], gp["bh"])
    assert w["ltau"].shape == (1,) and w["ltau"].dtype == torch.float32
    assert not any(x.requires_grad for x in w.values())


@pytest.mark.parametrize("b,a,k,t,d,c,r,freeze", [
    (2, 5, 3, 6, 16, 8, 2, False), (2, 5, 3, 6, 16, 8, 2, True),
    (64, 60, 20, 12, 48, 32, 4, False), (64, 60, 20, 12, 48, 32, 4, True)])
@pytest.mark.parametrize("bf16", [False, True])
def test_backward_workspace_words(b, a, k, t, d, c, r, freeze, bf16):
    """The workspace the wrapper allocates, region by region as the kernel
    source lays it out, for B * K blocks; with the tensor-core variant
    (bf16, d and C multiples of 16) every reverse step's operand tiles
    besides, in bf16, half a float32 word an element."""
    regions = [t * a * 4 * d,            # gates r, z, n and the hidden n-gate
               t * a * d,                # GRU states
               t * a * c,                # scene blocks
               t * a * d,                # social blocks
               t * a * 4,                # the heads' cotangents
               (r + 1) * t * a * c]      # scene cotangents of every pass
    if freeze:
        regions += [t * a * d] * 2       # the two social-cotangent buckets
    if bf16 and c % 16 == 0:
        rows = 64 if a == 60 else 16     # agents padded to 16
        # the operand log, [X (C + 2d + 16) | h (d) | R (4d)] a row
        regions += [(r + 1) * t * rows * (c + 2 * d + 16 + d + 4 * d) // 2]
    assert ioc_bwd.bwd_workspace_words(b, a, k, t, d, c, r, freeze, bf16) \
        == b * k * sum(regions)
