"""Port parity of the scene-pool op (``desire_tpu_torch.ops.bilinear_pool``,
its plain versions on the CPU) against the JAX package's Pallas kernel
``bilinear_pool_pallas`` in interpret mode, as tests/test_kernels.py runs
it: forward in float32 and bfloat16, the gradients of the map and the
positions in float32, on inputs made with numpy from a fixed seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desire_tpu.ops.scene_pool import bilinear_pool_pallas
from desire_tpu_torch import ops
from desire_tpu_torch.ops import scene_pool

# float32: the same products, summed in another order
F32_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# bfloat16: a sum taken in another order can round to the neighbouring
# bf16 value, one step of 2^-8 relative
BF16_TOL = dict(rtol=2.0 ** -8, atol=1e-3)


def _inputs(b, g, c, p, seed, edges=False):
    """Map and positions; with edges, positions outside [0, 1], exactly on
    grid nodes and exactly on the borders are mixed in."""
    rng = np.random.default_rng(seed)
    fm = rng.standard_normal((b, g, g, c)).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (b, p, 2)).astype(np.float32)
    if edges:
        q = p // 4
        nodes = rng.integers(0, g, (b, q, 2)) / np.float32(g - 1)
        pos[:, :q] = nodes.astype(np.float32)
        pos[:, q:2 * q] = rng.uniform(-0.5, 1.5, (b, q, 2))
        pos[:, -6:] = np.array([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0],
                                [1.0, 0.3], [0.7, 0.0], [1.0, 0.0]],
                               np.float32)
    return fm, pos


@pytest.mark.parametrize("b,g,c,p,edges", [
    (2, 8, 8, 700, False),         # P not a multiple of the TPU tile (512)
    (2, 8, 32, 64, True),          # out of range, on nodes, on the borders
    (1, 16, 4, 100, True)])
def test_forward_f32_matches_pallas(b, g, c, p, edges):
    fm, pos = _inputs(b, g, c, p, seed=p, edges=edges)
    ref = bilinear_pool_pallas(jnp.asarray(fm), jnp.asarray(pos), True)
    got = ops.bilinear_pool(torch.from_numpy(fm), torch.from_numpy(pos))
    assert got.shape == (b, p, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("edges", [False, True])
def test_forward_bf16_matches_pallas(edges):
    """Corner weights rounded to bf16 as the TPU kernel's 4-hot matrix holds
    them, float32 sums, a bf16 result."""
    fm, pos = _inputs(2, 8, 16, 700, seed=3, edges=edges)
    ref = bilinear_pool_pallas(jnp.asarray(fm, jnp.bfloat16),
                               jnp.asarray(pos), True)
    got = ops.bilinear_pool(torch.from_numpy(fm).to(torch.bfloat16),
                            torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **BF16_TOL)


@pytest.mark.parametrize("edges", [False, True])
def test_gradients_match_pallas_vjp(edges):
    """d_map and d_pos through torch.autograd against jax.vjp of the Pallas
    kernel's custom VJP: positions outside [0, 1] get no gradient, the
    borders keep theirs."""
    b, g, c, p = 2, 8, 8, 700
    fm, pos = _inputs(b, g, c, p, seed=11, edges=edges)
    ct = np.random.default_rng(12).standard_normal((b, p, c)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda f, x: bilinear_pool_pallas(f, x, True),
                     jnp.asarray(fm), jnp.asarray(pos))
    r_map, r_pos = vjp(jnp.asarray(ct))
    t_fm = torch.from_numpy(fm).requires_grad_(True)
    t_pos = torch.from_numpy(pos).requires_grad_(True)
    out = ops.bilinear_pool(t_fm, t_pos)
    d_map, d_pos = torch.autograd.grad(out, [t_fm, t_pos],
                                       torch.from_numpy(ct))
    np.testing.assert_allclose(d_map.numpy(), np.asarray(r_map), **GRAD_TOL)
    np.testing.assert_allclose(d_pos.numpy(), np.asarray(r_pos), **GRAD_TOL)
    outside = (pos < 0) | (pos > 1)
    assert np.all(d_pos.numpy()[outside] == 0.0)


def test_plain_versions_and_wrappers():
    """The plain gradient is the autograd Function's on the CPU; the CUDA
    wrappers refuse CPU tensors and count nothing."""
    fm, pos = _inputs(1, 8, 8, 50, seed=5, edges=True)
    fm, pos = torch.from_numpy(fm), torch.from_numpy(pos)
    g = torch.ones(1, 50, 8)
    d_map, d_pos = scene_pool.bilinear_pool_plain_bwd(fm, pos, g)
    # every point spreads its weights, which sum to 1, over its corners
    np.testing.assert_allclose(float(d_map.sum()), 50 * 8, rtol=1e-5)
    leaves = [fm.clone().requires_grad_(True), pos.clone().requires_grad_(True)]
    got = torch.autograd.grad(ops.bilinear_pool(*leaves), leaves, g)
    assert torch.equal(got[0], d_map) and torch.equal(got[1], d_pos)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        scene_pool.scene_pool_fwd_cuda(fm, pos)
    with pytest.raises(ValueError, match="CUDA"):
        scene_pool.scene_pool_bwd_cuda(fm, pos, g)
    assert ops.LAUNCHES["scene_pool_fwd"] == ops.LAUNCHES[
        "scene_pool_bwd"] == 0
    with pytest.raises(ValueError, match="device"):
        ops.bilinear_pool(fm.to("meta"), pos.to("meta"))


@pytest.mark.parametrize("c,dtype,ptrs,want", [
    (32, torch.bfloat16, (4096, 256, 8192), 8),    # 4 pieces a row
    (8, torch.bfloat16, (4096, 256, 8192), 8),     # one piece a row
    (24, torch.bfloat16, (4096, 256, 8192), 8),    # 3 pieces: no power of 2
    (12, torch.bfloat16, (4096, 256, 8192), 0),    # 24-byte rows
    (12, torch.float32, (4096, 256, 8192), 4),     # 48-byte rows
    (32, torch.float32, (4096, 264, 8192), 4),     # positions 8-byte aligned
    (6, torch.float32, (4096, 256, 8192), 0),
    (32, torch.bfloat16, (4104, 256, 8192), 0),    # map off a 16-byte line
    (32, torch.bfloat16, (4096, 256, 8200), 0),    # result off a 16-byte line
    (32, torch.bfloat16, (4096, 260, 8192), 0),    # positions off 8 bytes
])
def test_forward_vector_path_predicate(c, dtype, ptrs, want):
    """Which forward kernel the wrapper asks for: 16-byte pieces of a row
    (8 bf16 or 4 f32 channels a thread) only when a row is a whole number
    of pieces and the tensors are aligned for 16-byte (positions: 8-byte)
    accesses; else the channel loop."""
    assert scene_pool.fwd_vector_width(c, dtype, *ptrs) == want


def test_forward_vector_path_on_fresh_tensors():
    """Freshly allocated contiguous tensors are aligned: the flagship map
    (C = 32, bf16) takes the vector path, an odd-offset view does not."""
    fm = torch.zeros((2, 8, 8, 32), dtype=torch.bfloat16)
    pos = torch.zeros((2, 10, 2))
    out = torch.empty((2, 10, 32), dtype=torch.bfloat16)
    ptr = lambda t: t.data_ptr()
    assert scene_pool.fwd_vector_width(32, fm.dtype, ptr(fm), ptr(pos),
                                   ptr(out)) == 8
    shifted = torch.zeros(2 * 8 * 8 * 32 + 1, dtype=torch.bfloat16)[1:]
    assert scene_pool.fwd_vector_width(32, fm.dtype, ptr(shifted), ptr(pos),
                                   ptr(out)) == 0
