"""Bilinear pooling of the scene feature map: CUDA kernels and their plain
PyTorch version (port of ``desire_tpu/ops/scene_pool.py``).

feat_map (B, G, G, C) and positions pos (B, P, 2) -> (B, P, C): the map
sampled bilinearly (align corners) at the positions clamped to [0, 1].
Both follow the TPU kernel's numerics: the four corner weights (and, in
the gradient, the derivative weights) rounded to the map's dtype, the
cotangent rounded to the map's dtype, float32 sums, outputs in the map's
dtype (d_pos in float32). d_pos is zero outside [0, 1] and kept at both
ends.

On CUDA tensors the forward is ``csrc/scene_pool.cu
scene_pool_fwd_vec_kernel`` (16-byte pieces of a row per thread) or, for
other channel counts, ``scene_pool_fwd_kernel``, and the gradient a stable
bucketing of the points by cell (``scene_pool_bucket_kernel``), per-segment
sums of each bucket (``scene_pool_seg_kernel``, which also computes d_pos
where a row is a power of two of 16-byte pieces; else
``scene_pool_dpos_kernel``) and one owner per d_map output adding them
(``scene_pool_dmap_kernel``); all of it deterministic, with no float
atomics. On CPU tensors the plain versions run.
``models/scf.py`` keeps the layer-by-layer semantics of the JAX package's
XLA path (weights not rounded) for ``cfg.use_pallas=False``.
"""

from __future__ import annotations

import ctypes

import torch

from desire_tpu_torch.ops import _build

_F32 = torch.float32


def corners(pos, g):
    """Align-corners bilinear corners of positions (..., 2) clamped to
    [0, 1] on the G x G grid: flat node indices and float32 weights, each
    in the order (x0,y0) (x1,y0) (x0,y1) (x1,y1), and the fractional parts
    fx, fy. A NaN coordinate clamps to 0, as fmaxf / fminf clamp it in
    the kernels (an index from NaN would be out of range)."""
    xy = torch.clamp(torch.nan_to_num(pos.float(), nan=0.0), 0.0, 1.0) \
        * (g - 1)
    x0f, y0f = torch.floor(xy[..., 0]), torch.floor(xy[..., 1])
    fx, fy = xy[..., 0] - x0f, xy[..., 1] - y0f
    x0, y0 = x0f.long(), y0f.long()
    x1 = torch.clamp(x0 + 1, max=g - 1)
    y1 = torch.clamp(y0 + 1, max=g - 1)
    idx = (y0 * g + x0, y0 * g + x1, y1 * g + x0, y1 * g + x1)
    w = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
    return idx, w, fx, fy


def _gather(flat, idx):
    """flat (B, G*G, C) float32 rows at idx (B, P) -> (B, P, C)."""
    return torch.take_along_dim(flat, idx[..., None], dim=1)


def bilinear_pool_plain(feat_map, pos):
    """Plain version of the forward: (B, G, G, C), (B, P, 2) -> (B, P, C) in
    the map's dtype."""
    b, g, _, c = feat_map.shape
    cd = feat_map.dtype
    flat = feat_map.reshape(b, g * g, c).float()
    idx, w, _, _ = corners(pos, g)
    out = 0.0
    for ii, ww in zip(idx, w):
        out = out + ww.to(cd).float()[..., None] * _gather(flat, ii)
    return out.to(cd)


def bilinear_pool_plain_bwd(feat_map, pos, g):
    """Plain version of the gradient for the cotangent g (B, P, C): (d_map
    (B, G, G, C) in the map's dtype, d_pos (B, P, 2) float32)."""
    b, gr, _, c = feat_map.shape
    cd = feat_map.dtype
    flat = feat_map.reshape(b, gr * gr, c).float()
    gg = g.to(cd).float()
    idx, w, fx, fy = corners(pos, gr)
    r = lambda x: x.to(cd).float()[..., None]
    d_map = torch.zeros((b, gr * gr, c), dtype=_F32, device=feat_map.device)
    for ii, ww in zip(idx, w):
        d_map.scatter_add_(1, ii[..., None].expand(-1, -1, c), r(ww) * gg)
    f = [_gather(flat, ii) for ii in idx]
    dfx = ((r(1 - fy) * (f[1] - f[0]) + r(fy) * (f[3] - f[2])) * gg).sum(-1)
    dfy = ((r(1 - fx) * (f[2] - f[0]) + r(fx) * (f[3] - f[1])) * gg).sum(-1)
    p = pos.float()
    in01 = ((p >= 0.0) & (p <= 1.0)).to(_F32)
    d_pos = torch.stack([dfx, dfy], dim=-1) * (gr - 1) * in01
    return d_map.reshape(b, gr, gr, c).to(cd), d_pos


def _shapes(feat_map, pos):
    b, g, _, c = feat_map.shape
    p = pos.shape[1]
    if feat_map.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"feat_map dtype must be float32 or bfloat16: "
                         f"{feat_map.dtype}")
    dev = feat_map.device
    _build.check(feat_map, "feat_map", (b, g, g, c), feat_map.dtype, dev)
    _build.check(pos, "pos", (b, p, 2), _F32, dev)
    return b, p, g, c


def fwd_vector_width(c, dtype, map_ptr, pos_ptr, out_ptr):
    """Which forward kernel takes a map of C channels of this dtype at these
    addresses: the channels a thread moves as one 16-byte piece (8 in
    bfloat16, 4 in float32) for the vector path, which needs rows of whole
    pieces, the map and the result 16-byte aligned and the positions 8-byte
    aligned; else 0, the channel loop (one warp per point)."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if (c % vec == 0 and map_ptr % 16 == 0 and out_ptr % 16 == 0
            and pos_ptr % 8 == 0):
        return vec
    return 0


def scene_pool_fwd_cuda(feat_map, pos):
    """Launch the forward kernel on contiguous CUDA tensors: feat_map
    (B, G, G, C) float32 or bfloat16, pos (B, P, 2) float32. Returns
    (B, P, C) in the map's dtype. ``scene_pool_fwd_vec_kernel`` where
    :func:`fwd_vector_width` allows it, else ``scene_pool_fwd_kernel``; both
    give the same bits."""
    if not feat_map.is_cuda:
        raise ValueError("scene_pool_fwd_cuda needs CUDA tensors")
    b, p, g, c = _shapes(feat_map, pos)
    out = torch.empty((b, p, c), dtype=feat_map.dtype, device=feat_map.device)
    vec = fwd_vector_width(c, feat_map.dtype, feat_map.data_ptr(),
                           pos.data_ptr(), out.data_ptr())
    rc = _build.library().scene_pool_fwd_launch(
        int(feat_map.dtype == torch.bfloat16), feat_map.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, p, g, c, vec,
        ctypes.c_void_p(torch.cuda.current_stream(
            feat_map.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"scene_pool_fwd kernel launch failed: CUDA error "
                           f"{rc}")
    _build.LAUNCHES["scene_pool_fwd"] += 1
    return out


def scene_pool_bwd_cuda(feat_map, pos, g):
    """Launch the gradient kernels (the bucketing, d_map's two levels and
    d_pos) for the cotangent g (B, P, C) in the map's dtype, with a
    workspace of ``scene_pool_bwd_ws_bytes``. Returns (d_map (B, G, G, C) in
    the map's dtype, d_pos (B, P, 2) float32), both bitwise reproducible.
    Raises where the kernels cannot launch (G^2 cells' histogram beyond a
    block's shared memory, or B > 65535)."""
    if not feat_map.is_cuda:
        raise ValueError("scene_pool_bwd_cuda needs CUDA tensors")
    b, p, gr, c = _shapes(feat_map, pos)
    _build.check(g, "g", (b, p, c), feat_map.dtype, feat_map.device)
    lib = _build.library()
    d_map = torch.empty_like(feat_map)
    d_pos = torch.empty((b, p, 2), dtype=_F32, device=feat_map.device)
    ws = torch.empty(lib.scene_pool_bwd_ws_bytes(b, p, gr, c),
                     dtype=torch.uint8, device=feat_map.device)
    rc = lib.scene_pool_bwd_launch(
        int(feat_map.dtype == torch.bfloat16), feat_map.data_ptr(),
        pos.data_ptr(), g.data_ptr(), d_map.data_ptr(), d_pos.data_ptr(),
        ws.data_ptr(), b, p, gr, c, ctypes.c_void_p(
            torch.cuda.current_stream(feat_map.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"scene_pool_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    _build.LAUNCHES["scene_pool_bwd"] += 1
    return d_map, d_pos


class _ScenePool(torch.autograd.Function):
    """The kernels on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, feat_map, pos):
        ctx.save_for_backward(feat_map, pos)
        if feat_map.is_cuda:
            return scene_pool_fwd_cuda(feat_map, pos)
        return bilinear_pool_plain(feat_map, pos)

    @staticmethod
    def backward(ctx, g):
        feat_map, pos = ctx.saved_tensors
        bwd = (scene_pool_bwd_cuda if feat_map.is_cuda
               else bilinear_pool_plain_bwd)
        return bwd(feat_map, pos, g.to(feat_map.dtype).contiguous())


def bilinear_pool(feat_map, pos):
    """Sample feat_map (B, G, G, C) bilinearly at pos (B, P, 2) on the
    tensors' device: the CUDA kernels for CUDA tensors, the plain versions
    for CPU tensors. Differentiable in both; returns (B, P, C) in the map's
    dtype."""
    if feat_map.is_cuda or feat_map.device.type == "cpu":
        return _ScenePool.apply(feat_map.contiguous(),
                                pos.float().contiguous())
    raise ValueError(f"no scene-pool kernel for device {feat_map.device}")
