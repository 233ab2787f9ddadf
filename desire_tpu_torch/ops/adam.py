"""The optimizer step over a whole parameter tree: the gradients' global
norm, the clip by it and Adam, as two CUDA kernels, and their plain
PyTorch version (``train/state.py`` calls them).

On CUDA leaves ``global_norm`` is ``csrc/adam.cu grad_sumsq_kernel`` (one
launch, the norm a 0-d tensor on the card) and ``clip_adam`` is
``clip_adam_kernel`` (one launch), with the leaves' pointers and sizes
passed by value: no copy to the card and no wait for it. The new params
and moments are views of three fresh flat buffers; the inputs are left as
they were. CPU leaves take the plain version, leaf by leaf. There is no
fallback from one to the other: CUDA leaves that are not float32,
contiguous and on one device raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from desire_tpu_torch.ops import _build

B1, B2, EPS = 0.9, 0.999, 1e-8

_F32 = torch.float32
# one uint32 a (device, stream): the last block of each grad_sumsq launch
# on that stream finds itself by it, and leaves it zero
_TICKETS: dict = {}


def global_norm_plain(leaves):
    """sqrt of the sum over leaves of each leaf's sum of squares."""
    total = None
    for g in leaves:
        s = (g.float() * g.float()).sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_adam_plain(params, grads, mu, nu, g_norm, max_norm, lr, bc1, bc2):
    """Leaf by leaf: clip by g_norm (kept where g_norm < max_norm, else
    scaled to max_norm; a NaN norm fails the test), Adam's moments, the
    bias-corrected update times -lr. lr, bc1, bc2: float32 0-d tensors.
    Returns the lists (params, mu, nu)."""
    keep = g_norm < max_norm
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(params, grads, mu, nu):
        g = g.float()
        g = torch.where(keep, g, (g / g_norm) * max_norm)
        m = (1.0 - B1) * g + B1 * m
        v = (1.0 - B2) * (g * g) + B2 * v
        m_hat = m / bc1.to(m.device)
        v_hat = v / bc2.to(v.device)
        u = m_hat / (torch.sqrt(v_hat) + EPS)
        new_p.append(p + u * (-lr).to(p.device))
        new_m.append(m)
        new_v.append(v)
    return new_p, new_m, new_v


def _table(trees):
    """Check the CUDA leaves of each tree (lists in the same order) and
    return (device, n, sizes as int64, [pointer arrays as uint64])."""
    first = trees[0]
    dev = first[0].device
    index = first[0].get_device()
    sizes = [x.numel() for x in first]
    ptrs = []
    for leaves in trees:
        if (len(leaves) != len(sizes)
                or [x.numel() for x in leaves] != sizes
                or not all(x.dtype == _F32 and x.is_contiguous()
                           and x.get_device() == index for x in leaves)):
            got = [(x.dtype, tuple(x.shape), str(x.device),
                    x.is_contiguous()) for x in leaves]
            raise ValueError(f"the optimizer kernels take trees of "
                             f"contiguous float32 leaves of the same sizes "
                             f"on one device, not (dtype, shape, device, "
                             f"contiguous) {got}")
        ptrs.append(np.array([x.data_ptr() for x in leaves], np.uint64))
    return dev, len(sizes), np.array(sizes, np.int64), ptrs


def _layout(lib, n, sizes):
    """(each leaf's start in the flat buffers, their size, the blocks of a
    launch)."""
    start = np.empty(n + 1, np.int64)
    blocks = lib.adam_layout(n, sizes.ctypes.data, start.ctypes.data)
    if blocks < 0:
        raise ValueError(f"{n} leaves: the optimizer kernels' leaf table "
                         f"(csrc/adam.cu kMaxLeaves) takes 1 to 256")
    return start.tolist(), int(start[n]), int(blocks)


def flat_layout(leaves):
    """Where ``clip_adam_cuda`` puts each of a tree's leaves in its flat
    buffers: (each leaf's start, the buffers' size)."""
    sizes = np.array([x.numel() for x in leaves], np.int64)
    start, total, _ = _layout(_build.library(), len(leaves), sizes)
    return start[:-1], total


def flat_source(leaves, starts, total):
    """The flat buffer of which ``leaves`` are ``clip_adam_cuda``'s views,
    at ``starts`` of ``total`` values (``flat_layout``), or None where
    they are not."""
    base = leaves[0]._base
    if base is None or base.numel() != total or base.dtype != _F32:
        return None
    for x, s in zip(leaves, starts):
        if x._base is not base or x.storage_offset() != s:
            return None
    return base


def global_norm_cuda(leaves):
    """Launch ``grad_sumsq_kernel`` over contiguous float32 CUDA leaves.
    Returns the norm, a 0-d float32 tensor on their device."""
    lib = _build.library()
    dev, n, sizes, (g,) = _table([leaves])
    _, _, blocks = _layout(lib, n, sizes)
    stream = torch.cuda.current_stream(dev)
    key = (dev.index, stream.cuda_stream)
    ticket = _TICKETS.get(key)
    if ticket is None:
        ticket = _TICKETS[key] = torch.zeros((), dtype=torch.int32,
                                             device=dev)
    partials = torch.empty(blocks, dtype=_F32, device=dev)
    norm = torch.empty((), dtype=_F32, device=dev)
    rc = lib.grad_sumsq_launch(n, sizes.ctypes.data, g.ctypes.data,
                               partials.data_ptr(), ticket.data_ptr(),
                               norm.data_ptr(),
                               ctypes.c_void_p(stream.cuda_stream))
    if rc != 0:
        raise RuntimeError(f"grad_sumsq kernel launch failed: CUDA error {rc}")
    _build.LAUNCHES["grad_sumsq"] += 1
    return norm


def clip_adam_cuda(params, grads, mu, nu, g_norm, max_norm, lr, bc1, bc2):
    """Launch ``clip_adam_kernel``: clip_adam_plain's update of contiguous
    float32 CUDA leaves, g_norm the 0-d norm on their device. Returns the
    lists (params, mu, nu), views of three fresh flat buffers."""
    lib = _build.library()
    dev, n, sizes, (p, g, m, v) = _table([params, grads, mu, nu])
    _build.check(g_norm, "g_norm", (), _F32, dev)
    start, total, _ = _layout(lib, n, sizes)
    outs = [torch.empty(total, dtype=_F32, device=dev) for _ in range(3)]
    rc = lib.clip_adam_launch(
        n, sizes.ctypes.data, g.ctypes.data, p.ctypes.data, m.ctypes.data,
        v.ctypes.data, g_norm.data_ptr(), *(o.data_ptr() for o in outs),
        float(max_norm), float(lr), float(bc1), float(bc2),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"clip_adam kernel launch failed: CUDA error {rc}")
    _build.LAUNCHES["clip_adam"] += 1
    geometry = [(x.shape, x.stride(), s) for x, s in zip(params, start)]
    return tuple([o.as_strided(*g) for g in geometry] for o in outs)


def global_norm(leaves):
    """The gradients' global norm on the leaves' device, a 0-d tensor."""
    if leaves[0].is_cuda:
        return global_norm_cuda(leaves)
    if leaves[0].device.type == "cpu":
        return global_norm_plain(leaves)
    raise ValueError(f"no optimizer kernel for device {leaves[0].device}")


def clip_adam(params, grads, mu, nu, g_norm, max_norm, lr, bc1, bc2):
    """The clip and Adam update of every leaf on the leaves' device:
    ``clip_adam_cuda`` on CUDA leaves, ``clip_adam_plain`` on the CPU.
    lr, bc1, bc2: float32 0-d CPU tensors (the kernel takes their values,
    which float() gives exactly). Returns the lists (params, mu, nu)."""
    if params[0].is_cuda:
        return clip_adam_cuda(params, grads, mu, nu, g_norm, max_norm, lr,
                              bc1, bc2)
    if params[0].device.type == "cpu":
        return clip_adam_plain(params, grads, mu, nu, g_norm, max_norm, lr,
                               bc1, bc2)
    raise ValueError(f"no optimizer kernel for device {params[0].device}")
