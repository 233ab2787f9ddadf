"""The optimizer step over a whole parameter tree: the gradients' global
norm, the clip by it and Adam, as two CUDA kernels, and their plain
PyTorch version (``train/state.py`` calls them).

On the card the optimizer's state is a ``Flat``: the params', mu's and
nu's flat buffers in the tree's ``FlatLayout``, which asks
``csrc/adam.cu adam_layout`` once a tree shape where each leaf starts.
``global_norm`` of CUDA leaves is ``grad_sumsq_kernel`` (one launch, the
norm a 0-d tensor on the card) and ``clip_adam`` is ``clip_adam_kernel``
(one launch), with the leaves' pointers and sizes passed by value: no copy
to the card and no wait for it. The update writes three fresh flat
buffers and leaves its inputs as they were. Every launch checks the
gradients, which arrive from autograd: CUDA leaves that are not float32,
contiguous, of the layout's shapes and on the state's device raise, with
no fallback to the plain version. CPU leaves take the plain version, leaf
by leaf.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

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


class FlatLayout:
    """Where the optimizer kernels keep the leaves of a tree of ``shapes``
    (``tree_leaves`` order) in one flat float32 buffer: each leaf at its
    start, its size rounded up to 4 values so that every leaf is 16-byte
    aligned (``csrc/adam.cu adam_layout``), and the blocks of a launch.
    Made once a tree shape (``layout``)."""

    def __init__(self, shapes):
        self.shapes = tuple(tuple(s) for s in shapes)
        n = len(self.shapes)
        self.sizes = np.array([math.prod(s) for s in self.shapes], np.int64)
        start = np.empty(n + 1, np.int64)
        blocks = _build.library().adam_layout(n, self.sizes.ctypes.data,
                                              start.ctypes.data)
        if blocks < 0:
            raise ValueError(f"{n} leaves: the optimizer kernels' leaf "
                             f"table (csrc/adam.cu kMaxLeaves) takes 1 to "
                             f"256")
        self.starts = start[:-1].tolist()
        self.total = int(start[n])
        self.blocks = int(blocks)
        self._bytes = (start[:-1] * 4).astype(np.uint64)
        self._geometry = [(s, torch.empty(s, device="meta").stride(), o)
                          for s, o in zip(self.shapes, self.starts)]

    def views(self, flat):
        """The leaves of the flat buffer ``flat``, views at their starts."""
        base = flat.storage_offset()
        return [flat.as_strided(s, st, base + o)
                for s, st, o in self._geometry]

    def pack(self, leaves):
        """A fresh buffer on the leaves' device holding float32 ``leaves``
        of this layout's shapes (the padding zero)."""
        if (tuple(tuple(x.shape) for x in leaves) != self.shapes
                or any(x.dtype != _F32 for x in leaves)):
            raise ValueError(f"the optimizer's flat buffers take float32 "
                             f"leaves of shapes {self.shapes}, not "
                             f"{[(x.dtype, tuple(x.shape)) for x in leaves]}")
        flat = torch.zeros(self.total, dtype=_F32, device=leaves[0].device)
        for dst, x in zip(self.views(flat), leaves):
            dst.copy_(x)
        return flat

    def pointers(self, flat):
        """The leaves' addresses in the flat buffer ``flat``, as uint64."""
        return self._bytes + np.uint64(flat.data_ptr())


@functools.cache
def layout(shapes) -> FlatLayout:
    """The flat layout of a tree of leaves of ``shapes``."""
    return FlatLayout(shapes)


class Flat(NamedTuple):
    """The optimizer's state on the card: the params', mu's and nu's flat
    buffers in ``layout``."""
    layout: FlatLayout
    params: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


def _grads(leaves, lay, dev):
    """The gradients' addresses, as uint64, after checking that they are
    contiguous float32 leaves of the layout's shapes on ``dev``."""
    if (len(leaves) != len(lay.shapes)
            or not all(x.dtype == _F32 and x.is_contiguous()
                       and x.device == dev and tuple(x.shape) == s
                       for x, s in zip(leaves, lay.shapes))):
        got = [(x.dtype, tuple(x.shape), str(x.device), x.is_contiguous())
               for x in leaves]
        raise ValueError(f"the optimizer kernels take gradients that are "
                         f"contiguous float32 leaves of the params' shapes "
                         f"on {dev}, not (dtype, shape, device, contiguous) "
                         f"{got}")
    return np.array([x.data_ptr() for x in leaves], np.uint64)


def global_norm_cuda(leaves):
    """Launch ``grad_sumsq_kernel`` over contiguous float32 CUDA leaves.
    Returns the norm, a 0-d float32 tensor on their device."""
    lib = _build.library()
    dev = leaves[0].device
    lay = layout(tuple(x.shape for x in leaves))
    g = _grads(leaves, lay, dev)
    stream = torch.cuda.current_stream(dev)
    key = (dev.index, stream.cuda_stream)
    ticket = _TICKETS.get(key)
    if ticket is None:
        ticket = _TICKETS[key] = torch.zeros((), dtype=torch.int32,
                                             device=dev)
    partials = torch.empty(lay.blocks, dtype=_F32, device=dev)
    norm = torch.empty((), dtype=_F32, device=dev)
    rc = lib.grad_sumsq_launch(len(leaves), lay.sizes.ctypes.data,
                               g.ctypes.data, partials.data_ptr(),
                               ticket.data_ptr(), norm.data_ptr(),
                               ctypes.c_void_p(stream.cuda_stream))
    if rc != 0:
        raise RuntimeError(f"grad_sumsq kernel launch failed: CUDA error {rc}")
    _build.LAUNCHES["grad_sumsq"] += 1
    return norm


def clip_adam(flat, grads, g_norm, max_norm, lr, bc1, bc2):
    """Launch ``clip_adam_kernel``: clip_adam_plain's update of the state
    ``flat`` (a ``Flat``) by the gradients ``grads``, contiguous float32
    leaves on its device, g_norm their 0-d norm there. lr, bc1, bc2:
    float32 0-d CPU tensors (the kernel takes their values, which float()
    gives exactly). Returns a ``Flat`` of three fresh buffers; ``flat`` is
    left as it was."""
    lib = _build.library()
    lay = flat.layout
    dev = flat.params.device
    g = _grads(grads, lay, dev)
    p, m, v = (lay.pointers(x) for x in (flat.params, flat.mu, flat.nu))
    _build.check(g_norm, "g_norm", (), _F32, dev)
    outs = [torch.empty(lay.total, dtype=_F32, device=dev) for _ in range(3)]
    rc = lib.clip_adam_launch(
        len(grads), lay.sizes.ctypes.data, g.ctypes.data, p.ctypes.data,
        m.ctypes.data, v.ctypes.data, g_norm.data_ptr(),
        *(o.data_ptr() for o in outs), float(max_norm), float(lr), float(bc1), float(bc2),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"clip_adam kernel launch failed: CUDA error {rc}")
    _build.LAUNCHES["clip_adam"] += 1
    return Flat(lay, *outs)


def global_norm(leaves):
    """The gradients' global norm on the leaves' device, a 0-d tensor."""
    if leaves[0].is_cuda:
        return global_norm_cuda(leaves)
    if leaves[0].device.type == "cpu":
        return global_norm_plain(leaves)
    raise ValueError(f"no optimizer kernel for device {leaves[0].device}")
