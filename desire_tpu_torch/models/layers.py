"""Functional layers over explicit parameter trees (PyTorch port of
``desire_tpu/models/layers.py``).

The tree layouts are the JAX package's: dense weights are (in, out), GRU
weights are (in, 3H) with gates in [r | z | n] order, conv weights are HWIO.
Activations are (..., features); convolutions take NHWC and permute to
PyTorch's NCHW/OIHW only around the ``F.conv2d`` and
``F.conv_transpose2d`` calls.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Params = dict


def glorot(generator: torch.Generator, shape, device, dtype=torch.float32):
    """Xavier/Glorot uniform over the last axis as fan-out (the JAX
    package's ``layers.glorot`` convention)."""
    fan_in = math.prod(shape[:-1])
    lim = math.sqrt(6.0 / (fan_in + int(shape[-1])))
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return u * (2 * lim) - lim


def init_dense(generator, in_dim, out_dim, device, dtype=torch.float32,
               scale=1.0) -> Params:
    return {"w": glorot(generator, (in_dim, out_dim), device, dtype) * scale,
            "b": torch.zeros((out_dim,), device=device, dtype=dtype)}


def zeros_dense(in_dim, out_dim, device, dtype=torch.float32) -> Params:
    return {"w": torch.zeros((in_dim, out_dim), device=device, dtype=dtype),
            "b": torch.zeros((out_dim,), device=device, dtype=dtype)}


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


# -- GRU ----------------------------------------------------------------------
# h' = (1-z)*n + z*h with n = tanh(x_n + r * h_n), gates [r | z | n].

def init_gru(generator, in_dim, hidden, device, dtype=torch.float32) -> Params:
    return {
        "wi": glorot(generator, (in_dim, 3 * hidden), device, dtype),
        "wh": glorot(generator, (hidden, 3 * hidden), device, dtype),
        "bi": torch.zeros((3 * hidden,), device=device, dtype=dtype),
        "bh": torch.zeros((3 * hidden,), device=device, dtype=dtype),
    }


def init_gru_stack(generator, in_dim, hidden, num_layers, device,
                   dtype=torch.float32):
    return [init_gru(generator, in_dim if i == 0 else hidden, hidden, device,
                     dtype) for i in range(num_layers)]


def _gates(gi, gh, h):
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_step(p: Params, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One GRU step. h: (..., H), x: (..., in). Returns h'."""
    gi = x @ p["wi"].to(x.dtype) + p["bi"].to(x.dtype)
    gh = h @ p["wh"].to(h.dtype) + p["bh"].to(h.dtype)
    return _gates(gi, gh, h)


def gru_scan(p: Params, h0, xs, mask=None):
    """xs: (T, N, in); h0: (N, H); mask: (T, N) — masked steps carry the
    state through unchanged. Returns (h_T, hs (T, N, H))."""
    h = h0
    hs = []
    for t in range(xs.shape[0]):
        h_new = gru_step(p, h, xs[t])
        if mask is not None:
            h_new = torch.where(mask[t][:, None] > 0, h_new, h)
        h = h_new
        hs.append(h)
    return h, torch.stack(hs)


def gru_scan_const_x(p: Params, h0, x, t_len: int):
    """GRU scan fed the same x at every step: the input gates are computed
    once. Returns (h_T, hs (T, N, H))."""
    gi = x @ p["wi"].to(x.dtype) + p["bi"].to(x.dtype)
    h = h0
    hs = []
    for _ in range(t_len):
        gh = h @ p["wh"].to(h.dtype) + p["bh"].to(h.dtype)
        h = _gates(gi, gh, h)
        hs.append(h)
    return h, torch.stack(hs)


def gru_stack_scan(stack, h0s, xs, mask=None):
    """Multi-layer GRU. h0s: (L, N, H). Returns (finals (L, N, H), top-layer
    hs (T, N, H))."""
    finals = []
    cur = xs
    for layer, p in enumerate(stack):
        h_t, cur = gru_scan(p, h0s[layer], cur, mask=mask)
        finals.append(h_t)
    return torch.stack(finals), cur


# -- conv / group norm --------------------------------------------------------

def init_conv(generator, kh, kw, cin, cout, device, dtype=torch.float32):
    return {"w": glorot(generator, (kh, kw, cin, cout), device, dtype),
            "b": torch.zeros((cout,), device=device, dtype=dtype)}


def _same_pads(size, k, stride):
    """XLA's "SAME" padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p: Params, x: torch.Tensor, stride=1, padding="SAME"):
    """Convolution with XLA's padding conventions ("SAME": the output is
    ceil(in / stride), the extra pad row or column goes high; "VALID": no
    padding). x: (N, H, W, C) with HWIO weights."""
    w = p["w"]
    kh, kw = int(w.shape[0]), int(w.shape[1])
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        ph = _same_pads(int(x.shape[1]), kh, stride)
        pw = _same_pads(int(x.shape[2]), kw, stride)
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID': {padding!r}")
    y = F.conv2d(xc, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + p["b"].to(x.dtype)


def _conv_transpose_pads(k, stride, padding):
    """``jax.lax.conv_transpose``'s padding of one spatial axis of the
    stride-dilated input, (low, high), for the forward conv's "SAME" or
    "VALID" (``jax.lax``'s ``_conv_transpose_padding``). At SAME the odd
    pad goes low: k = 5, s = 2 pads (3, 2)."""
    if padding == "SAME":
        total = k + stride - 2
        low = k - 1 if stride > k - 1 else -(-total // 2)
    elif padding == "VALID":
        total = k + stride - 2 + max(k - stride, 0)
        low = k - 1
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID': {padding!r}")
    return low, total - low


def deconv2d(p: Params, x: torch.Tensor, stride=1, padding="SAME"):
    """Transposed convolution as ``jax.lax.conv_transpose`` computes it
    with its default ``transpose_kernel=False``: the stride-dilated input,
    padded per :func:`_conv_transpose_pads`, correlated with the HWIO
    kernel unflipped. x: (N, H, W, Cin), w: (kh, kw, Cin, Cout).

    ``F.conv_transpose2d`` correlates the dilated input with the kernel
    flipped, padded k - 1 on both sides (padding 0): it is given the
    flipped kernel, and its output is cropped to the low and high pads."""
    w = p["w"]
    kh, kw = int(w.shape[0]), int(w.shape[1])
    ph = _conv_transpose_pads(kh, stride, padding)
    pw = _conv_transpose_pads(kw, stride, padding)
    wt = w.to(x.dtype).permute(2, 3, 0, 1).flip(2, 3)    # (Cin, Cout, kh, kw)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=stride)
    # the full output pads k - 1 a side; keep (low, high) of them
    y = F.pad(y, (pw[0] - (kw - 1), pw[1] - (kw - 1),
                  ph[0] - (kh - 1), ph[1] - (kh - 1)))
    return y.permute(0, 2, 3, 1) + p["b"].to(x.dtype)


def init_groupnorm(channels, device, dtype=torch.float32) -> Params:
    return {"scale": torch.ones((channels,), device=device, dtype=dtype),
            "bias": torch.zeros((channels,), device=device, dtype=dtype)}


def groupnorm(p: Params, x: torch.Tensor, groups=8, eps=1e-5):
    """Group norm over (spatial..., channels-in-group); x: (N, ..., C)."""
    c = x.shape[-1]
    g = min(groups, c)
    while c % g:
        g -= 1
    xg = x.reshape(x.shape[:-1] + (g, c // g))
    axes = (-1,) + tuple(range(1, x.dim() - 1))
    mean = xg.mean(dim=axes, keepdim=True)
    var = xg.var(dim=axes, keepdim=True, unbiased=False)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return (xg.reshape(x.shape) * p["scale"].to(x.dtype)
            + p["bias"].to(x.dtype))
