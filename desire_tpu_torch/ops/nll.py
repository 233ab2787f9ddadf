"""The step-summed bivariate NLL per (row, lane): CUDA kernels and their
plain PyTorch version (port of ``desire_tpu/ops/nll.py``).

raw5 (N, K, T, 5) [mu_x, mu_y, log_sx, log_sy, rho_raw], target (N, T, 2)
and step_mask (N, T) -> (N, K) float32: ``losses.bivariate_nll`` summed over
the steps. Gradients flow to raw5 only (targets and masks are data). On
CUDA tensors the forward is ``csrc/nll.cu nll_fwd_kernel`` and the gradient
``nll_bwd_kernel`` (the analytic gradient, zero where the log floor is
active); on CPU tensors autograd runs through the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from desire_tpu_torch.models import losses
from desire_tpu_torch.ops import _build

_F32 = torch.float32


def bivariate_nll_plain(raw5, target, step_mask):
    """Plain PyTorch version: (N, K, T, 5), (N, T, 2), (N, T) -> (N, K)."""
    steps = losses.bivariate_nll(raw5.float(), target.float()[:, None],
                                 step_mask=step_mask.float()[:, None])
    return steps.sum(dim=-1)


def _shapes(raw5, target, step_mask):
    n, k, t, _ = raw5.shape
    dev = raw5.device
    _build.check(raw5, "raw5", (n, k, t, 5), _F32, dev)
    _build.check(target, "target", (n, t, 2), _F32, dev)
    _build.check(step_mask, "step_mask", (n, t), _F32, dev)
    return n, k, t


def nll_fwd_cuda(raw5, target, step_mask):
    """Launch kernel 4 (``nll_fwd_kernel``) on contiguous float32 CUDA
    tensors. Returns (N, K) float32."""
    if not raw5.is_cuda:
        raise ValueError("nll_fwd_cuda needs CUDA tensors")
    n, k, t = _shapes(raw5, target, step_mask)
    out = torch.empty((n, k), dtype=_F32, device=raw5.device)
    rc = _build.library().nll_fwd_launch(
        raw5.data_ptr(), target.data_ptr(), step_mask.data_ptr(),
        out.data_ptr(), n, k, t,
        ctypes.c_void_p(torch.cuda.current_stream(raw5.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"nll_fwd kernel launch failed: CUDA error {rc}")
    _build.LAUNCHES["nll_fwd"] += 1
    return out


def nll_bwd_cuda(raw5, target, step_mask, g):
    """Launch kernel 5 (``nll_bwd_kernel``): the gradient of the summed NLL
    with respect to raw5 for the cotangent g (N, K). Returns (N, K, T, 5)
    float32."""
    if not raw5.is_cuda:
        raise ValueError("nll_bwd_cuda needs CUDA tensors")
    n, k, t = _shapes(raw5, target, step_mask)
    _build.check(g, "g", (n, k), _F32, raw5.device)
    d_raw5 = torch.empty_like(raw5)
    rc = _build.library().nll_bwd_launch(
        raw5.data_ptr(), target.data_ptr(), step_mask.data_ptr(),
        g.data_ptr(), d_raw5.data_ptr(), n, k, t,
        ctypes.c_void_p(torch.cuda.current_stream(raw5.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"nll_bwd kernel launch failed: CUDA error {rc}")
    _build.LAUNCHES["nll_bwd"] += 1
    return d_raw5


class _NllCuda(torch.autograd.Function):
    """Kernel 4 forward, kernel 5 backward."""

    @staticmethod
    def forward(ctx, raw5, target, step_mask):
        ctx.save_for_backward(raw5, target, step_mask)
        return nll_fwd_cuda(raw5, target, step_mask)

    @staticmethod
    def backward(ctx, g):
        raw5, target, step_mask = ctx.saved_tensors
        return (nll_bwd_cuda(raw5, target, step_mask,
                             g.float().contiguous()), None, None)


def bivariate_nll_sum(raw5, target, step_mask):
    """Step-summed NLL per (row, lane) on the tensors' device: the CUDA
    kernels for CUDA tensors, the plain version for CPU tensors."""
    if raw5.is_cuda:
        return _NllCuda.apply(raw5.float().contiguous(),
                              target.float().contiguous(),
                              step_mask.float().contiguous())
    if raw5.device.type == "cpu":
        return bivariate_nll_plain(raw5, target, step_mask)
    raise ValueError(f"no NLL kernel for device {raw5.device}")
