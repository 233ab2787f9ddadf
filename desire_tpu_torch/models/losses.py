"""Loss math and masks (PyTorch port of ``desire_tpu/models/losses.py``).

* bivariate-Gaussian NLL: ``-log(max(pdf, 1e-20))`` per step, computed in
  the log domain, with log sigma clamped to [-9, 6] and rho to +-0.999;
* KL divergence of the CVAE posterior from N(0, I) or from the conditional
  prior, with an optional per-dimension floor (free bits);
* the live-agent masked mean;
* the IOC ranking cross-entropy and the refinement regression;
* draws from the bivariate Gaussians (stochastic sampling).

Every stop-gradient of the JAX package is a ``.detach()`` here. Reductions
that pick one lane (``min``) share the gradient between tied lanes, as
JAX's do (``torch.amin``).
"""

from __future__ import annotations

import math

import torch

_PDF_EPS = 1e-20
_LOG_PDF_FLOOR = math.log(_PDF_EPS)  # ~ -46.05
_LOG_SIGMA_MIN = -9.0
_LOG_SIGMA_MAX = 6.0
_RHO_MAX = 0.999
_LOG_2PI = math.log(2.0 * math.pi)


def get_coef(raw: torch.Tensor):
    """(..., 5) raw decoder output -> (mu_x, mu_y, sigma_x, sigma_y, rho)."""
    mux, muy, log_sx, log_sy, raw_rho = raw.unbind(-1)
    sx = torch.exp(torch.clamp(log_sx, _LOG_SIGMA_MIN, _LOG_SIGMA_MAX))
    sy = torch.exp(torch.clamp(log_sy, _LOG_SIGMA_MIN, _LOG_SIGMA_MAX))
    rho = torch.tanh(raw_rho) * _RHO_MAX
    return mux, muy, sx, sy, rho


def bivariate_gaussian_log_pdf(x, y, mux, muy, sx, sy, rho):
    """log N([x, y]; mu, Sigma)."""
    nx = (x - mux) / sx
    ny = (y - muy) / sy
    one_m_rho2 = 1.0 - rho * rho
    z = nx * nx + ny * ny - 2.0 * rho * nx * ny
    return (-z / (2.0 * one_m_rho2) - _LOG_2PI
            - torch.log(sx) - torch.log(sy) - 0.5 * torch.log(one_m_rho2))


def bivariate_nll(raw, target_xy, step_mask=None, floor=True):
    """Per-step negative log-likelihood. raw (..., 5), target_xy (..., 2),
    step_mask (...) optional 0/1. With floor, the NLL is capped at
    -log(1e-20) (zero gradient where the cap is active)."""
    mux, muy, sx, sy, rho = get_coef(raw)
    logp = bivariate_gaussian_log_pdf(target_xy[..., 0], target_xy[..., 1],
                                      mux, muy, sx, sy, rho)
    if floor:
        logp = torch.clamp(logp, min=_LOG_PDF_FLOOR)
    nll = -logp
    if step_mask is not None:
        nll = nll * step_mask
    return nll


def kld_normal(mean, log_var, dim=-1, free_bits=0.0):
    """KL(N(mean, exp(log_var)) || N(0, I)) summed over ``dim``; free_bits
    floors each dimension's contribution."""
    per_dim = -0.5 * (1.0 + log_var - mean * mean - torch.exp(log_var))
    if free_bits > 0.0:
        per_dim = torch.clamp(per_dim, min=free_bits)
    return per_dim.sum(dim=dim)


def kld_gaussians(mean_q, log_var_q, mean_p, log_var_p, dim=-1,
                  free_bits=0.0):
    """KL(N(mean_q, exp(log_var_q)) || N(mean_p, exp(log_var_p))) summed
    over ``dim``; free_bits floors each dimension's contribution."""
    var_q = torch.exp(log_var_q)
    inv_var_p = torch.exp(-log_var_p)
    per_dim = 0.5 * (log_var_p - log_var_q - 1.0
                     + (var_q + (mean_q - mean_p) ** 2) * inv_var_p)
    if free_bits > 0.0:
        per_dim = torch.clamp(per_dim, min=free_bits)
    return per_dim.sum(dim=dim)


def masked_mean(values, mask, eps=1e-8, count=None):
    """sum(values * mask) / max(sum(mask), eps). count: the denominator's
    sum in place of sum(mask): under a data-parallel mesh, the mask's sum
    over the global batch, so that the ranks' terms add up to the global
    mean."""
    mask = mask.to(values.dtype)
    if count is None:
        count = mask.sum()
    return (values * mask).sum() / torch.clamp(count, min=eps)


def agent_validity_mask(src_ids, tgt_ids=None):
    """Live-agent mask: id 0 marks an empty slot. An agent must exist in
    both the source and, when given, the target frames."""
    live = src_ids != 0
    if tgt_ids is not None:
        live = live & (tgt_ids != 0)
    return live.to(torch.float32)


def ioc_cross_entropy(scores, hyp_xy, gt_xy, agent_mask, step_mask=None,
                      temperature=1.0, standardize=True, count=None):
    """Max-ent IOC ranking loss over K hypotheses.

    scores (..., K); hyp_xy (..., K, T, 2); gt_xy (..., T, 2); agent_mask
    (...); step_mask (..., T). The target q_k is softmax(-dist_k / temp)
    over the lanes' mean displacement errors (z-scored across the lanes
    when standardize); it is a target, so the trajectories get no gradient
    from it. Returns the masked mean over agents of CE(q, softmax(scores))
    (count: as :func:`masked_mean`'s).
    """
    hyp_xy = hyp_xy.detach()
    diff = hyp_xy - gt_xy[..., None, :, :]
    d = torch.sqrt((diff * diff).sum(dim=-1) + 1e-12)          # (..., K, T)
    if step_mask is not None:
        sm = step_mask[..., None, :]
        d = (d * sm).sum(dim=-1) / torch.clamp(sm.sum(dim=-1), min=1e-8)
    else:
        d = d.mean(dim=-1)
    if standardize:
        mu = d.mean(dim=-1, keepdim=True)
        sd = d.std(dim=-1, keepdim=True, correction=0)
        d = (d - mu) / (sd + 1e-8)
    q = torch.softmax(-d / temperature, dim=-1)
    logp = torch.log_softmax(scores, dim=-1)
    ce = -(q * logp).sum(dim=-1)
    return masked_mean(ce, agent_mask, count=count)


def refine_regression_loss(refined_xy, gt_xy, agent_mask, step_mask=None,
                           agg="min", lane_penalty=None, count=None):
    """L2 regression of refined trajectories (..., K, T, 2) on gt (..., T,
    2), step-masked mean over T, then 'min' (closest lane, after the
    optional additive lane_penalty (..., K)) or 'mean' over the lanes, then
    the masked mean over agents (count: as :func:`masked_mean`'s)."""
    err = ((refined_xy - gt_xy[..., None, :, :]) ** 2).sum(dim=-1)
    if step_mask is not None:
        sm = step_mask[..., None, :]
        err = (err * sm).sum(dim=-1) / torch.clamp(sm.sum(dim=-1), min=1e-8)
    else:
        err = err.mean(dim=-1)
    if agg == "min":
        if lane_penalty is not None:
            err = err + lane_penalty
        err = torch.amin(err, dim=-1)
    else:
        err = err.mean(dim=-1)
    return masked_mean(err, agent_mask, count=count)


def sample_bivariate(raw, draws=None, generator=None):
    """Draw (x, y) from the bivariate Gaussians of raw (..., 5) by the
    Cholesky factor of [[sx^2, rho sx sy], [rho sx sy, sy^2]]: x = mux +
    sx e1, y = muy + sy (rho e1 + sqrt(1 - rho^2) e2). draws: the two
    standard-normal draws (e1, e2), each of raw's leading shape; else drawn
    from generator. Returns (..., 2)."""
    mux, muy, sx, sy, rho = get_coef(raw)
    if draws is None:
        e1, e2 = (torch.randn(mux.shape, generator=generator,
                              device=mux.device, dtype=mux.dtype)
                  for _ in range(2))
    else:
        e1, e2 = (torch.as_tensor(e, device=mux.device).to(mux.dtype)
                  for e in draws)
    x = mux + sx * e1
    y = muy + sy * (rho * e1 + torch.sqrt(1.0 - rho * rho) * e2)
    return torch.stack([x, y], dim=-1)
