"""Forecast metrics (PyTorch port of ``desire_tpu/eval/metrics.py``).

The DESIRE paper's protocol: displacement errors over the 12-step horizon
in pixels (de-normalized by the per-video scale), minimum over the K
hypotheses, averaged over live agents; the IOC ranking diagnostics; and
the calibration statistics of the SGM's Gaussian heads. Each function
runs on the device of its inputs. Standard deviations are population ones
and argmax / argmin take the first extremum, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from desire_tpu_torch.models import losses


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _scaled(pred, gt, scale):
    if scale is None:
        return pred, gt
    return (pred * scale[:, None, None, None, None],
            gt * scale[:, None, None, None])


def displacement_errors(pred, gt, step_mask):
    """pred (..., K, T, 2), gt (..., T, 2), step_mask (..., T) ->
    (ade (..., K), fde (..., K))."""
    d = _norm(pred - gt[..., None, :, :])                      # (..., K, T)
    m = step_mask[..., None, :]
    ade = (d * m).sum(-1) / torch.clamp(m.sum(-1), min=1e-8)
    # FDE at the last *valid* step of each agent
    t = step_mask.shape[-1]
    idx = torch.argmax(step_mask * torch.arange(
        1, t + 1, dtype=step_mask.dtype, device=step_mask.device), dim=-1)
    idx = idx[..., None, None].expand(d.shape[:-1] + (1,))
    fde = torch.take_along_dim(d, idx, dim=-1)[..., 0]
    return ade, fde


def min_ade_fde(pred, gt, step_mask, agent_mask, scale=None):
    """Best-of-K metrics. pred (B, A, K, T, 2); gt (B, A, T, 2); step_mask
    (B, A, T); agent_mask (B, A); scale (B,) pixels per unit. Returns
    scalar (minADE, minFDE) over the agents with a valid future step."""
    pred, gt = _scaled(pred, gt, scale)
    ade, fde = displacement_errors(pred, gt, step_mask)
    valid = agent_mask * (step_mask.sum(-1) > 0)
    return (losses.masked_mean(ade.amin(-1), valid),
            losses.masked_mean(fde.amin(-1), valid))


def per_agent_min_ade_fde(pred, gt, step_mask, scale=None):
    """Per-agent best-of-K errors (callers aggregate): (min_ade (B, A),
    min_fde (B, A)), in pixels when scale is given."""
    pred, gt = _scaled(pred, gt, scale)
    ade, fde = displacement_errors(pred, gt, step_mask)
    return ade.amin(-1), fde.amin(-1)


def track_decomposition(pred, gt, step_mask, scale=None, min_step_px=0.25):
    """Along- and cross-track parts of the best-of-K lane's error, in the
    frame of the ground-truth path's unit tangent at each step (step 0
    borrows step 1's); steps where the truth moves less than min_step_px
    are left out. Returns (along (B, A), cross (B, A), weight (B, A)): the
    per-agent masked means and a 0/1 weight (>= 1 decomposable step)."""
    pred, gt = _scaled(pred, gt, scale)
    ade, _ = displacement_errors(pred, gt, step_mask)
    k_best = torch.argmin(ade, dim=-1)                          # (B, A)
    idx = k_best[..., None, None, None].expand(
        k_best.shape + (1,) + pred.shape[3:])
    best = torch.take_along_dim(pred, idx, dim=2)[:, :, 0]      # (B,A,T,2)
    tan = torch.diff(gt, dim=-2, prepend=gt[..., :1, :])
    if gt.shape[-2] > 1:
        tan = torch.cat([tan[..., 1:2, :], tan[..., 1:, :]], dim=-2)
    tn = _norm(tan)[..., None]
    ok = (tn[..., 0] > min_step_px).to(gt.dtype) * step_mask    # (B, A, T)
    u = tan / torch.clamp(tn, min=1e-6)
    e = best - gt
    along = (e * u).sum(-1).abs()
    cross = (e[..., 0] * u[..., 1] - e[..., 1] * u[..., 0]).abs()
    denom = torch.clamp(ok.sum(-1), min=1e-8)
    return ((along * ok).sum(-1) / denom, (cross * ok).sum(-1) / denom,
            (ok.sum(-1) > 0).to(gt.dtype))


def best_of_k_by_score(pred, scores, blend=0.0):
    """Each agent's top-scored hypothesis. pred (B, A, K, T, 2), scores
    (B, A, K) -> (B, A, T, 2).

    blend > 0 adds the z-normalized lane typicality (negative endpoint
    distance to the K-lane mean endpoint) to the z-normalized score before
    the argmax."""
    if blend:
        ends = pred[..., -1, :]
        typ = -_norm(ends - ends.mean(dim=2, keepdim=True))

        def z(x):
            mu = x.mean(dim=-1, keepdim=True)
            sd = x.std(dim=-1, keepdim=True, correction=0)
            return (x - mu) / (sd + 1e-8)
        scores = z(scores) + blend * z(typ)
    idx = torch.argmax(scores, dim=-1)                    # (B, A)
    idx = idx[..., None, None, None].expand(
        idx.shape + (1,) + pred.shape[3:])
    return torch.take_along_dim(pred, idx, dim=2)[:, :, 0]


def _horizon(pred, gt, step_mask, horizon_steps):
    """(ade (B, A, K), fde (B, A, K), hi): errors at a possibly fractional
    horizon, ADE over the integer steps up to floor(h), FDE at the lerp of
    the bracketing steps."""
    t = gt.shape[-2]
    lo = max(int(math.floor(horizon_steps + 1e-6)), 1)      # 1-based
    hi = min(int(math.ceil(horizon_steps - 1e-6)), t)
    frac = float(horizon_steps) - lo
    d = _norm(pred - gt[..., None, :, :])                    # (B, A, K, T)
    ade = d[..., :lo].mean(-1)
    if hi > lo:
        p_h = pred[..., lo - 1, :] * (1 - frac) + pred[..., hi - 1, :] * frac
        g_h = gt[..., lo - 1, :] * (1 - frac) + gt[..., hi - 1, :] * frac
        fde = _norm(p_h - g_h[..., None, :])
    else:
        fde = d[..., lo - 1]
    return ade, fde, hi


def horizon_ade_fde(pred, gt, step_mask, agent_mask, horizon_steps,
                    scale=None):
    """The paper's errors at a horizon of horizon_steps steps (1.0 s at
    2.5 Hz is step 2.5: FDE at the lerp of steps 2 and 3, ADE over steps 1
    and 2). Returns (minADE@h, minFDE@h, count) over the agents whose mask
    covers every step up to ceil(h)."""
    pred, gt = _scaled(pred, gt, scale)
    ade, fde, hi = _horizon(pred, gt, step_mask, horizon_steps)
    covered = (step_mask[..., :hi] > 0).all(-1)
    valid = agent_mask * covered
    return (losses.masked_mean(ade.amin(-1), valid),
            losses.masked_mean(fde.amin(-1), valid), valid.sum())


def per_agent_horizon(pred, gt, step_mask, horizon_steps, scale=None):
    """Per-agent horizon_ade_fde: (min_ade@h (B, A), min_fde@h (B, A),
    covered (B, A)), covered the agent's eligibility."""
    pred, gt = _scaled(pred, gt, scale)
    ade, fde, hi = _horizon(pred, gt, step_mask, horizon_steps)
    covered = (step_mask[..., :hi] > 0).all(-1).float()
    return ade.amin(-1), fde.amin(-1), covered


def per_agent_ranking(scores, pred, gt, step_mask):
    """Per-agent ranking diagnostics: (top1_pct (B, A), corr (B, A))."""
    d = _norm(pred - gt[..., None, :, :])                        # (B,A,K,T)
    m = step_mask[..., None, :]
    ade = (d * m).sum(-1) / torch.clamp(m.sum(-1), min=1e-8)
    k = ade.shape[-1]
    pick = torch.argmax(scores, dim=-1)                          # (B, A)
    picked = torch.take_along_dim(ade, pick[..., None], dim=-1)[..., 0]
    better = (ade < picked[..., None]).float().sum(-1)
    top1_pct = better / max(k - 1, 1)

    def z(x):
        return (x - x.mean(-1, keepdim=True)) / (
            x.std(-1, keepdim=True, correction=0) + 1e-8)
    corr = (-z(scores) * z(ade)).mean(-1)
    return top1_pct, corr


def ranking_quality(scores, pred, gt, step_mask, agent_mask):
    """IOC ranking diagnostics over the agents with a valid future step:
    (top1_pct, corr, n). top1_pct is the mean percentile rank by ADE of the
    top-scored lane (0 = the best lane; chance 0.5 - 0.5/K); corr the mean
    per-agent correlation between scores and -ADE across lanes."""
    top1_pct, corr = per_agent_ranking(scores, pred, gt, step_mask)
    valid = agent_mask * (step_mask.sum(-1) > 0)
    return (losses.masked_mean(top1_pct, valid),
            losses.masked_mean(corr, valid), valid.sum())


def pit_values(raw5, gt, step_mask, agent_mask, sigma_temp=1.0):
    """Probability integral transform of the truth under the K-lane
    Gaussian mixture, per coordinate: u = mean_k Phi((x - mu_k) / s_k).

    sigma_temp scales the predicted sigmas: a scalar tau, or (tau_center,
    tau_tail[, w_center]) for the two-scale lane CDF w Phi(z / tau_c) +
    (1 - w) Phi(z / tau_t) (w 0.5 unless given). raw5 (B, A, K, T, 5); gt
    (B, A, T, 2); step_mask (B, A, T); agent_mask (B, A). Returns
    (u (B, A, T, 2), weights (B, A, T))."""
    mux, muy, sx, sy, _ = losses.get_coef(raw5.float())
    gx = gt[..., None, :, 0]
    gy = gt[..., None, :, 1]

    def phi(z):
        return 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))

    if isinstance(sigma_temp, (tuple, list)):
        tc, tt = float(sigma_temp[0]), float(sigma_temp[1])
        w = float(sigma_temp[2]) if len(sigma_temp) > 2 else 0.5
        ux = (w * phi((gx - mux) / (sx * tc))
              + (1 - w) * phi((gx - mux) / (sx * tt))).mean(-2)
        uy = (w * phi((gy - muy) / (sy * tc))
              + (1 - w) * phi((gy - muy) / (sy * tt))).mean(-2)
    else:
        if sigma_temp != 1.0:
            sx = sx * sigma_temp
            sy = sy * sigma_temp
        ux = phi((gx - mux) / sx).mean(-2)                  # (B, A, T)
        uy = phi((gy - muy) / sy).mean(-2)
    w = step_mask * agent_mask[..., None]
    return torch.stack([ux, uy], dim=-1), w


def pit_histogram(u, w, bins=10):
    """Weighted PIT histogram counts (over both coordinates)."""
    u = u.reshape(-1)
    w = w[..., None].expand(w.shape + (2,)).reshape(-1)
    edges = torch.linspace(0.0, 1.0, bins + 1, device=u.device)
    idx = torch.clamp(torch.searchsorted(edges, u.contiguous(), right=True)
                      - 1, 0, bins - 1)
    return torch.zeros(bins, device=u.device).index_add_(0, idx, w.float())


def coverage(u, w, levels=(0.5, 0.9)):
    """Central-interval coverage: the weighted share of PIT values inside
    ((1 - l) / 2, (1 + l) / 2) for each level l (calibrated: l)."""
    w2 = w[..., None].expand(w.shape + (2,))
    tot = torch.clamp(w2.sum(), min=1e-8)
    out = {}
    for lv in levels:
        lo, hi = (1 - lv) / 2, (1 + lv) / 2
        inside = ((u >= lo) & (u <= hi)).float()
        out[lv] = float((inside * w2).sum() / tot)
    return out
