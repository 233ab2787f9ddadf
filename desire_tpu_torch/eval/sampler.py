"""The evaluation harness (PyTorch port of the ``make_eval_step``,
``fit_rank_blend`` and ``evaluate`` of ``desire_tpu/eval/sampler.py``).

One eval step is one ``desire_forward(train=False)`` (through the serving
kernels on CUDA tensors) and every per-batch metric, computed on the
params' device and copied to the host in one piece: small per-agent
(B, A) arrays. The host then groups them (scenes, speed classes, horizons)
and sums them in float64, as the JAX package does.

The latent noise comes from a ``torch.Generator`` on the params' device,
seeded ``cfg.seed + 1`` for ``evaluate`` and ``cfg.seed + 7`` for
``fit_rank_blend`` unless one is given; ``eps`` pins each batch's draws
instead (a sequence of (B*A, K, lat) arrays, one a batch).
"""

from __future__ import annotations

import numpy as np
import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.eval import metrics as M
from desire_tpu_torch.models import desire
from desire_tpu_torch.train.state import tree_leaves
from desire_tpu_torch.train.trainer import make_eval_forward, stage_to_device


def _observed_speed_px(obs_xy, obs_mask, scale):
    """Mean observed speed per agent in pixels a step: obs_xy (B, A, To, 2),
    obs_mask (B, A, To), scale (B,) -> (B, A)."""
    both = obs_mask[..., 1:] * obs_mask[..., :-1]
    step = torch.linalg.vector_norm(torch.diff(obs_xy, dim=2), dim=-1)
    return ((step * both).sum(-1) / torch.clamp(both.sum(-1), min=1e-6)
            * scale[:, None])


def _forward(fwd, params, xy, mask, ids, eps, generator, z_temp=None):
    """The inference forward ``fwd`` (``make_eval_forward``) in float32:
    (out, traj, scores, gt, step mask, weights). weights: live agents with
    a valid future step, the agents every metric averages over."""
    out = fwd(params, xy, mask, ids, eps=eps, generator=generator,
              z_temp=z_temp)
    traj = out["refined_traj"].float()
    scores = out["scores"]
    if scores is None:
        scores = torch.zeros(traj.shape[:3], device=traj.device)
    gt = out["fut_xy"].float()
    sm = out["fut_mask"].float()
    live = out["live"].float() * (sm.sum(-1) > 0)
    return out, traj, scores.float(), gt, sm, live


def _to_host(res):
    """{name: tensor} -> {name: numpy array}, in one device-to-host copy."""
    names = list(res)
    flat = torch.cat([res[k].reshape(-1).float() for k in names]).cpu()
    out, i = {}, 0
    for k in names:
        n = res[k].numel()
        out[k] = flat[i:i + n].numpy().reshape(tuple(res[k].shape))
        i += n
    return out


def make_eval_step(cfg: DesireConfig, k_samples=None, horizon_steps=(),
                   calibration=False, pit_bins=20, rank_blend=0.0,
                   z_temp_fast=1.0, z_temp_px=20.0, sigma_temps=(1.0,)):
    """step(params, xy, mask, ids, scale, eps=None, generator=None) ->
    {name: numpy array}: the forward and every per-batch metric, mostly
    per-agent (B, A) arrays ("h<i>": (5, B, A), minADE, minFDE, top-1 ADE
    and FDE and coverage at horizon i), with one copy to the host.

    z_temp_fast != 1 samples the agents observed at >= z_temp_px pixels a
    step with that latent temperature; sigma_temps: the PIT temperatures of
    the calibration statistics (index 0 the raw report)."""
    fwd = make_eval_forward(cfg, k_samples)

    def step(params, xy, mask, ids, scale, eps=None, generator=None):
        zt = None
        if z_temp_fast != 1.0:
            oxy, _, om, _ = desire.split_batch(cfg, xy.float(), mask.float())
            spd = _observed_speed_px(oxy, om, scale)
            zt = torch.where(spd >= z_temp_px, z_temp_fast, 1.0)
        out, traj, scores, gt, sm, live = _forward(
            fwd, params, xy, mask, ids, eps, generator, zt)
        best = M.best_of_k_by_score(traj, scores, blend=rank_blend)[:, :,
                                                                    None]
        res = {"valid": live}
        res["ade"], res["fde"] = M.per_agent_min_ade_fde(traj, gt, sm, scale)
        res["top1_ade"], res["top1_fde"] = M.per_agent_min_ade_fde(
            best, gt, sm, scale)
        res["sgm_ade"], res["sgm_fde"] = M.per_agent_min_ade_fde(
            out["sgm_traj"].float(), gt, sm, scale)
        res["rank_pct"], res["rank_corr"] = M.per_agent_ranking(
            scores, traj, gt, sm)
        res["along"], res["cross"], res["dec_w"] = M.track_decomposition(
            traj, gt, sm, scale)
        res["speed"] = _observed_speed_px(out["obs_xy"].float(),
                                          out["obs_mask"].float(), scale)
        for i, hs in enumerate(horizon_steps):
            ha, hf, cov = M.per_agent_horizon(traj, gt, sm, hs, scale)
            ba, bf, _ = M.per_agent_horizon(best, gt, sm, hs, scale)
            res[f"h{i}"] = torch.stack([ha, hf, ba, bf, cov])
        if calibration:
            for j, tau in enumerate(sigma_temps):
                u, w = M.pit_values(out["raw5"], gt, sm, live,
                                    sigma_temp=tau)
                suff = "" if j == 0 else f"_t{j}"
                res[f"pit_hist{suff}"] = M.pit_histogram(u, w, pit_bins)
                w2 = w[..., None].expand(w.shape + (2,))
                for lv, name in ((0.5, "cov_50"), (0.9, "cov_90")):
                    lo, hi = (1 - lv) / 2, (1 + lv) / 2
                    inside = ((u >= lo) & (u <= hi)).float()
                    res[f"{name}{suff}"] = (inside * w2).sum()
                if j == 0:
                    res["cov_w"] = w2.sum()
        return _to_host(res)
    return step


def _device_and_generator(params, generator, seed):
    dev = tree_leaves(params)[0].device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    return dev, generator


def _batch_eps(eps, bi, dev):
    return None if eps is None else torch.as_tensor(
        np.asarray(eps[bi], np.float32), device=dev)


def fit_rank_blend(params, cfg: DesireConfig, loader, *,
                   blends=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0), max_batches=30,
                   k_samples=None, generator=None, eps=None):
    """Fit the top-1 score/typicality blend on a train-split slice: one
    forward a batch, the blended-argmax top-1 ADE at every candidate blend.
    Returns (the blend of least top-1 ADE, diagnostics)."""
    dev, generator = _device_and_generator(params, generator, cfg.seed + 7)
    blends = tuple(float(b) for b in blends)
    fwd = make_eval_forward(cfg, k_samples)
    sums = np.zeros(len(blends))
    w = 0.0
    for bi, batch in enumerate(loader.epoch_batches(0)):
        if bi >= max_batches:
            break
        xy, mask, ids, scale = stage_to_device(
            [batch.xy, batch.mask, batch.ids, batch.scale], dev)
        _, traj, scores, gt, sm, live = _forward(
            fwd, params, xy, mask, ids, _batch_eps(eps, bi, dev), generator)
        res = {"w": live.sum()}
        for j, bl in enumerate(blends):
            best = M.best_of_k_by_score(traj, scores, blend=bl)[:, :, None]
            ade, _ = M.per_agent_min_ade_fde(best, gt, sm, scale)
            res[f"t1_{j}"] = (ade * live).sum()
        res = _to_host(res)
        for j in range(len(blends)):
            sums[j] += float(res[f"t1_{j}"])
        w += float(res["w"])
    t1 = sums / max(w, 1e-8)
    j = int(np.argmin(t1))
    return blends[j], {"blends": list(blends),
                       "top1ADE_px": [float(x) for x in t1],
                       "fit_weight": float(w)}


def evaluate(params, cfg: DesireConfig, loader, *, k_samples=None,
             generator=None, eps=None, max_batches=None, epoch: int = 0,
             per_scene: bool = False, horizons=None,
             calibration: bool = False, speed_bins=None,
             rank_blend: float = 0.0, z_temp_fast: float = 1.0,
             z_temp_px: float = 20.0, sigma_temps=(1.0,)) -> dict:
    """minADE/minFDE (pixels) and the other metrics over a loader's epoch
    stream, the JAX ``evaluate``'s keys.

    per_scene adds a per-scene breakdown; horizons (seconds, e.g. (1, 2, 3,
    4)) the paper's errors at each horizon, in pixels and at 1/5
    resolution; calibration the PIT and coverage statistics of the
    Gaussian heads (sigma_temps[1], when given, adds the ``*_cal`` keys);
    speed_bins (ascending pixels a step) a breakdown by observed speed."""
    dev, generator = _device_and_generator(params, generator, cfg.seed + 1)
    acc: dict = {}
    # the protocol rate: SDD's ~30 fps strided by subsample
    hz = 30.0 / max(cfg.subsample, 1)
    horizons = [h for h in (horizons or ())
                if h * hz <= cfg.pred_len + 1e-6]
    hor_acc = {h: [0.0, 0.0, 0.0, 0.0, 0.0] for h in horizons}
    pit_bins = 20
    sigma_temps = tuple(sigma_temps)
    nt = len(sigma_temps)
    cal_acc = {"hist": [np.zeros(pit_bins) for _ in range(nt)],
               "cov_n": 0.0,
               "cov": [{0.5: 0.0, 0.9: 0.0} for _ in range(nt)]}
    step = make_eval_step(cfg, k_samples=k_samples,
                          horizon_steps=tuple(h * hz for h in horizons),
                          calibration=calibration, pit_bins=pit_bins,
                          rank_blend=rank_blend, z_temp_fast=z_temp_fast,
                          z_temp_px=z_temp_px, sigma_temps=sigma_temps)
    dec_acc: dict = {}

    def add(tag, a, f, b_ade, n):
        d = acc.setdefault(tag, [0.0, 0.0, 0.0, 0.0])
        d[0] += a
        d[1] += f
        d[2] += b_ade
        d[3] += n

    def add_dec(tag, res, sel):
        # along/cross-track parts of the min-ADE lane (dec_w gates agents
        # without a decomposable step)
        d = dec_acc.setdefault(tag, [0.0, 0.0, 0.0])
        wd = sel * res["dec_w"]
        d[0] += float(np.sum(res["along"] * wd))
        d[1] += float(np.sum(res["cross"] * wd))
        d[2] += float(np.sum(wd))

    for bi, batch in enumerate(loader.epoch_batches(epoch)):
        if max_batches is not None and bi >= max_batches:
            break
        xy, mask, ids, scale = stage_to_device(
            [batch.xy, batch.mask, batch.ids, batch.scale], dev)
        res = step(params, xy, mask, ids, scale,
                   eps=_batch_eps(eps, bi, dev), generator=generator)
        w = res["valid"]                                  # (B, A) weights

        def wsum(x, wt=w):
            return float(np.sum(x * wt))

        add("__all__", wsum(res["ade"]), wsum(res["fde"]),
            wsum(res["top1_ade"]), float(np.sum(w)))
        add_dec("__all__", res, w)
        add("__sgm__", wsum(res["sgm_ade"]), wsum(res["sgm_fde"]),
            wsum(res["sgm_ade"]), float(np.sum(w)))
        add("__rank__", wsum(res["rank_pct"]), wsum(res["rank_corr"]),
            0.0, float(np.sum(w)))
        if per_scene:
            for vid in np.unique(batch.video):
                sel = w * (batch.video == vid)[:, None]
                scene = loader.videos[int(vid)].name.split("/")[0]
                add(scene, wsum(res["ade"], sel), wsum(res["fde"], sel),
                    wsum(res["top1_ade"], sel), float(np.sum(sel)))
        if speed_bins:
            edges = [0.0] + list(speed_bins) + [float("inf")]
            for lo, hi in zip(edges[:-1], edges[1:]):
                sel = w * (res["speed"] >= lo) * (res["speed"] < hi)
                n_s = float(np.sum(sel))
                if n_s == 0:
                    continue
                tag = f"speed[{lo:g},{hi:g})px/step"
                add(tag, wsum(res["ade"], sel), wsum(res["fde"], sel),
                    wsum(res["top1_ade"], sel), n_s)
                add_dec(tag, res, sel)
        for i, h in enumerate(horizons):
            ha, hf, ba, bf, cov = res[f"h{i}"]
            sel = w * cov
            d = hor_acc[h]
            d[0] += wsum(ha, sel)
            d[1] += wsum(hf, sel)
            d[2] += wsum(ba, sel)
            d[3] += wsum(bf, sel)
            d[4] += float(np.sum(sel))
        if calibration:
            for j in range(nt):
                suff = "" if j == 0 else f"_t{j}"
                cal_acc["hist"][j] += res[f"pit_hist{suff}"]
                cal_acc["cov"][j][0.5] += float(res[f"cov_50{suff}"])
                cal_acc["cov"][j][0.9] += float(res[f"cov_90{suff}"])
            cal_acc["cov_n"] += float(res["cov_w"])

    def summarize(d, tag=None):
        w = max(d[3], 1e-8)
        out = {"minADE_px": d[0] / w, "minFDE_px": d[1] / w,
               "top1ADE_px": d[2] / w, "num_agents": d[3]}
        dec = dec_acc.get(tag)
        if dec and dec[2] > 0:
            out["alongADE_px"] = dec[0] / dec[2]
            out["crossADE_px"] = dec[1] / dec[2]
        return out

    result = dict(summarize(acc.get("__all__", [0.0] * 4), "__all__"),
                  K=k_samples or cfg.num_samples)
    sgm = summarize(acc.get("__sgm__", [0.0] * 4))
    result["sgm_minADE_px"] = sgm["minADE_px"]
    result["sgm_minFDE_px"] = sgm["minFDE_px"]
    rank = acc.get("__rank__")
    if rank and rank[3] > 0:
        # chance top-1 percentile = 0.5 - 0.5/K; corr 0 = no ranking signal
        result["rank_top1_pctile"] = rank[0] / rank[3]
        result["rank_score_corr"] = rank[1] / rank[3]
    if speed_bins:
        result["speed_classes"] = {k: summarize(v, k) for k, v in acc.items()
                                   if k.startswith("speed[")}
    if per_scene:
        result["per_scene"] = {
            k: summarize(v) for k, v in acc.items()
            if k not in ("__all__", "__sgm__", "__rank__")
            and not k.startswith("speed[")}
    if horizons:
        result["horizons"] = {}
        for h, d in hor_acc.items():
            if d[4] <= 0:
                continue
            w = d[4]
            result["horizons"][f"{h:.1f}s"] = {
                "minADE_px": d[0] / w, "minFDE_px": d[1] / w,
                "top1ADE_px": d[2] / w, "top1FDE_px": d[3] / w,
                # the DESIRE paper's SDD table is in pixels at 1/5
                # resolution
                "minADE_px_fifth": d[0] / w / 5.0,
                "minFDE_px_fifth": d[1] / w / 5.0,
                "num_agents": w,
            }
    if calibration:
        n = max(cal_acc["cov_n"], 1e-8)

        def cal_stats(j):
            p = cal_acc["hist"][j] / max(cal_acc["hist"][j].sum(), 1e-8)
            # Kolmogorov distance of the PIT's empirical CDF from uniform
            ks = float(np.max(np.abs(np.cumsum(p) - np.linspace(
                1.0 / pit_bins, 1.0, pit_bins))))
            return p, ks

        p0, ks0 = cal_stats(0)
        result["calibration"] = {
            "pit_ks": ks0,
            "coverage_50": cal_acc["cov"][0][0.5] / n,
            "coverage_90": cal_acc["cov"][0][0.9] / n,
            "pit_hist": [float(x) for x in p0],
        }
        if nt > 1:
            p1, ks1 = cal_stats(1)
            t1 = sigma_temps[1]
            result["calibration"].update({
                "sigma_temp": list(t1) if isinstance(t1, (tuple, list))
                else t1,
                "pit_ks_cal": ks1,
                "coverage_50_cal": cal_acc["cov"][1][0.5] / n,
                "coverage_90_cal": cal_acc["cov"][1][0.9] / n,
            })
    return result
