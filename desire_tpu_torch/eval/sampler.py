"""Sampling and the evaluation harness (PyTorch port of
``desire_tpu/eval/sampler.py``).

``make_sampler`` is one ``desire_forward(train=False)`` (through the
serving kernels on CUDA tensors) with the ranked pick and, stochastic, a
draw from the per-step Gaussians; ``make_rollout`` feeds its top pick back
as the next observation window; ``dump_trajectories`` writes its outputs
to an ``.npz``. One eval step is the forward and every per-batch metric,
computed on the params' device and copied to the host in one piece: small
per-agent (B, A) arrays. The host then groups them (scenes, speed
classes, horizons) and sums them in float64, as the JAX package does;
``evaluate``, ``fit_rank_blend`` and ``fit_sigma_temperature`` drive it
over a loader. Every batch's scene raster (``batch.image``) goes to the
forward with it.

The latent noise comes from a ``torch.Generator`` on the params' device,
seeded ``cfg.seed + 1`` for ``evaluate``, ``+ 2`` for
``dump_trajectories``, ``+ 3`` for ``fit_sigma_temperature`` and ``+ 7``
for ``fit_rank_blend`` unless one is given; ``eps`` pins each batch's draws
instead (a sequence of (B*A, K, lat) arrays, one a batch).
"""

from __future__ import annotations

import numpy as np
import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.eval import metrics as M
from desire_tpu_torch.models import desire, losses
from desire_tpu_torch.train.state import tree_leaves
from desire_tpu_torch.train.trainer import (batch_to_device,
                                            make_eval_forward,
                                            stage_to_device)


def _observed_speed_px(obs_xy, obs_mask, scale):
    """Mean observed speed per agent in pixels a step: obs_xy (B, A, To, 2),
    obs_mask (B, A, To), scale (B,) -> (B, A)."""
    both = obs_mask[..., 1:] * obs_mask[..., :-1]
    step = torch.linalg.vector_norm(torch.diff(obs_xy, dim=2), dim=-1)
    return ((step * both).sum(-1) / torch.clamp(both.sum(-1), min=1e-6)
            * scale[:, None])


def _forward(fwd, params, xy, mask, ids, img, eps, generator, z_temp=None):
    """The inference forward ``fwd`` (``make_eval_forward``) in float32:
    (out, traj, scores, gt, step mask, weights). weights: live agents with
    a valid future step, the agents every metric averages over."""
    out = fwd(params, xy, mask, ids, img, eps=eps, generator=generator,
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


def _stage_batch(batch, dev):
    """A loader batch -> (xy, mask, ids, scale, img) on ``dev`` in one
    copy; img the batch's scene raster, None where it has none."""
    arrs = [batch.xy, batch.mask, batch.ids, batch.scale]
    if getattr(batch, "image", None) is not None:
        arrs.append(batch.image)
    staged = stage_to_device(arrs, dev)
    return staged if len(staged) == 5 else staged + (None,)


def make_sampler(cfg: DesireConfig, k_samples=None, stochastic=False):
    """fn(params, xy, mask, ids, img=None, eps=None, draws=None,
    generator=None) -> dict(traj (B, A, K, T, 2), scores (B, A, K), best
    (B, A, T, 2), sgm_traj, raw5, fut_mask, live, fut_xy, obs_xy,
    obs_mask).

    img: the batch's scene raster. The latent noise is eps (B*A, K, lat)
    when given, else drawn from generator. stochastic: every lane's
    positions drawn from its per-step Gaussians, with the IOC refinement's
    deltas laid on the drawn means, from the standard-normal draws (e1,
    e2), each (B, A, K, T), when given, else from generator. Scores are
    zeros without IOC; best ranks with the checkpoint's fitted blend
    (cfg.rank_blend_fit) where it has one."""
    def fn(params, xy, mask, ids, img=None, eps=None, draws=None,
           generator=None):
        out = desire.desire_forward(params, cfg, xy, mask, ids, eps=eps,
                                    generator=generator,
                                    k_samples=k_samples, train=False,
                                    scene_image=img)
        traj = out["refined_traj"]
        if stochastic:
            drawn = losses.sample_bivariate(out["raw5"].float(), draws=draws,
                                            generator=generator)
            traj = traj + (drawn - out["sgm_traj"])
        scores = out["scores"]
        if scores is None:
            scores = torch.zeros(traj.shape[:3], dtype=traj.dtype,
                                 device=traj.device)
        best = M.best_of_k_by_score(traj, scores,
                                    blend=max(cfg.rank_blend_fit, 0.0))
        return {"traj": traj, "scores": scores, "best": best,
                "sgm_traj": out["sgm_traj"], "raw5": out["raw5"],
                "fut_mask": out["fut_mask"], "live": out["live"],
                "fut_xy": out["fut_xy"], "obs_xy": out["obs_xy"],
                "obs_mask": out["obs_mask"]}
    return fn


def make_eval_step(cfg: DesireConfig, k_samples=None, horizon_steps=(),
                   calibration=False, pit_bins=20, rank_blend=0.0,
                   z_temp_fast=1.0, z_temp_px=20.0, sigma_temps=(1.0,)):
    """step(params, xy, mask, ids, scale, img=None, eps=None,
    generator=None) -> {name: numpy array}: the forward and every
    per-batch metric, mostly per-agent (B, A) arrays ("h<i>": (5, B, A),
    minADE, minFDE, top-1 ADE and FDE and coverage at horizon i), with one
    copy to the host.

    z_temp_fast != 1 samples the agents observed at >= z_temp_px pixels a
    step with that latent temperature; sigma_temps: the PIT temperatures of
    the calibration statistics (index 0 the raw report)."""
    fwd = make_eval_forward(cfg, k_samples)

    def step(params, xy, mask, ids, scale, img=None, eps=None,
             generator=None):
        zt = None
        if z_temp_fast != 1.0:
            oxy, _, om, _ = desire.split_batch(cfg, xy.float(), mask.float())
            spd = _observed_speed_px(oxy, om, scale)
            zt = torch.where(spd >= z_temp_px, z_temp_fast, 1.0)
        out, traj, scores, gt, sm, live = _forward(
            fwd, params, xy, mask, ids, img, eps, generator, zt)
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


# the temperature grid of the scalar sigma fit: coverage@50 rises with tau,
# so a coarse grid and linear interpolation pin the root. It reaches down
# to 0.1 because the mixture's coverage flattens toward a floor near 0.51
# as tau -> 0 (the spread between lanes dominates it), and the fit must be
# able to land on that floor or clamp at it.
_FIT_TEMPS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.15,
              1.3, 1.5)

# the (tau_center, tau_tail, w_center) grid of the two-scale fit: each
# lane's CDF becomes w Phi(z / tc) + (1 - w) Phi(z / tt)
# (metrics.pit_values), so (tc, w) govern mostly the 50 % interval and tt
# the 90 % one; w decouples the two levels.
_FIT_PAIR_TC = (0.05, 0.1, 0.2, 0.45)
_FIT_PAIR_TT = (0.6, 0.8, 1.0, 1.3, 1.7)
_FIT_PAIR_W = (0.35, 0.5, 0.65, 0.8)
_FIT_PAIRS = tuple((tc, tt, w) for tc in _FIT_PAIR_TC
                   for tt in _FIT_PAIR_TT for w in _FIT_PAIR_W)


def fit_sigma_temperature(params, cfg: DesireConfig, loader, *,
                          max_batches=40, k_samples=None, generator=None,
                          eps=None, temps=None, target=0.5,
                          two_param=False):
    """The post-hoc sigma temperature, fitted on a train-split slice: the
    central coverage of the K-lane mixture at every candidate temperature
    (one eval step a batch, ``make_eval_step(calibration=True)``).

    Scalar (two_param=False): returns (tau, diagnostics), tau the linearly
    interpolated root of coverage@50(tau) = target after a running max
    over the grid (eval noise can unsort neighbours), clipped to the
    grid's ends. Two-parameter: the grid's (tau_center, tau_tail, w) of
    least (cov@50 - target)^2 + (cov@90 - 0.9)^2. ``evaluate(...,
    sigma_temps=(1.0, tau))`` then reports the corrected coverage
    exactly."""
    dev, generator = _device_and_generator(params, generator, cfg.seed + 3)
    if temps is None:
        temps = _FIT_PAIRS if two_param else _FIT_TEMPS
    step = make_eval_step(cfg, k_samples=k_samples, calibration=True,
                          sigma_temps=tuple(temps))
    cov = np.zeros(len(temps))
    cov90 = np.zeros(len(temps))
    n = 0.0
    for bi, batch in enumerate(loader.epoch_batches(0)):
        if bi >= max_batches:
            break
        xy, mask, ids, scale, img = _stage_batch(batch, dev)
        res = step(params, xy, mask, ids, scale, img,
                   eps=_batch_eps(eps, bi, dev), generator=generator)
        for j in range(len(temps)):
            suff = "" if j == 0 else f"_t{j}"
            cov[j] += float(res[f"cov_50{suff}"])
            cov90[j] += float(res[f"cov_90{suff}"])
        n += float(res["cov_w"])
    cov = cov / max(n, 1e-8)
    cov90 = cov90 / max(n, 1e-8)
    if two_param:
        err = (cov - target) ** 2 + (cov90 - 0.9) ** 2
        j = int(np.argmin(err))
        tau = tuple(float(t) for t in temps[j])
        return tau, {"temps": [list(t) for t in temps],
                     "coverage_50": [float(c) for c in cov],
                     "coverage_90": [float(c) for c in cov90],
                     "fit_weight": float(n)}
    cov_m = np.maximum.accumulate(cov)
    if target <= cov_m[0]:
        tau = temps[0]
    elif target >= cov_m[-1]:
        tau = temps[-1]
    else:
        j = int(np.searchsorted(cov_m, target, side="right")) - 1
        f = (target - cov_m[j]) / max(cov_m[j + 1] - cov_m[j], 1e-8)
        tau = temps[j] + f * (temps[j + 1] - temps[j])
    return float(tau), {"temps": list(temps),
                        "coverage_50": [float(c) for c in cov],
                        "coverage_90": [float(c) for c in cov90],
                        "fit_weight": float(n)}


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
        xy, mask, ids, scale, img = _stage_batch(batch, dev)
        _, traj, scores, gt, sm, live = _forward(
            fwd, params, xy, mask, ids, img, _batch_eps(eps, bi, dev),
            generator)
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
        xy, mask, ids, scale, img = _stage_batch(batch, dev)
        res = step(params, xy, mask, ids, scale, img,
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


def dump_trajectories(params, cfg: DesireConfig, loader, path, *,
                      num_batches=4, k_samples=None, generator=None,
                      eps=None) -> int:
    """Write sampled trajectories of the first num_batches batches of
    epoch 0 to an ``.npz`` at path (``make_sampler``).

    Arrays (N windows): obs_xy (N, A, To, 2), obs_mask (N, A, To), fut_xy
    (N, A, Tf, 2), fut_mask (N, A, Tf), traj (N, A, K, Tf, 2) all K
    refined hypotheses, scores (N, A, K), best (N, A, Tf, 2) the ranked
    pick, live (N, A), video (N,) the loader's video index, scale (N,)
    pixels a unit; every float array as float32 (numpy has no bfloat16).
    Returns the number of windows written."""
    sampler = make_sampler(cfg, k_samples=k_samples)
    dev, generator = _device_and_generator(params, generator, cfg.seed + 2)
    acc: dict = {}
    for bi, batch in enumerate(loader.epoch_batches(0)):
        if bi >= num_batches:
            break
        xy, mask, ids, *img = batch_to_device(batch, dev)
        out = sampler(params, xy, mask, ids, *img,
                      eps=_batch_eps(eps, bi, dev), generator=generator)
        rec = {k: out[k] for k in ("obs_xy", "obs_mask", "fut_xy",
                                   "fut_mask", "traj", "scores", "best",
                                   "live")}
        for k, v in rec.items():
            acc.setdefault(k, []).append(v.float().cpu().numpy())
        acc.setdefault("video", []).append(np.asarray(batch.video))
        acc.setdefault("scale", []).append(np.asarray(batch.scale))
    if not acc:
        return 0
    np.savez_compressed(path, **{k: np.concatenate(v) for k, v in acc.items()})
    return int(sum(a.shape[0] for a in acc["obs_xy"]))


def make_rollout(cfg: DesireConfig, k_samples=None, stochastic=False):
    """Autoregressive long-horizon rollout: predict a pred_len chunk,
    append the top-ranked hypothesis to the observation window, slide it,
    repeat.

    Returns fn(params, obs_xy (B, A, To, 2), obs_mask (B, A, To), ids
    (B, A), num_chunks=1, eps=None, draws=None, generator=None) -> (B, A,
    To + num_chunks * pred_len, 2). Each chunk's window has an empty future
    block whose mask repeats the last observed step's. eps and draws: one
    entry a chunk, each a ``make_sampler`` argument; else every chunk draws
    from generator. As in the JAX package, a model with imagery channels
    rolls out with a zero raster."""
    sampler = make_sampler(cfg, k_samples=k_samples, stochastic=stochastic)

    def fn(params, obs_xy, obs_mask, ids, num_chunks=1, eps=None,
           draws=None, generator=None):
        b, a, to, _ = obs_xy.shape
        tf_len = cfg.pred_len
        out = [obs_xy]
        cur_xy, cur_mask = obs_xy, obs_mask
        for c in range(num_chunks):
            last = cur_mask[:, :, -1:].expand(b, a, tf_len)
            xy = torch.cat([cur_xy.transpose(1, 2),
                            cur_xy.new_zeros((b, tf_len, a, 2))], dim=1)
            mask = torch.cat([cur_mask.transpose(1, 2),
                              last.transpose(1, 2)], dim=1)
            res = sampler(params, xy, mask, ids,
                          eps=None if eps is None else eps[c],
                          draws=None if draws is None else draws[c],
                          generator=generator)
            best = res["best"].to(cur_xy.dtype)            # (B, A, Tf, 2)
            out.append(best)
            cur_xy = torch.cat([cur_xy, best], dim=2)[:, :, -to:]
            cur_mask = torch.cat([cur_mask, last], dim=2)[:, :, -to:]
        return torch.cat(out, dim=2)
    return fn
