"""The numbers that decide ``correct``: what the timed path answered
against what the reference computes from the same inputs.

Serving (per checked request, the widest over its live agents):

* ``traj_gap``: the largest distance, in scene units, between a refined
  hypothesis position and the reference's;
* ``traj_rms``: the root mean square of that distance over every live
  agent's hypotheses and steps (the bulk of the error, where the largest
  is one outlier);
* ``score_gap``: the largest difference of a hypothesis' IOC score;
* ``pick_gap``: how far the reference's score of the hypothesis the
  program ranked first lies below the reference's best score;
* ``answer_off``: agents whose answer is malformed (ids or liveness other
  than asked, a ranked pick that is none of the agent's hypotheses): an
  exact check, limit 0.

Training (over the first three steps, each by its worst leaf):

* ``loss_gap``: |loss - reference loss| / |reference loss|;
* ``grad_gap``: |norm of a leaf's first gradient as the optimizer got it
  - the reference's| / max(the reference's norm of that leaf, the median
  leaf's);
* ``update_gap``: the same of each leaf's change over the three steps,
  leaves whose reference gradient is under a thousandth of the median
  leaf's left out (they move under Adam by round-off alone);
* ``grad_diff_median``: the median leaf's norm of the difference of the
  first gradients over the larger of the reference leaf's norm and the
  median leaf's (half a batch left out shows here: its gradient is a
  fair sample of the same data, so its norms hardly change).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark_torch.reference import model as ref
from benchmark_torch.reference.params import leaves as _leaves
from benchmark_torch.reference.params import unflatten as _unflatten


def batch_arrays(windows, scale, t_len, a_max, device):
    """Observation windows (raw px) -> the forward's (xy (B, T, A, 2)
    normalized, mask (B, T, A), ids (B, A)) as a server lays them out: the
    future unknown, its mask 1 across the horizon for each agent live at
    the last observed step."""
    b = len(windows)
    to = windows[0][0].shape[1]
    xy = np.zeros((b, t_len, a_max, 2), np.float32)
    mask = np.zeros((b, t_len, a_max), np.float32)
    ids = np.zeros((b, a_max), np.int64)
    for i, (oxy, om, wid) in enumerate(windows):
        na = min(len(wid), a_max)
        xy[i, :to, :na] = np.swapaxes(np.asarray(oxy[:na], np.float32)
                                      / np.float32(scale), 0, 1)
        mask[i, :to, :na] = np.swapaxes(om[:na], 0, 1)
        live = (wid[:na] != 0) & (om[:na, -1] > 0)
        mask[i, to:, :na] = live[None].astype(np.float32)
        ids[i, :na] = wid[:na] * live
    return tuple(torch.as_tensor(x, device=device) for x in (xy, mask, ids))


@torch.no_grad()
def reference_answers(params, cfg, windows, scale, eps, block, prec="f32"):
    """The reference's (refined (B, A, K, Tf, 2), scores (B, A, K), ids
    (B, A)) for a request, ``block`` windows at a time; eps holds the
    request's latent noise, rows window-major."""
    a = cfg["max_num_obj"]
    t_len = cfg["obs_len"] + cfg["pred_len"]
    xy, mask, ids = batch_arrays(windows, scale, t_len, a, eps.device)
    refined, scores = [], []
    for s in range(0, len(windows), block):
        e = min(s + block, len(windows))
        out = ref.forward(params, cfg, xy[s:e], mask[s:e], ids[s:e],
                          eps[s * a:e * a].float(), prec=prec)
        refined.append(out["refined"].cpu())
        scores.append(out["scores"].cpu())
    return (torch.cat(refined).numpy(), torch.cat(scores).numpy(),
            ids.cpu().numpy())


def serving_gaps(answers, refined, scores, ids, scale):
    """The serving numbers of one request: ``answers`` the program's
    per-window dicts (raw px), the rest the reference's."""
    gaps = dict(traj_gap=0.0, score_gap=0.0, pick_gap=0.0, answer_off=0)
    sq, n = 0.0, 0
    for i, ans in enumerate(answers):
        live = ids[i] != 0
        na = len(ans["ids"])
        if (not np.array_equal(ans["ids"], ids[i, :na])
                or not np.array_equal(ans["live"], live[:na])):
            gaps["answer_off"] += int(na)
            continue
        rows = np.flatnonzero(live[:na])
        if not len(rows):
            continue
        traj = np.asarray(ans["traj"], np.float64)[rows] / scale
        rt = refined[i, rows].astype(np.float64)
        d2 = ((traj - rt) ** 2).sum(-1)
        gaps["traj_gap"] = max(gaps["traj_gap"], float(np.sqrt(d2.max())))
        sq += float(d2.sum())
        n += d2.size
        sc = np.asarray(ans["scores"], np.float64)[rows]
        rs = scores[i, rows].astype(np.float64)
        gaps["score_gap"] = max(gaps["score_gap"],
                                float(np.abs(sc - rs).max()))
        best = np.asarray(ans["best"], np.float64)[rows] / scale
        off = np.abs(traj - best[:, None]).max(axis=(-1, -2))  # (A, K)
        pick = off.argmin(axis=-1)
        gaps["answer_off"] += int((off.min(axis=-1) > 0).sum())
        chosen = np.take_along_axis(rs, pick[:, None], axis=-1)[:, 0]
        gaps["pick_gap"] = max(gaps["pick_gap"],
                               float((rs.max(axis=-1) - chosen).max()))
    gaps["traj_rms"] = (sq / n) ** 0.5 if n else 0.0
    return gaps


def as_answers(refined, scores, ids, scale):
    """Reference outputs laid out as a server answers (the control runs
    the reference in the program's place)."""
    out = []
    for i in range(len(ids)):
        sc = scores[i]
        pick = sc.argmax(-1)
        traj = refined[i] * scale
        out.append({"ids": ids[i], "live": ids[i] != 0, "traj": traj,
                    "scores": sc,
                    "best": np.take_along_axis(
                        traj, pick[:, None, None, None], axis=1)[:, 0]})
    return out


def merge(into, gaps):
    """The widest of each number over the checked requests."""
    for k, v in gaps.items():
        into[k] = max(into.get(k, 0), v)
    return into


# -- training ----------------------------------------------------------------

def reference_steps(params0, cfg, batches, noises, steps_per_epoch,
                    prec="f32"):
    """The reference's first steps from params0 on the recorded batches
    and draws: (losses, the first step's clipped gradients, the leaves
    after the last step), leaves in path order."""
    like = params0
    leaves = [x.detach().clone().float() for x in _leaves(params0)]
    mu = [torch.zeros_like(x) for x in leaves]
    nu = [torch.zeros_like(x) for x in leaves]
    losses, g_first = [], None
    for step, ((xy, mask, ids), noise) in enumerate(zip(batches, noises)):
        var = [x.detach().requires_grad_(True) for x in leaves]
        total, _ = ref.loss(_unflatten(like, var), cfg, xy.float(),
                            mask.float(), ids, noise, step, prec=prec)
        grads = torch.autograd.grad(total, var, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, var)]
        with torch.no_grad():
            leaves, mu, nu, clipped = ref.adam_step(
                cfg, [x.detach() for x in var], grads, mu, nu, step,
                steps_per_epoch)
        losses.append(float(total.detach()))
        if g_first is None:
            g_first = clipped
    return losses, g_first, leaves


def training_gaps(prog, refr, params0):
    """prog and refr: (losses, first gradients, leaves after the steps).
    Besides the three numbers: ``loss1_gap`` (the first step's loss
    alone), ``grad_diff_median`` (the median leaf's norm of the first
    gradient's difference from the reference's, over the larger of the
    reference leaf's norm and the median leaf's) and ``left_out`` (leaves
    left out of ``update_gap``)."""
    lp, gp, pp = prog
    lr, gr, pr = refr
    gaps = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(lp, lr)]
    p0 = [x.float() for x in _leaves(params0)]
    gn_r = torch.stack([g.norm() for g in gr])
    gn_p = torch.stack([g.float().norm() for g in gp])
    med = torch.median(gn_r)
    grad = (gn_p - gn_r).abs() / torch.maximum(gn_r, med)
    diff = torch.stack([(a.float() - b).norm() for a, b in zip(gp, gr)]
                       ) / torch.maximum(gn_r, med)
    dn_r = torch.stack([(a - b).norm() for a, b in zip(pr, p0)])
    dn_p = torch.stack([(a.float() - b).norm() for a, b in zip(pp, p0)])
    moved = gn_r >= 1e-3 * med
    dmed = torch.median(dn_r[moved])
    upd = ((dn_p - dn_r).abs() / torch.maximum(dn_r, dmed))[moved]
    return dict(loss_gap=max(gaps), grad_gap=float(grad.max()),
                update_gap=float(upd.max()), loss1_gap=gaps[0],
                grad_diff_median=float(diff.median()),
                left_out=int((~moved).sum()))
