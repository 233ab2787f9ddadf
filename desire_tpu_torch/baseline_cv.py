"""Constant-velocity reference baseline for minADE/minFDE context (the
port's copy of the repository's ``scripts/baseline_cv.py``, on the port's
own config and loader).

Predicts each agent's future as last observed position + mean observed
velocity * t (K=1). Any learned model must beat this; the number
contextualizes eval metrics the way the DESIRE paper's "Linear" baseline
row does.

    python -m desire_tpu_torch.baseline_cv --data_dir DATA [--scenes X]
        [--split heldout|train|all] [--speed_bins 5,15]

Prints one JSON line. numpy only: it needs no device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from desire_tpu_torch.config import add_config_flags, config_from_args
from desire_tpu_torch.data.loader import SDDLoader


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_config_flags(parser)
    parser.add_argument("--max_eval_batches", type=int, default=0)
    parser.add_argument("--speed_bins", type=str, default="",
                        help="comma-separated px/step boundaries — adds an "
                             "observed-speed-class breakdown (matches "
                             "evaluate --speed_bins)")
    parser.add_argument("--split", type=str, default="heldout",
                        choices=("heldout", "train", "all"),
                        help="evaluate on this side of the holdout "
                             "partition (same semantics as evaluate)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    split = None if (args.split == "all" or cfg.holdout == "none") \
        else args.split
    if split == "heldout":
        cfg = cfg.replace(window_hop=cfg.eval_hop)
    loader = SDDLoader(cfg, split=split, drop_remainder=False)
    bins = [float(s) for s in args.speed_bins.split(",") if s.strip()]
    edges = [0.0] + bins + [np.inf]

    to = cfg.obs_len
    sums = np.zeros(3)  # ade, fde, n
    by_speed = {}
    for bi, b in enumerate(loader.epoch_batches(0)):
        if args.max_eval_batches and bi >= args.max_eval_batches:
            break
        obs = b.xy[:, :to]                       # (B, To, A, 2)
        fut = b.xy[:, to:]
        fut_mask = b.mask[:, to:]                # (B, Tf, A)
        live = (b.ids > 0).astype(np.float32)    # (B, A)
        # mean velocity over the observed window (masked steps excluded)
        om = b.mask[:, :to]
        d = np.diff(obs, axis=1) * (om[:, 1:] * om[:, :-1])[..., None]
        steps = np.maximum((om[:, 1:] * om[:, :-1]).sum(1), 1e-6)
        vel = d.sum(1) / steps[..., None]        # (B, A, 2)
        t = np.arange(1, fut.shape[1] + 1, dtype=np.float32)
        pred = obs[:, -1][:, None] + vel[:, None] * t[None, :, None, None]
        err = np.linalg.norm(pred - fut, axis=-1) * fut_mask  # (B, Tf, A)
        err = err * b.scale[:, None, None]
        n_steps = np.maximum(fut_mask.sum(1), 1e-6)           # (B, A)
        ade = err.sum(1) / n_steps
        # fde at the last valid step
        idx = np.argmax(fut_mask * np.arange(1, fut.shape[1] + 1)[None, :,
                                                                 None],
                        axis=1)                               # (B, A)
        fde = np.take_along_axis(err, idx[:, None], axis=1)[:, 0]
        valid = live * (fut_mask.sum(1) > 0)
        sums += [float((ade * valid).sum()), float((fde * valid).sum()),
                 float(valid.sum())]
        if bins:
            speed = np.linalg.norm(vel, axis=-1) * b.scale[:, None]  # px/step
            for lo, hi in zip(edges[:-1], edges[1:]):
                sel = valid * (speed >= lo) * (speed < hi)
                tag = f"speed[{lo:g},{hi:g})px/step"
                d3 = by_speed.setdefault(tag, np.zeros(3))
                d3 += [float((ade * sel).sum()), float((fde * sel).sum()),
                       float(sel.sum())]
    n = max(sums[2], 1e-8)
    out = {"baseline": "constant_velocity",
           "ADE_px": sums[0] / n, "FDE_px": sums[1] / n,
           "num_agents": sums[2]}
    if bins:
        out["speed_classes"] = {
            t: {"ADE_px": v[0] / max(v[2], 1e-8),
                "FDE_px": v[1] / max(v[2], 1e-8), "num_agents": v[2]}
            for t, v in sorted(by_speed.items())}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
