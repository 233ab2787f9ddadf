"""The evaluation entry point (PyTorch port of the repository's
``evaluate.py``): best-of-K minADE/minFDE in pixels, the IOC top-1
metrics, the per-horizon table, calibration of the Gaussian heads, and
trajectory dumps, over the SDD loader's held-out split.

    python -m desire_tpu_torch.evaluate --save_dir save/ --data_dir DATA \\
        --best 1 --horizons 1,2,3,4 --calibration 1      # on the card
    python -m desire_tpu_torch.evaluate --device cpu --random_params 1 ...

Prints a JSON header line (split, videos, windows, window hop), a line
for ``--dump``, and last one sorted JSON line of results. ``--device cuda``
(the default) needs a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from desire_tpu_torch.config import (DesireConfig, add_config_flags,
                                     config_from_args)
from desire_tpu_torch.data.loader import SDDLoader
from desire_tpu_torch.eval.sampler import (dump_trajectories, evaluate,
                                           fit_sigma_temperature)
from desire_tpu_torch.params import init_desire, require_device, to_device
from desire_tpu_torch.train import checkpoint as ckpt_mod


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_flags(parser)
    # the geometry comes from the checkpoint's config unless a flag sets
    # it: a None default tells an explicit flag (even one equal to the
    # dataclass default) from an absent one
    parser.set_defaults(**{f: None for f in ckpt_mod.GEOMETRY_FIELDS})
    parser.add_argument("--split", type=str, default="heldout",
                        choices=("heldout", "train", "all"),
                        help="the side of the holdout partition to evaluate "
                             "('all', or holdout='none': every video)")
    parser.add_argument("--max_eval_batches", type=int, default=0,
                        help="0 = the whole epoch")
    parser.add_argument("--random_params", type=int, default=0,
                        help="skip the checkpoint (random params, a smoke "
                             "run)")
    parser.add_argument("--rank_blend", type=float, default=None,
                        help="top-1 pick: z(IOC score) + blend * z(lane "
                             "typicality); default the checkpoint's fitted "
                             "blend (rank_blend_fit), else 0")
    parser.add_argument("--z_temp_fast", type=float, default=1.0,
                        help="latent temperature of the agents observed "
                             "faster than --z_temp_px (1 = off)")
    parser.add_argument("--z_temp_px", type=float, default=20.0,
                        help="observed speed (px/step) from which "
                             "--z_temp_fast applies")
    parser.add_argument("--best", type=int, default=0,
                        help="load <save_dir>/best (the best checkpoint by "
                             "held-out minADE) instead of the latest")
    parser.add_argument("--per_scene", type=int, default=0,
                        help="add a per-scene breakdown")
    parser.add_argument("--horizons", type=str, default="",
                        help="comma-separated horizons in seconds, e.g. "
                             "'1,2,3,4': the paper's SDD table")
    parser.add_argument("--calibration", type=int, default=0,
                        help="add PIT and coverage statistics of the "
                             "Gaussian heads")
    parser.add_argument("--calib_fit_batches", type=int, default=40,
                        help="with --calibration: fit a sigma temperature "
                             "on this many train-split batches and report "
                             "the corrected coverage too (0 = no fit)")
    parser.add_argument("--calib_two_param", type=int, default=1,
                        help="fit the two-scale (tau_center, tau_tail, w) "
                             "temperature instead of the scalar one")
    parser.add_argument("--speed_bins", type=str, default="",
                        help="comma-separated px/step boundaries, e.g. "
                             "'2,8,20': a breakdown by observed speed")
    parser.add_argument("--dump", type=str, default="",
                        help="write sampled trajectories to this .npz")
    parser.add_argument("--dump_batches", type=int, default=4,
                        help="batches to dump")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (needs a CUDA device) or cpu")
    args = parser.parse_args(argv)
    device = require_device(args.device)

    explicit = {f: getattr(args, f) for f in ckpt_mod.GEOMETRY_FIELDS
                if getattr(args, f) is not None}
    for f in ckpt_mod.GEOMETRY_FIELDS:
        setattr(args, f, explicit.get(f, getattr(DesireConfig, f)))
    cfg = config_from_args(args)
    saved_cfg = None
    if cfg.save_dir:
        if args.best:
            # best/ carries its own config, with the fitted rank blend
            saved_cfg = ckpt_mod.load_config(
                os.path.join(cfg.save_dir, "best"))
        if saved_cfg is None:
            saved_cfg = ckpt_mod.load_config(cfg.save_dir)
    if saved_cfg is not None and not args.random_params:
        cfg = ckpt_mod.overlay_geometry(cfg, saved_cfg, skip=explicit)

    split = None if (args.split == "all" or cfg.holdout == "none") \
        else args.split
    if split == "heldout":
        # the held-out split uses the wider eval hop unless window_hop was
        # set on the command line
        given = argv if argv is not None else sys.argv[1:]
        passed = {a.split("=")[0].lstrip("-") for a in given}
        if "window_hop" not in passed:
            cfg = cfg.replace(window_hop=cfg.eval_hop)
    loader = SDDLoader(cfg, split=split, drop_remainder=False)
    print(json.dumps({"split": args.split if split else "all",
                      "videos": [v.name for v in loader.videos],
                      "windows": loader.num_windows,
                      "window_hop": cfg.window_hop}), flush=True)
    if args.random_params:
        params = to_device(init_desire(
            cfg, torch.Generator().manual_seed(cfg.seed), "cpu"), device)
    else:
        ckpt_dir = (os.path.join(cfg.save_dir, "best") if args.best
                    else cfg.save_dir)
        try:
            params = ckpt_mod.restore_params(ckpt_dir, cfg, device)
        except FileNotFoundError as e:
            raise SystemExit(str(e))

    if args.dump:
        n = dump_trajectories(params, cfg, loader, args.dump,
                              num_batches=args.dump_batches)
        print(json.dumps({"dumped": args.dump, "windows": n}), flush=True)

    horizons = tuple(float(h) for h in args.horizons.split(",") if h.strip())
    speed_bins = tuple(float(s) for s in args.speed_bins.split(",")
                       if s.strip())
    sigma_temps = (1.0,)
    fit_diag = None
    if args.calibration and args.calib_fit_batches > 0:
        # the post-hoc sigma temperature, fitted on train videos (never the
        # split reported), then the exact coverage at it beside the raw
        if cfg.holdout == "none":
            fit_diag = {"skipped": "holdout='none': no disjoint fit split"}
        else:
            fit_loader = loader if split == "train" else SDDLoader(
                cfg, split="train", drop_remainder=False)
            tau, fit_diag = fit_sigma_temperature(
                params, cfg, fit_loader, max_batches=args.calib_fit_batches,
                two_param=bool(args.calib_two_param))
            sigma_temps = (1.0, tau)

    rank_blend = (args.rank_blend if args.rank_blend is not None
                  else max(cfg.rank_blend_fit, 0.0))
    result = evaluate(params, cfg, loader,
                      max_batches=args.max_eval_batches or None,
                      per_scene=bool(args.per_scene),
                      horizons=horizons or None,
                      calibration=bool(args.calibration),
                      speed_bins=speed_bins or None,
                      rank_blend=rank_blend,
                      z_temp_fast=args.z_temp_fast,
                      z_temp_px=args.z_temp_px,
                      sigma_temps=sigma_temps)
    if fit_diag is not None:
        result.setdefault("calibration", {})["sigma_fit"] = fit_diag
    if rank_blend:
        result["rank_blend"] = rank_blend
    if args.z_temp_fast != 1.0:
        result["z_temp"] = {"fast": args.z_temp_fast, "px": args.z_temp_px}
    print(json.dumps(result, sort_keys=True), flush=True)
    return result


if __name__ == "__main__":
    main()
