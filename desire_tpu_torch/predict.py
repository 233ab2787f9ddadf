"""The forecasting entry point (PyTorch port of the repository's
``predict.py``): observations in, ranked future trajectories out.

File mode forecasts at the trailing edge (or ``--at_step``) of SDD
annotation CSVs, the dataset's transposed 4-row layout:

    python -m desire_tpu_torch.predict --save_dir save/ --csv VIDEO.csv

Stream mode serves a frame feed: one JSON frame a line on stdin
({"frame": N, "agents": [[id, x, y], ...]}, raw pixels), a ``ready`` line,
then one JSON forecast a line on stdout for every frame that is due:

    python -m desire_tpu_torch.predict --save_dir save/ --stream --scale 1409

At exit ``Predictor.stats()`` goes to stderr: the request latencies,
call to return (assembly, copies, forward and answers), and each serving
span's mean ms a call.
``--device cuda`` (the default) needs a CUDA device and raises without
one.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from desire_tpu_torch.data.loader import _native_or_python_reader
from desire_tpu_torch.data.windows import (build_video_index,
                                           materialize_window,
                                           occupancy_prior)
from desire_tpu_torch.serve import Predictor, StreamServer, forecast_to_json


def file_mode(args, pred: Predictor):
    reader = _native_or_python_reader(use_native=True)
    cfg = pred.cfg
    subsample = cfg.subsample if cfg.protocol == "paper" else 1
    for path in args.csv:
        frames, ids, xs, ys = reader(path)
        v = build_video_index(path, frames, ids, np.stack([xs, ys], -1),
                              subsample=subsample, normalize=cfg.normalize)
        # the video's normalization at training time (1.0 for a checkpoint
        # trained on raw pixels)
        scale = v.scale
        # the window ends at --at_step (default the last indexed step)
        at = args.at_step if args.at_step >= 0 else v.num_steps - 1
        start = at - pred.obs_len + 1
        if start < 0:
            print(f"skip {path}: only {at + 1} steps at/<= requested "
                  f"step, need {pred.obs_len}", file=sys.stderr)
            continue
        # observations only: a window of obs_len steps, no future read
        xy, mask, wids = materialize_window(
            v, start, pred.obs_len, pred.obs_len, cfg.max_num_obj,
            require_full_obs=cfg.protocol == "paper")
        scene_img = None
        if cfg.scene_image_channels > 0 and \
                cfg.scene_image_source == "occupancy":
            # the video's raster as the loader builds it for training
            scene_img = occupancy_prior(v, cfg.scene_grid)
        out = pred.predict(np.swapaxes(xy, 0, 1) * scale,
                           np.swapaxes(mask, 0, 1), wids, scale=scale,
                           scene_image=scene_img)
        out["frame"] = at * subsample
        out["step"] = at
        rec = json.loads(forecast_to_json(out, top_k=args.top_k))
        rec["video"] = path
        rec["scale"] = round(float(scale), 2)
        print(json.dumps(rec), flush=True)


def stream_mode(args, pred: Predictor):
    if not args.scale:
        raise SystemExit("--stream requires --scale (the scene's pixels a "
                         "unit that the checkpoint trained with)")
    server = StreamServer(pred, scale=args.scale)
    pred.warmup()
    print(json.dumps({"ready": True, "obs_len": pred.obs_len,
                      "pred_len": pred.pred_len,
                      "subsample": server.subsample}), flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        msg = json.loads(line)
        out = server.observe(msg["frame"], msg.get("agents", ()))
        if out is not None:
            print(forecast_to_json(out, top_k=args.top_k), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save_dir", required=True,
                    help="checkpoint directory (the training --save_dir)")
    ap.add_argument("--csv", nargs="*", default=[],
                    help="SDD annotations_processed.csv file(s) to forecast")
    ap.add_argument("--stream", action="store_true",
                    help="JSON-lines frame feed on stdin -> forecasts on "
                         "stdout")
    ap.add_argument("--at_step", type=int, default=-1,
                    help="sampled step the observation window ends at "
                         "(default: the last)")
    ap.add_argument("--num_samples", type=int, default=0,
                    help="hypotheses K (default: the configuration's)")
    ap.add_argument("--top_k", type=int, default=5,
                    help="hypotheses written per agent, by score (0 = all)")
    ap.add_argument("--scale", type=float, default=0.0,
                    help="pixels a unit (stream mode; file mode derives it "
                         "from the CSV as training did)")
    ap.add_argument("--max_windows", type=int, default=8,
                    help="windows a forward (requests are padded to it)")
    ap.add_argument("--best", type=int, default=0,
                    help="load save_dir/best instead of the latest")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (needs a CUDA device) or cpu")
    args = ap.parse_args(argv)
    if not args.csv and not args.stream:
        raise SystemExit("nothing to do: pass --csv file(s) or --stream")

    pred = Predictor.from_checkpoint(
        args.save_dir, best=bool(args.best), device=args.device,
        k_samples=args.num_samples or None, max_windows=args.max_windows)
    try:
        if args.csv:
            file_mode(args, pred)
        if args.stream:
            stream_mode(args, pred)
    finally:
        print(json.dumps(pred.stats()), file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
