"""Serving latency through the whole request path (PyTorch port of the
repository's ``scripts/bench_serve.py``): the host's window assembly and
padding, the copies to the device, the forward (SGM draw and IOC
rank-and-refine) and the copies of the ranked trajectories back.

    python -m desire_tpu_torch.bench_serve --random_params 1   # on the card
    python -m desire_tpu_torch.bench_serve --save_dir save/ --max_windows 64

Prints one JSON line: the p50 and p95 request latency (host clock) and the
throughput, over synthetic windows drawn from ``RandomState(0)`` (A=60
straight walks, 8 observed steps). ``--device cuda`` (the default) needs a
CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.params import init_desire
from desire_tpu_torch.serve import Predictor


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save_dir", default="")
    ap.add_argument("--random_params", type=int, default=0)
    ap.add_argument("--num_samples", type=int, default=20)
    ap.add_argument("--max_windows", type=int, default=8)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--agents", type=int, default=60)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (needs a CUDA device) or cpu")
    args = ap.parse_args(argv)

    if args.random_params or not args.save_dir:
        cfg = DesireConfig(max_num_obj=args.agents)
        params = init_desire(cfg, torch.Generator().manual_seed(0), "cpu")
        pred = Predictor(params, cfg, device=args.device,
                         k_samples=args.num_samples,
                         max_windows=args.max_windows)
    else:
        pred = Predictor.from_checkpoint(
            args.save_dir, device=args.device, k_samples=args.num_samples,
            max_windows=args.max_windows)
    pred.warmup()

    rng = np.random.RandomState(0)
    to, a = pred.obs_len, pred.cfg.max_num_obj
    windows = []
    for _ in range(args.max_windows):
        p0 = rng.uniform(100, 900, (a, 2)).astype(np.float32)
        v = rng.uniform(-40, 40, (a, 2)).astype(np.float32)
        t = np.arange(to, dtype=np.float32)[None, :, None]
        windows.append((p0[:, None] + v[:, None] * t,
                        np.ones((a, to), np.float32),
                        np.arange(1, a + 1, dtype=np.int64)))
    for _ in range(args.iters):
        pred.predict_windows(windows, scales=1000.0)
    s = pred.stats()
    # the line keeps scripts/bench_serve.py's keys
    s.pop("span_ms")
    s.update(metric="serve_latency", unit="ms/dispatch",
             windows_per_dispatch=args.max_windows,
             agents=a, k=pred.k,
             agent_forecasts_per_sec=round(s["windows_per_sec"] * a))
    print(json.dumps(s), flush=True)
    return s


if __name__ == "__main__":
    main()
