#!/usr/bin/env python3
"""Time the serving path of one checkout on the card: the sampler kernel
alone, the IOC refine kernel alone (serving, and with every pass's
positions as the training forward asks), the whole forward
(``desire_forward``, train=False) with its device time by kernel and the
card's idle share (``torch.profiler``), and the request latency of
``serve.Predictor`` (64 windows a request, host clock, p50), all at the
flagship shape (B=64, A=60, K=20, T=12, d=48, G=32, C=32, bf16); kernels and
forward by CUDA events, medians.

    python3 chip_time_serving.py [--root CHECKOUT] [--label LABEL]

--root names the checkout whose ``desire_tpu_torch`` and ``chip_smoke`` are
timed (default: the one this file is in). To compare two versions on one
card, unpack the other one beside this (``git archive``) and run both, one
after the other, in alternation: parent, change, change, parent. Each run
builds the kernels of its checkout first. Needs one CUDA device; imports no
JAX.
"""
import argparse
import os
import sys

import numpy as np
import torch

REQUESTS = 20  # timed Predictor requests

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="the checkout to time")
    ap.add_argument("--label", default=None, help="printed with every line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_time_serving: no CUDA device visible", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from desire_tpu_torch import bench
    from desire_tpu_torch.models.desire import (desire_forward,
                                                pack_kernel_weights)
    from desire_tpu_torch.models.ioc import _DELTA_SCALE
    from desire_tpu_torch.ops import _build, ioc_fused, sgm_fused
    from desire_tpu_torch.serve import Predictor
    if not os.path.abspath(_build.__file__).startswith(root + os.sep):
        raise RuntimeError(f"desire_tpu_torch was not imported from {root}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = args.label or os.path.basename(root)
    dev = torch.device("cuda", 0)
    print(f"{tag}: {cs.nvidia_smi_line()}", flush=True)
    _build.library()
    rng = np.random.default_rng(0)
    cfg = cs.flagship_cfg()
    params = cs.make_params(cfg, dev)
    packed = pack_kernel_weights(params, cfg, dev)

    n = cfg.batch_size * cfg.max_num_obj
    s_args = cs.sampler_inputs(cfg, n, rng, dev)
    ms = cs.time_ms(lambda: sgm_fused.sgm_sample_decode_cuda(
        packed["sgm"], *s_args, cfg.pred_len), repeats=7, iters=5)
    print(f"{tag}: sgm_sample ms {ms:.3f}", flush=True)
    del s_args
    i_args = cs.ioc_inputs(cfg, cfg.batch_size, rng, dev)
    for ci in (False, True):
        kw = dict(num_refine=cfg.num_refine, delta_scale=_DELTA_SCALE,
                  collect_iters=ci)
        ms = cs.time_ms(lambda: ioc_fused.ioc_refine_cuda(
            packed["ioc"], *i_args, **kw), repeats=7, iters=3)
        print(f"{tag}: ioc_refine collect_iters={ci} ms {ms:.3f}", flush=True)
    del i_args

    bx, bm, bids = cs.flagship_windows(cfg, rng, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ms = cs.time_ms(lambda: desire_forward(params, cfg, bx, bm, bids,
                                           generator=gen,
                                           kernel_weights=packed),
                    repeats=7, iters=3)
    print(f"{tag}: forward ms {ms:.3f}", flush=True)
    # where a forward's device time goes, and the share of it the card
    # idles: torch.profiler's device time by kernel over 3 forwards, against
    # their CUDA-event time
    split, wall = bench.device_time(
        lambda: desire_forward(params, cfg, bx, bm, bids, generator=gen,
                               kernel_weights=packed), "cuda", calls=3)
    by_name = sorted(((t, k) for k, t in split.items()), reverse=True)
    busy = sum(t for t, _ in by_name)
    print(f"{tag}: forward device busy ms {busy:.3f} of {wall:.3f} (idle "
          f"share {1 - busy / wall:.3f}); by kernel: "
          + "; ".join(f"{k[:40]} {t:.3f}" for t, k in by_name[:6]),
          flush=True)

    pred = Predictor(params, cfg, max_windows=64, device="cuda", seed=0)
    pred.warmup()
    wins = [cs.synthetic_windows(cfg, rng, 64) for _ in range(REQUESTS)]
    for w in wins:
        pred.predict_windows(w, scales=1000.0)
    st = pred.stats()
    print(f"{tag}: predictor p50 ms {st['latency_ms_p50']:.3f} p95 "
          f"{st['latency_ms_p95']:.3f} (requests {st['calls']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
