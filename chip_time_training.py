#!/usr/bin/env python3
"""Time the training path of one checkout on the card: the IOC backward
kernel (default and social_freeze) alone, and the training step with its
split (loss forward, backward, optimizer and the rest), both at the flagship
training shape (B=64, A=60, K=20, T=12, d=48, G=32, C=32, bf16), CUDA events,
medians. The steps are timed after WARMUP untimed steps of each
configuration; then ``torch.profiler`` sums the card's busy time over 3
default steps against their CUDA-event time (the card's idle share).

    python3 chip_time_training.py [--root CHECKOUT] [--label LABEL]

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

WARMUP = 3  # untimed steps of each configuration before any step is timed


def busy_ms(fn, calls=3):
    """(card busy ms, CUDA-event ms) per call of fn, over `calls` calls:
    torch.profiler's device time of every kernel and copy against the
    events' span."""
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3 / calls, start.elapsed_time(end) / calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="the checkout to time")
    ap.add_argument("--label", default=None, help="printed with every line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_time_training: no CUDA device visible", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from desire_tpu_torch.models.ioc import _DELTA_SCALE
    from desire_tpu_torch.ops import _build, ioc_bwd, ioc_fused
    from desire_tpu_torch.train.state import create_train_state
    from desire_tpu_torch.train.trainer import make_train_step
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

    # the backward kernel alone, on the training forward's own outputs
    traj, dec_h, fmap, live, fut = (x.detach() for x in cs.ioc_train_args(
        cfg, cfg.batch_size, rng, dev))
    w = ioc_fused.pack_ioc(params["ioc"], params["scf"], torch.bfloat16, dev,
                           cfg.max_num_obj)
    msg = ioc_bwd.social_messages(params["scf"], dec_h).contiguous()
    for freeze in (False, True):
        kw = dict(num_refine=cfg.num_refine, delta_scale=_DELTA_SCALE,
                  social_freeze=freeze)
        refined, scores, iters = ioc_fused.ioc_refine_cuda(
            w, traj, dec_h, fmap, live, fut, collect_iters=True, **kw)
        cts = [torch.as_tensor(rng.standard_normal(x.shape).astype(
            np.float32), device=dev) for x in (refined, scores, iters)]
        ms = cs.time_ms(lambda: ioc_bwd.ioc_refine_bwd_cuda(
            params["ioc"], params["scf"], traj, dec_h, msg, fmap, live, fut,
            iters, *cts, **kw), repeats=5, iters=2)
        print(f"{tag}: ioc_refine_bwd social_freeze={freeze} ms {ms:.3f}",
              flush=True)
        del refined, scores, iters, cts

    # the training step and its split, after a warm-up of both
    # configurations
    batch = tuple(torch.as_tensor(x, device=dev)
                  for x in cs.synthetic_batch(cfg, rng))
    runs = []
    for name, c in (("train_step", cfg),
                    ("train_step social_freeze",
                     cs.flagship_cfg(social_freeze=True))):
        state = create_train_state(c, params, seed=0)
        step_fn = make_train_step(c, steps_per_epoch=190)
        runs.append((name, c, lambda s=state, f=step_fn: f(s, *batch)))
    for _, _, step in runs:
        for _ in range(WARMUP):
            step()
    torch.cuda.synchronize()
    for name, c, step in runs:
        ms = cs.time_ms(step, repeats=5, iters=2)
        print(f"{tag}: {name} ms {ms:.3f}", flush=True)
        cs.step_split(f"{tag}: {name}", c, params, batch, ms)
    busy, wall = busy_ms(runs[0][2])
    print(f"{tag}: train_step device busy ms {busy:.3f} of {wall:.3f} (idle "
          f"share {1 - busy / wall:.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
