#!/usr/bin/env python3
"""Time the training path of one checkout on the card, at the flagship
training shape (B=64, A=60, K=20, T=12, d=48, G=32, C=32, bf16), CUDA events,
medians:

* ioc: the IOC backward kernel (default and social_freeze) alone;
* pool: the scene-pool gradient, whole and split by the kernels it launches
  (``torch.profiler``'s device time by kernel name), on positions uniform
  in [0.15, 0.85] (as the path's lie) and on ``chip_smoke``'s check inputs
  (a quarter on grid nodes, a quarter outside [0, 1]);
* nll: the NLL forward and backward against their bounds, by CUDA events
  and by their device time (``torch.profiler``);
* steps: the training step with its split (loss forward, backward,
  optimizer and the rest) by default, with social_freeze, fused_train=False
  (with remat off and on) and use_social=False, each timed after WARMUP
  untimed steps of every configuration; then ``torch.profiler`` sums the
  card's busy time over 3 steps of each against their CUDA-event time (the
  card's idle share).

    python3 chip_time_training.py [--root CHECKOUT] [--label LABEL]
        [--parts ioc,pool,nll,steps]

--root names the checkout whose ``desire_tpu_torch`` is timed (default:
the one this file is in); the inputs and timers are those of the
``chip_smoke`` beside this file, whichever checkout is timed. To compare
two versions on one card, unpack the other one beside this (``git
archive``) and run both, one after the other, in alternation: parent,
change, change, parent. Each run builds the kernels of its checkout first.
Needs one CUDA device; imports no JAX.
"""
import argparse
import os
import sys

import numpy as np
import torch

WARMUP = 3  # untimed steps of each configuration before any step is timed


def time_ioc_bwd(cs, tag, cfg, params, rng, dev):
    """The IOC backward kernel alone, default and social_freeze, on the
    training forward's own outputs."""
    from desire_tpu_torch.models.ioc import _DELTA_SCALE
    from desire_tpu_torch.ops import ioc_bwd, ioc_fused
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


def time_pool_bwd(cs, tag, cfg, rng, dev):
    """The scene-pool gradient, whole and split by kernel, on positions
    uniform in [0.15, 0.85] and on chip_smoke's check inputs."""
    from desire_tpu_torch.ops import scene_pool
    b, g, c = cfg.batch_size, cfg.scene_grid, cfg.scene_channels
    p = cfg.max_num_obj * cfg.num_samples * cfg.pred_len
    fm, pos_edge, gct = cs.scene_pool_inputs(b, g, c, p, torch.bfloat16, rng,
                                             dev)
    pos_in = torch.as_tensor(rng.uniform(0.15, 0.85, (b, p, 2)).astype(
        np.float32), device=dev)
    for label, pos in (("uniform [0.15, 0.85]", pos_in),
                       ("check inputs", pos_edge)):
        fn = lambda: scene_pool.scene_pool_bwd_cuda(fm, pos, gct)
        ms = cs.time_ms(fn, repeats=5, iters=5)
        split = cs.device_ms_by_kernel(fn)
        parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
        print(f"{tag}: scene_pool_bwd {label} ms {ms:.4f} (by kernel: "
              f"{parts})", flush=True)


def time_nll(cs, tag, cfg, rng, dev):
    """The NLL forward and backward against their bounds."""
    from desire_tpu_torch.ops import nll
    n = cfg.batch_size * cfg.max_num_obj
    raw5, target, mask = cs.nll_inputs(n, cfg.num_samples, cfg.pred_len, rng,
                                       dev)
    gn = torch.as_tensor(rng.standard_normal((n, cfg.num_samples)).astype(
        np.float32), device=dev)
    for name, fn, bwd in (
            ("nll_fwd", lambda: nll.nll_fwd_cuda(raw5, target, mask), False),
            ("nll_bwd", lambda: nll.nll_bwd_cuda(raw5, target, mask, gn),
             True)):
        for _ in range(200):  # a ~10-25 us kernel: let the clocks settle
            fn()
        ms = cs.time_ms(fn, repeats=5, iters=100)
        dev_ms = sum(cs.device_ms_by_kernel(fn, calls=100).values())
        nb, fl = cs.nll_work(n, cfg.num_samples, cfg.pred_len, backward=bwd)
        print(f"{tag}: {name} ms {ms:.4f}, device time {dev_ms:.4f} (bound "
              f"{cs.bound(nb, fl, 'f32')[0]:.4f})", flush=True)


def time_steps(cs, tag, cfg, params, rng, dev):
    """The training step of each configuration with its split, after a
    warm-up of all of them; then the card's busy time and idle share in
    each."""
    from desire_tpu_torch.train.state import create_train_state
    from desire_tpu_torch.train.trainer import make_train_step
    batch = tuple(torch.as_tensor(x, device=dev)
                  for x in cs.synthetic_batch(cfg, rng))
    runs = []
    for name, c in (("train_step", cfg),
                    ("train_step social_freeze",
                     cs.flagship_cfg(social_freeze=True)),
                    ("train_step fused_train=False",
                     cs.flagship_cfg(fused_train=False)),
                    ("train_step fused_train=False remat=True",
                     cs.flagship_cfg(fused_train=False, remat=True)),
                    ("train_step use_social=False",
                     cs.flagship_cfg(use_social=False))):
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
    # the card's busy time varies far less between runs than the step's
    from desire_tpu_torch import bench
    for name, _, step in runs:
        split, wall = bench.device_time(step, "cuda", calls=3)
        busy = sum(split.values())
        print(f"{tag}: {name} device busy ms {busy:.3f} of {wall:.3f} (idle "
              f"share {1 - busy / wall:.3f})", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="the checkout to time")
    ap.add_argument("--label", default=None, help="printed with every line")
    ap.add_argument("--parts", default="ioc,pool,nll,steps",
                    help="what to time, of ioc (the IOC backward), pool (the "
                    "scene-pool gradient), nll (the NLL forward and "
                    "backward) and steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_time_training: no CUDA device visible", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    import chip_smoke as cs  # this file's own: the same inputs and timers
    sys.path.insert(0, root)
    from desire_tpu_torch.ops import _build
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
    parts = args.parts.split(",")
    if "ioc" in parts:
        time_ioc_bwd(cs, tag, cfg, params, rng, dev)
    if "pool" in parts:
        time_pool_bwd(cs, tag, cfg, rng, dev)
    if "nll" in parts:
        time_nll(cs, tag, cfg, rng, dev)
    if "steps" in parts:
        time_steps(cs, tag, cfg, params, rng, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
