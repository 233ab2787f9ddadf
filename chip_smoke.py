#!/usr/bin/env python3
"""Smoke test of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It imports no JAX. In order, it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels of desire_tpu_torch/csrc with nvcc;
3. holds each kernel against its plain PyTorch version on the card, in
   float32 at a small shape and in bfloat16 at the flagship shape, and the
   whole forward on the card against the plain forward on the CPU;
4. serves three requests of 64 synthetic windows through
   ``serve.Predictor`` at the flagship shape (B=64, A=60, K=20) and checks
   that both kernels were launched by them;
5. times the forward and each kernel against the plain versions (CUDA
   events, after warm-up);
6. prints one JSON line of per-kernel results, then, last, the device line.

Any failure raises, and the script exits non-zero without the device line.
It also exits non-zero when no CUDA device is visible.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances of the kernel-vs-plain comparisons.
# float32: the kernel and the plain version round nothing; they differ only
# in the order of float32 sums and in fused multiply-adds, ~1e-6 relative
# per product, compounded over the GRU steps and refinement passes.
F32_TOL = dict(rtol=2e-4, atol=2e-5)
F32_SCORE_TOL = dict(rtol=2e-4, atol=2e-4)
# bfloat16: both round their operands to bf16 at the same places, but a
# sum taken in another order can land on the other side of a rounding
# boundary, which moves that operand by one bf16 step (2^-8 relative).
# Such flips stay rare and bounded: the GRU state and the sampler outputs
# are tanh-bounded (|h| < 1), positions move by at most 0.1 per pass, and
# a score sums 12 head outputs.
BF16_TOL = {"dec_h": 0.05, "hx": 0.05, "refined": 5e-3, "scores": 0.1}
# mean absolute errors, which catch a systematic fault the max would hide
BF16_MEAN_TOL = {"dec_h": 2e-3, "hx": 2e-3, "refined": 2e-4, "scores": 5e-3}


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def flagship_cfg(**kw):
    from desire_tpu_torch import DesireConfig
    base = dict(batch_size=64, max_num_obj=60, obs_len=8, pred_len=12,
                num_samples=20, d_dim=48, latent_size=128,
                compute_dtype="bfloat16", num_refine=4)
    base.update(kw)
    return DesireConfig(**base)


def small_cfg():
    from desire_tpu_torch import DesireConfig
    return DesireConfig(batch_size=2, max_num_obj=5, obs_len=5, pred_len=6,
                        num_samples=3, d_dim=16, latent_size=8,
                        embedding_size=8, channel_multiplier=10,
                        rnn_size=128, scene_grid=8, scene_channels=8,
                        num_refine=2, compute_dtype="float32")


def make_params(cfg, device, seed=0):
    """Random parameters from the port's own init, with the zero-init heads
    (prior, latent temperature, IOC delta and gate) made non-zero so that no
    branch is trivially zero."""
    from desire_tpu_torch.params import init_desire, to_device
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    p = init_desire(cfg, g, "cpu")

    def rnd(t, s):
        return s * torch.randn(t.shape, generator=g)
    p["sgm"]["prior"]["w"] = rnd(p["sgm"]["prior"]["w"], 0.1)
    p["sgm"]["ztemp_fc2"]["w"] = rnd(p["sgm"]["ztemp_fc2"]["w"], 0.3)
    p["ioc"]["delta"]["w"] = rnd(p["ioc"]["delta"]["w"], 0.3)
    p["ioc"]["gate"]["w"] = rnd(p["ioc"]["gate"]["w"], 0.3)
    return to_device(p, device)


def sampler_inputs(cfg, n, rng, device):
    """Sampler kernel inputs at the shapes the forward gives it."""
    cd = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    to, emb = cfg.obs_len, cfg.embedding_size
    feats = np.maximum(rng.standard_normal((n, to, emb)), 0.0)
    mask = np.ones((n, to), np.float32)
    mask[rng.random(n) < 0.2, :2] = 0.0           # entered late
    rho = np.maximum(rng.standard_normal((n, cfg.d_dim)), 0.0)
    eps = rng.standard_normal((n, cfg.num_samples, cfg.latent_size))
    t = lambda a, dt: torch.as_tensor(np.asarray(a, np.float32)).to(
        device=device, dtype=dt)
    return (t(feats, cd), t(mask, torch.float32), t(rho, torch.float32),
            t(eps, cd))


def ioc_inputs(cfg, b, rng, device):
    """IOC kernel inputs at the shapes the forward gives it."""
    cd = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    a, k, t, d = cfg.max_num_obj, cfg.num_samples, cfg.pred_len, cfg.d_dim
    g, c = cfg.scene_grid, cfg.scene_channels
    traj = rng.uniform(0.2, 0.8, (b, a, k, t, 2))
    dec_h = np.tanh(rng.standard_normal((b, a, k, t, d)))
    fmap = np.maximum(rng.standard_normal((b, g, g, c)), 0.0)
    live = (rng.random((b, a)) > 0.2).astype(np.float32)
    live[:, 0] = 1.0
    live[0, 1:] = 0.0                              # one lone live agent
    fut = np.ones((b, a, t), np.float32) * live[..., None]
    fut[:, :, -1] = 0.0
    f = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x, np.float32)).to(device=device, dtype=dt)
    return f(traj), f(dec_h, cd), f(fmap, cd), f(live), f(fut)


def errors(got, ref):
    diff = (got.float() - ref.float()).abs()
    return float(diff.max()), float(diff.mean())


def check_close(name, got, ref, rtol, atol):
    mx, mean = errors(got, ref)
    rel = mx / max(float(ref.float().abs().max()), 1e-30)
    ok = torch.allclose(got.float(), ref.float(), rtol=rtol, atol=atol)
    print(f"  {name}: max_abs_err={mx:.3e} mean_abs_err={mean:.3e} "
          f"max_rel_to_peak={rel:.3e} (rtol={rtol}, atol={atol}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {mx:.3e})")
    return mx


def check_bf16(name, got, ref):
    mx, mean = errors(got, ref)
    ok = (bool(torch.isfinite(got).all()) and mx <= BF16_TOL[name]
          and mean <= BF16_MEAN_TOL[name])
    print(f"  {name}: max_abs_err={mx:.3e} (<= {BF16_TOL[name]}) "
          f"mean_abs_err={mean:.3e} (<= {BF16_MEAN_TOL[name]}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: bf16 kernel disagrees with its plain "
                             f"version (max {mx:.3e}, mean {mean:.3e})")
    return mx


def time_ms(fn, repeats=5, iters=3):
    """Median over repeats of the mean per-call time in ms of iters calls,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


@contextlib.contextmanager
def plain_ops():
    """Route the model's two kernel call sites to the plain versions (for
    timing the plain forward on the same card)."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.ops import ioc_fused, sgm_fused
    saved = ops.sgm_sample_decode, ops.ioc_refine
    ops.sgm_sample_decode = lambda *a, weights=None, **kw: (
        sgm_fused.sgm_sample_decode_plain(*a, **kw))
    ops.ioc_refine = lambda *a, weights=None, **kw: (
        ioc_fused.ioc_refine_plain(*a, **kw))
    try:
        yield
    finally:
        ops.sgm_sample_decode, ops.ioc_refine = saved


def synthetic_windows(cfg, rng, count):
    """Observation windows in raw pixels (scale 1000 px per unit): straight
    walks with noise, some dead slots (id 0) and some agents that entered
    late (masked first steps)."""
    wins = []
    to = cfg.obs_len
    for _ in range(count):
        na = int(rng.integers(10, cfg.max_num_obj + 1))
        p0 = rng.uniform(100.0, 900.0, (na, 2))
        v = rng.uniform(-12.0, 12.0, (na, 2))
        steps = np.arange(to)[None, :, None]
        oxy = p0[:, None] + v[:, None] * steps + rng.normal(0, 0.5,
                                                            (na, to, 2))
        om = np.ones((na, to), np.float32)
        late = rng.random(na) < 0.2
        om[late, : int(rng.integers(1, to - 1))] = 0.0
        oxy = oxy * om[..., None]
        ids = np.arange(1, na + 1, dtype=np.int64)
        ids[rng.random(na) < 0.1] = 0
        wins.append((oxy.astype(np.float32), om, ids))
    return wins


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from desire_tpu_torch import ops
    from desire_tpu_torch.models.desire import (desire_forward,
                                                pack_kernel_weights)
    from desire_tpu_torch.models.ioc import _DELTA_SCALE
    from desire_tpu_torch.ops import _build, ioc_fused, sgm_fused
    from desire_tpu_torch.params import to_device
    from desire_tpu_torch.serve import Predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}",
          flush=True)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s -> {os.path.relpath(lib_path, ROOT)}",
          flush=True)
    kernel = "?"
    for line in log.splitlines():      # ptxas -v: registers and spills
        m = re.search(r"entry function .*?((?:sgm|ioc)_[a-z]+_kernel)I(\w+?)E",
                      line)
        if m:
            kernel = f"{m.group(1)}<{m.group(2)}>"
        elif "registers" in line or "spill" in line:
            print(f"  {kernel}: {line.split(':', 1)[-1].strip()}", flush=True)
    _build.library()

    rng = np.random.default_rng(0)
    # -- 3a. float32, small shape ---------------------------------------------
    print("compare float32, small shape:", flush=True)
    scfg = small_cfg()
    sp = make_params(scfg, dev)
    n = 7
    args = sampler_inputs(scfg, n, rng, dev)
    got = sgm_fused.sgm_sample_decode_cuda(
        sgm_fused.pack_sampler(sp["sgm"], torch.float32, dev), *args,
        scfg.pred_len)
    ref = sgm_fused.sgm_sample_decode_plain(sp["sgm"], *args, scfg.pred_len,
                                            compute_dtype=torch.float32)
    check_close("sampler dec_h", got[0], ref[0], **F32_TOL)
    check_close("sampler hx", got[1], ref[1], **F32_TOL)
    for freeze in (False, True):
        iargs = ioc_inputs(scfg, 2, rng, dev)
        kw = dict(num_refine=scfg.num_refine, delta_scale=_DELTA_SCALE,
                  social_freeze=freeze)
        got = ioc_fused.ioc_refine_cuda(
            ioc_fused.pack_ioc(sp["ioc"], sp["scf"], torch.float32, dev,
                               scfg.max_num_obj), *iargs, **kw)
        ref = ioc_fused.ioc_refine_plain(sp["ioc"], sp["scf"], *iargs, **kw)
        check_close(f"ioc refined (social_freeze={freeze})", got[0], ref[0],
                    **F32_TOL)
        check_close(f"ioc scores (social_freeze={freeze})", got[1], ref[1],
                    **F32_SCORE_TOL)

    # the whole forward: kernels on the card vs plain versions on the CPU
    print("compare float32 forward, card (kernels) vs CPU (plain):",
          flush=True)
    b, a, t = scfg.batch_size, scfg.max_num_obj, scfg.total_len
    xy = rng.uniform(0.25, 0.75, (b, t, a, 2)).astype(np.float32)
    mask = np.ones((b, t, a), np.float32)
    mask[:, :, -1] = 0.0
    mask[0, 0, 0] = 0.0
    ids = np.tile(np.arange(1, a + 1), (b, 1)).astype(np.int64)
    ids[:, -1] = 0
    eps = rng.standard_normal((b * a, scfg.num_samples,
                               scfg.latent_size)).astype(np.float32)
    outs = {}
    for where in ("cpu", "cuda"):
        p = to_device(sp, where)
        T = lambda x: torch.as_tensor(x, device=where)
        outs[where] = desire_forward(p, scfg, T(xy), T(mask), T(ids),
                                     eps=T(eps))
    for key, tol in (("sgm_traj", F32_TOL), ("refined_traj", F32_TOL),
                     ("scores", F32_SCORE_TOL)):
        check_close(f"forward {key}", outs["cuda"][key].cpu(),
                    outs["cpu"][key], **tol)

    # -- 3b. bfloat16, flagship shape -----------------------------------------
    print("compare bfloat16, flagship shape:", flush=True)
    cfg = flagship_cfg()
    params = make_params(cfg, dev)
    packed = pack_kernel_weights(params, cfg, dev)    # as Predictor does
    n = cfg.batch_size * cfg.max_num_obj
    s_args = sampler_inputs(cfg, n, rng, dev)
    kw_s = dict(compute_dtype=torch.bfloat16)
    got = sgm_fused.sgm_sample_decode_cuda(packed["sgm"], *s_args,
                                           cfg.pred_len)
    ref = sgm_fused.sgm_sample_decode_plain(params["sgm"], *s_args,
                                            cfg.pred_len, **kw_s)
    sgm_err = check_bf16("dec_h", got[0], ref[0])
    check_bf16("hx", got[1], ref[1])
    i_args = ioc_inputs(cfg, cfg.batch_size, rng, dev)
    kw_i = dict(num_refine=cfg.num_refine, delta_scale=_DELTA_SCALE)
    got = ioc_fused.ioc_refine_cuda(packed["ioc"], *i_args, **kw_i)
    ref = ioc_fused.ioc_refine_plain(params["ioc"], params["scf"], *i_args,
                                     **kw_i)
    ioc_err = max(check_bf16("refined", got[0], ref[0]),
                  check_bf16("scores", got[1], ref[1]))
    del got, ref

    # -- 4. serve -------------------------------------------------------------
    print("serve: Predictor at B=64, A=60, K=20, bf16", flush=True)
    pred = Predictor(params, cfg, max_windows=64, device="cuda", seed=0)
    pred.warmup()
    ops.reset_launch_counts()
    n_req, n_win = 3, 64
    for _ in range(n_req):
        wins = synthetic_windows(cfg, rng, n_win)
        res = pred.predict_windows(wins, scales=1000.0)
        if len(res) != n_win:
            raise AssertionError(f"{len(res)} forecasts for {n_win} windows")
        for (oxy, _, wids), r in zip(wins, res):
            na = min(len(wids), cfg.max_num_obj)
            want = {"traj": (na, cfg.num_samples, cfg.pred_len, 2),
                    "scores": (na, cfg.num_samples),
                    "best": (na, cfg.pred_len, 2)}
            for key, shape in want.items():
                if r[key].shape != shape or not np.isfinite(r[key]).all():
                    raise AssertionError(f"{key}: shape {r[key].shape} "
                                         f"(want {shape}) or not finite")
            live = r["live"]
            if live.any():
                # forecasts land near the agents, in input pixels: one step
                # of the velocity envelope plus at most 0.1 units of
                # refinement per pass
                last = oxy[:na][live, -1]
                dist = np.abs(r["best"][live, 0] - last).max()
                if dist > 600.0:
                    raise AssertionError(f"first forecast step {dist:.1f} px"
                                         " from the last observation")
    launches = dict(ops.LAUNCHES)
    print(f"  {n_req} requests x {n_win} windows; launches {launches}; "
          f"stats {pred.stats()}", flush=True)
    for name in ("sgm_sample", "ioc_refine"):
        if launches[name] < n_req:
            raise AssertionError(f"kernel {name} launched {launches[name]} "
                                 f"times for {n_req} requests")

    # -- 5. time --------------------------------------------------------------
    print(f"timing on {smi} (CUDA events, median):", flush=True)
    bx = torch.as_tensor(
        rng.uniform(0.2, 0.8, (cfg.batch_size, cfg.total_len,
                               cfg.max_num_obj, 2)).astype(np.float32),
        device=dev)
    bm = torch.ones(bx.shape[:3], device=dev)
    bids = torch.arange(1, cfg.max_num_obj + 1, device=dev).repeat(
        cfg.batch_size, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def fwd():
        return desire_forward(params, cfg, bx, bm, bids, generator=gen,
                              kernel_weights=packed)

    fwd_ms, fwd_plain_ms = [], []
    for _ in range(2):       # in turns: kernels, plain, kernels, plain
        fwd_ms.append(time_ms(fwd))
        with plain_ops():
            fwd_plain_ms.append(time_ms(fwd))
    fwd_k, fwd_p = statistics.median(fwd_ms), statistics.median(fwd_plain_ms)
    traj_s = cfg.batch_size * cfg.max_num_obj * cfg.num_samples / fwd_k * 1e3
    print(f"forward_ms kernels {fwd_k:.3f} (runs {fwd_ms})", flush=True)
    print(f"forward_ms plain {fwd_p:.3f} (runs {fwd_plain_ms})", flush=True)
    print(f"sampled trajectories/s through the kernels: {traj_s:.0f}",
          flush=True)
    p_s = params["sgm"]
    t_sgm = time_ms(lambda: sgm_fused.sgm_sample_decode_cuda(
        packed["sgm"], *s_args, cfg.pred_len))
    t_sgm_p = time_ms(lambda: sgm_fused.sgm_sample_decode_plain(
        p_s, *s_args, cfg.pred_len, **kw_s))
    t_ioc = time_ms(lambda: ioc_fused.ioc_refine_cuda(
        packed["ioc"], *i_args, **kw_i))
    t_ioc_p = time_ms(lambda: ioc_fused.ioc_refine_plain(
        params["ioc"], params["scf"], *i_args, **kw_i))
    print(f"sgm_sample ms kernel {t_sgm:.3f} plain {t_sgm_p:.3f}", flush=True)
    print(f"ioc_refine ms kernel {t_ioc:.3f} plain {t_ioc_p:.3f}", flush=True)

    # -- 6. results -----------------------------------------------------------
    kernels = [
        {"name": "sgm_sample", "route": "cuda",
         "source": "desire_tpu_torch/csrc/sgm_sample.cu",
         "replaces": "desire_tpu/ops/sgm_fused.py:56",
         "launches": launches["sgm_sample"], "max_abs_err": sgm_err,
         "ms": t_sgm, "plain_ms": t_sgm_p},
        {"name": "ioc_refine", "route": "cuda",
         "source": "desire_tpu_torch/csrc/ioc_refine.cu",
         "replaces": "desire_tpu/ops/ioc_fused.py:244",
         "launches": launches["ioc_refine"], "max_abs_err": ioc_err,
         "ms": t_ioc, "plain_ms": t_ioc_p},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
