#!/usr/bin/env python3
"""Smoke test of the PyTorch port's serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It imports no JAX. In order, it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels of desire_tpu_torch/csrc with nvcc;
3. holds each serving kernel against its plain PyTorch version on the card,
   in float32 at a small shape and in bfloat16 at the flagship shape, at
   K = 50 (B = 16) and, for the IOC kernel, at A = 128 (B = 64: one lane a
   block, against the plain bf16 and float32 versions, with a planted
   one-lane fault that must fail), and the whole forward on the card
   against the plain forward on the CPU;
4. serves three requests of 64 synthetic windows through
   ``serve.Predictor`` at the flagship shape (B=64, A=60, K=20) and checks
   that both serving kernels were launched by them;
5. times the forward and each serving kernel against the plain versions
   (CUDA events, after warm-up);
6. training: holds the four training kernels (the IOC training forward and
   backward, the NLL forward and backward) against their plain versions,
   in float32 at a small shape and in bfloat16 at the flagship shape
   (gradients leaf by leaf), checks that the IOC backward is bitwise
   deterministic, holds one whole float32 training step on the card
   against the plain step on the CPU, takes five ``run_epoch`` steps at the
   flagship training shape and checks that every training kernel was
   launched by them (the two optimizer kernels once a step), and times the
   step and each kernel against the plain versions; all of it also with
   social_freeze (the IOC backward's frozen-attention variant), three
   steps; holds the optimizer kernels (the gradients' global norm, the
   clip and Adam over the whole tree) against their plain version at the
   flagship's tree, clipped and not, and checks that an update runs
   nothing else on the card (no copy);
7. the layer-by-layer IOC path (use_social=False, fused_train=False):
   holds the scene-pool kernels against their plain versions (float32 and
   bfloat16 at small shapes with edge positions, channel counts that take
   the forward's vector path and its channel loop, a 27 x 27 grid,
   thousands of points piled into single buckets, bfloat16 at the flagship
   with edge positions and with piles, and at K = 50), the float32
   forward with use_social=False and one float32 step with
   fused_train=False on the card against the CPU, serves three
   requests with use_social=False, takes three run_epoch steps with
   fused_train=False (remat off and on: same losses, peak memory) and with
   use_social=False, checks that the scene-pool kernels were launched by
   them, and times the kernels against their plain versions and
   grid_sample (the gradient also split by the kernels it launches), the
   serving forward and the training steps;
8. the training entry point (``python -m desire_tpu_torch.train``'s
   ``train.run.train``) on a synthetic SDD tree made from the seed (2
   scenes of 2 videos, 3600 frames, ~60 agents a frame) at the flagship
   width: 2 epochs of 4 batches with the held-out evaluation, checkpoints,
   the best checkpoint and its final selection, the rank-blend fit; checks
   that the training and serving kernels were launched by it, holds the
   short last held-out batch through the serving kernels against their
   plain versions (each kernel call of its bf16 forward, as ``evaluate``
   runs it, on the inputs that call was given; its float32 forward whole),
   resumes a run stopped after 2 batches and holds it bit for bit against
   an uninterrupted one (deterministic algorithms, in a process of its own
   started with cuBLAS's deterministic workspace), serves
   64 windows from the best checkpoint, and times the step through the
   entry point, the loader, a checkpoint save and an eval batch;
9. evaluation and forecasting on phase 8's tree and best checkpoint:
   ``python -m desire_tpu_torch.evaluate`` with the calibration fit,
   horizons and a dump, in a process of its own (exit 0, the JAX script's
   result keys, finite values, the dump's shapes) and in this one;
   ``predict`` in file mode over the tree's CSVs and in stream mode over
   a video's frames (the JAX server's schedule); a two-chunk
   ``make_rollout`` on a held-out batch; ``bench_serve`` at 64 windows;
   the imagery raster (scene_image_channels=1, the loader's occupancy
   rasters) through a bf16 serving forward and a float32 forward and
   training step; every serving kernel call of these paths, recorded, is
   held against its plain version on the inputs it was given, and the
   float32 forward and step against the plain ones; then times them;
10. the ``(data, k)`` mesh on the one card: 4 ranks on cuda:0 joined by
   gloo (``parallel/mesh.py``), each loading the library phase 2 built,
   run the bf16 serving forward under (2, 1), (1, 2) and (2, 2) meshes,
   each rank's kernel calls held against their plain versions and the
   gathered outputs against the unsharded forward on the same inputs and
   eps; 3 data-parallel ``run_epoch`` steps at B = 64 on a (2, 1) mesh
   against the unsharded steps from the same state (losses and gradient
   norms, the ranks' params bitwise equal, rank 0 alone checkpointing),
   one float32 (2, 1) step against the plain unsharded step on the CPU;
   lane-parallel training (the IOC on a rank's block of the lanes): 3
   ``run_epoch`` steps at B = 64 on (1, 2) and on (2, 2) against the
   unsharded steps (losses, gradient norms, the ranks' params bitwise
   equal, rank 0 alone checkpointing), each rank's IOC training and NLL
   calls held against their plain versions, one social_freeze step on
   (2, 2), one fused_train=False step on (1, 2) (the scene-pool kernels
   per rank), one float32 (2, 2) step against the plain unsharded step on
   the CPU; then a one-rank NCCL group all-reduces on the card;
11. a model with the deconv mask decoder (vae_dec='conv') at the flagship
   width: ``deconv2d`` at each layer of the stack and the decoder on the
   card against the CPU (float32), the float32 forward at a small shape
   against the plain forward on the CPU, three bf16 ``Predictor``
   requests of 64 windows (every IOC call held against plain; the IOC
   kernel launched, the sampler not: it needs the MLP decoder), two
   ``run_epoch`` steps with remat off and on (the same losses, peak
   memory, step time); the reference facade ``compat.DESIREModel`` on the
   card: 3 ``train_step`` calls at the reference layout and one
   ``sample(num=12)`` (its kernel calls held against plain, the output's
   shape and finiteness);
12. the headline bench and the constant-velocity baseline: ``python -m
   desire_tpu_torch.bench`` in a process of its own (exit 0, one line
   with its keys, finite values, value = B*A*K / fwd_ms, MFU in (0, 1]);
   ``bench``, ``bench_train`` and ``breakdown`` in this one at fewer calls,
   which must launch the sampler, IOC refine, IOC training forward and
   backward and NLL kernels; one forward of each of the stage sweep's
   sgm_only, sgm_scf (one refine pass), full_K12 and full_K50 with every
   kernel call held against its plain version; ``model_flops`` the same on
   the card and on the CPU; ``python -m desire_tpu_torch.baseline_cv`` on
   phase 8's tree, in this process and in its own, the same line;
13. prints one JSON line of per-kernel results (launches of phases 4, 6,
   7, 9, 10, 11 and 12), then, last, the device line.

Any failure raises, and the script exits non-zero without the device line.
It also exits non-zero when no CUDA device is visible.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# bf16 IOC outputs on the model's own inputs (a training step's, a conv
# model's requests: phases 10-11), where BF16_TOL's random inputs are left
# behind: the scores reach |s| ~ 20, where one bf16 step is 0.125, and
# rounding flips compound over 4 passes x 12 GRU steps. Read on the card
# (NVIDIA H100 80GB HBM3, 700.00 W): the kernel's largest distance from
# plain over the sound calls 9.1e-3 (refined) and 0.37 (scores), the
# smallest that bf16 tells from that noise among the planted faults
# (ioc_faults_caught) 0.11 and 4.0; each limit lies near the geometric
# mean of the two. One lane's lost load (8e-3-0.07, 0.1-0.4) lies inside
# the noise: the float32 kernel on the same inputs, within phase 6's
# float32 tolerances, catches it (check_ioc_path_call). The means keep
# BF16_MEAN_TOL.
PATH_BF16_TOL = {"refined": 0.03, "scores": 1.2}


def release_card():
    """Give the memory this process keeps cached back to the card before a
    process of its own shares it: a graphed training step's memory pool
    stays cached after its step function goes until empty_cache."""
    gc.collect()
    torch.cuda.empty_cache()


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def flagship_cfg(**kw):
    """The bench's flagship configuration (bench.flagship_cfg, social_freeze
    off whatever the environment says) with kw's overrides."""
    from desire_tpu_torch import bench
    return bench.flagship_cfg().replace(**{"social_freeze": False, **kw})


def small_cfg(**kw):
    from desire_tpu_torch import DesireConfig
    base = dict(batch_size=2, max_num_obj=5, obs_len=5, pred_len=6,
                num_samples=3, d_dim=16, latent_size=8, embedding_size=8,
                channel_multiplier=10, rnn_size=128, scene_grid=8,
                scene_channels=8, num_refine=2, compute_dtype="float32")
    base.update(kw)
    return DesireConfig(**base)


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
    if "ioc" in p:                                 # cfg.use_ioc
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


def check_bf16(name, got, ref, verbose=True, tol=BF16_TOL):
    """A bf16 kernel output against its plain version's: the max abs error
    within tol[name], the mean within BF16_MEAN_TOL[name]. Returns the
    max."""
    mx, mean = errors(got, ref)
    ok = (bool(torch.isfinite(got).all()) and mx <= tol[name]
          and mean <= BF16_MEAN_TOL[name])
    if verbose or not ok:
        print(f"  {name}: max_abs_err={mx:.3e} (<= {tol[name]}) "
              f"mean_abs_err={mean:.3e} (<= {BF16_MEAN_TOL[name]}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: bf16 kernel disagrees with its plain "
                             f"version (max {mx:.3e}, mean {mean:.3e})")
    return mx


def check_crowd_ioc(params, cfg, w, rng, device, kw):
    """The bf16 IOC kernel past 64 agents a lane (cfg.max_num_obj, the
    tensor-core path with one lane a block) against the plain version:
    within BF16_TOL and BF16_MEAN_TOL of the plain bf16 computation (float32
    accumulation), plain and under social_freeze (its ring of one step
    tile), and, plain, max only, within PATH_BF16_TOL of the float32 one
    (every operand unrounded: the means of bf16's rounding lie past
    BF16_MEAN_TOL there at any agent count). A planted fault, lane 0 of a
    batch row reading lane 1's last agent tile of dec_h (one lane's
    producer loading another lane's rows), has to fail the bf16 check.
    Returns the largest bf16 max abs error."""
    from desire_tpu_torch.ops import ioc_fused
    a, names = cfg.max_num_obj, ("refined", "scores")
    block = ioc_fused.tc_block_shape(a, cfg.num_samples, cfg.pred_len,
                                     cfg.d_dim, cfg.scene_channels)
    if not w.use_mma or block is None:
        raise AssertionError(f"{a} agents did not take the tensor-core path")
    print(f"  tensor-core block at {a} agents: {block[0]} lane(s), "
          f"{block[1]} step tile(s), {block[2]} B of shared memory",
          flush=True)
    data = ioc_inputs(cfg, cfg.batch_size, rng, device)

    def against_plain(**extra):
        got = ioc_fused.ioc_refine_cuda(w, *data, **kw, **extra)
        ref = ioc_fused.ioc_refine_plain(params["ioc"], params["scf"], *data,
                                         **kw, **extra)
        return got, ref, max(check_bf16(n, x, y)
                             for n, x, y in zip(names, got, ref))
    got, ref, err = against_plain()
    ref32 = ioc_fused.ioc_refine_plain(params["ioc"], params["scf"],
                                       *widen(data), **kw)
    for n, x, y in zip(names, got, ref32):
        mx, mean = errors(x, y)
        print(f"  {n} against float32 plain: max_abs_err={mx:.3e} (<= "
              f"{PATH_BF16_TOL[n]}) mean_abs_err={mean:.3e}", flush=True)
        if not mx <= PATH_BF16_TOL[n]:
            raise AssertionError(f"{n}: the bf16 kernel at {a} agents is "
                                 f"{mx:.3e} from float32 plain")
    bad = data[1].clone()
    lo = (a - 1) // 16 * 16
    bad[1, lo:, 0] = bad[1, lo:, 1]
    fault = ioc_fused.ioc_refine_cuda(w, data[0], bad, *data[2:], **kw)
    caught = []
    for n, x, y in zip(names, fault, ref):
        mx, mean = errors(x, y)
        if mx > BF16_TOL[n] or mean > BF16_MEAN_TOL[n]:
            caught.append(f"{n} {mx:.3e}/{mean:.3e}")
    if not caught:
        raise AssertionError("the planted one-lane fault passes the bf16 "
                             f"check at {a} agents")
    print(f"  planted fault (a lane reads the next lane's last agent tile) "
          f"caught: {', '.join(caught)}", flush=True)
    print("  social_freeze=True:", flush=True)
    return max(err, against_plain(social_freeze=True)[2])


def time_ms(fn, repeats=5, iters=3):
    """Median over repeats of the mean per-call time in ms of iters calls
    in a row, by CUDA events, after one warm-up call (bench.timed_ms)."""
    from desire_tpu_torch import bench
    return statistics.median(bench.timed_ms(fn, repeats, 1, "cuda",
                                            group=iters))


def device_ms_by_kernel(fn, calls=5):
    """{kernel name: device ms per call of fn} over `calls` calls after one
    warm-up call (bench.device_time)."""
    from desire_tpu_torch import bench
    return bench.device_time(fn, "cuda", calls, warmup=1)[0]


@contextlib.contextmanager
def plain_ops():
    """Route the model's serving kernel call sites (sampler, IOC, scene
    pool) to the plain versions (for timing the plain forward on the same
    card)."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.ops import ioc_fused, scene_pool, sgm_fused
    saved = ops.sgm_sample_decode, ops.ioc_refine, ops.bilinear_pool
    ops.sgm_sample_decode = lambda *a, weights=None, **kw: (
        sgm_fused.sgm_sample_decode_plain(*a, **kw))
    ops.ioc_refine = lambda *a, weights=None, **kw: (
        ioc_fused.ioc_refine_plain(*a, **kw))
    ops.bilinear_pool = scene_pool.bilinear_pool_plain
    try:
        yield
    finally:
        ops.sgm_sample_decode, ops.ioc_refine, ops.bilinear_pool = saved


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


# -- bounds: the least time the card could take for a kernel's work ---------
# NVIDIA H100 SXM data-sheet peaks (dense): device memory 3.35 TB/s; bf16
# tensor cores 989 TFLOP/s; float32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"bf16": 989e12, "f32": 67e12}


def bound(nbytes, flops, kind):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_mem = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[kind] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def sampler_work(cfg, n):
    """(bytes, flops) of the fused sampler on n agent rows: inputs read once
    (features, mask, rho, eps), outputs written once (dec_h f32, hx); the
    products of encoder, prior, mask MLP and K-lane decode."""
    k, t, d, lat = cfg.num_samples, cfg.pred_len, cfg.d_dim, cfg.latent_size
    to, emb, side2 = cfg.obs_len, cfg.embedding_size, cfg.vae_side ** 2
    hid = max(4 * lat, side2 // 2)
    cs = 2 if cfg.compute_dtype == "bfloat16" else 4
    nbytes = (n * to * emb * cs + n * to * 4 + n * d * 4 + n * k * lat * cs
              + n * k * t * d * 4 + n * d * 4)
    mac_row = to * (emb + d) * 3 * d + d * 2 * lat
    mac_lane = (lat * hid + hid * side2 + side2 * d + 2 * lat * d
                + d * 3 * d + t * d * 3 * d)
    return nbytes, 2 * (n * mac_row + n * k * mac_lane)


def ioc_fwd_work(cfg, b, iters_out=False):
    """(bytes, flops) of the IOC forward: traj, dec_h, feature map, masks
    read once; refined, scores (and every pass's positions) written once;
    per pass, step and agent row the message, pooling, gate and head
    products."""
    a, k, t, d = cfg.max_num_obj, cfg.num_samples, cfg.pred_len, cfg.d_dim
    g, c, r = cfg.scene_grid, cfg.scene_channels, max(cfg.num_refine, 1)
    cs = 2 if cfg.compute_dtype == "bfloat16" else 4
    rows = b * a * k
    nbytes = (rows * t * 2 * 4 + rows * t * d * cs + b * g * g * c * cs
              + b * a * 4 + b * a * t * 4 + rows * t * 2 * 4 + rows * 4
              + (r * rows * t * 2 * 4 if iters_out else 0))
    mac = d * d + a * d + (2 * d + c) * 3 * d + d * 3 * d + d * 4
    return nbytes, 2 * (r + 1) * t * rows * mac


def ioc_bwd_work(cfg, b, social_freeze=False):
    """(bytes, flops) of the IOC backward: its inputs (levels, dec_h, msg,
    feature map, masks, cotangents) read once and its outputs (d_traj,
    d_dec, d_msg, d_feat_map) written once; per pass, step and agent row
    the recomputed forward products (messages come precomputed) and the
    adjoint products: hidden, dec/scene/social cotangents, weight
    gradients, the pooling adjoint. Under social_freeze the social pool
    runs once per step and its adjoint once per step after the passes (the
    pooling adjoint twice: both buckets, then the refine bucket)."""
    a, k, t, d = cfg.max_num_obj, cfg.num_samples, cfg.pred_len, cfg.d_dim
    g, c, r = cfg.scene_grid, cfg.scene_channels, max(cfg.num_refine, 1)
    cs = 2 if cfg.compute_dtype == "bfloat16" else 4
    rows = b * a * k
    f = 2 + c + 2 * d
    nbytes = ((r + 1) * rows * t * 2 * 4 + 2 * rows * t * d * cs
              + b * g * g * c * cs + b * a * 4 + b * a * t * 4
              + rows * t * 2 * 4 + rows * 4 + r * rows * t * 2 * 4
              + rows * t * 2 * 4 + 2 * rows * t * d * 4 + b * g * g * c * 4)
    fwd = a * d + (2 * d + c) * 3 * d + d * 3 * d + 2 * d * 4
    adj = 3 * d * d + 3 * d * (2 * d + c) + (f + d) * 3 * d + 2 * a * d
    if not social_freeze:
        return nbytes, 2 * (r + 1) * t * rows * (fwd + adj)
    per_pass = fwd - a * d + adj - 2 * a * d
    once = a * d + 2 * a * d + a * d      # pool; d_msg and two d att
    return nbytes, 2 * t * rows * ((r + 1) * per_pass + once)


def scene_pool_work(b, p, g, c, cs, backward=False):
    """(bytes, flops) of the scene pooling: positions (8 bytes a point) and
    the map read once, the (B, P, C) result written once; 4 multiply-adds
    per (point, channel). The gradient reads the positions, the cotangent
    and the map and writes d_map and d_pos (float32); 4 multiply-adds per
    (point, channel) into d_map and ~8 operations per (point, channel) for
    d_pos."""
    nbytes = b * p * 8 + b * g * g * c * cs + b * p * c * cs
    if not backward:
        return nbytes, 8 * b * p * c
    return nbytes + b * g * g * c * cs + b * p * 8, 16 * b * p * c


def nll_work(n, k, t, backward=False):
    """(bytes, flops) of the step-summed NLL: raw5, target and mask read
    once, (N, K) written (forward) or g read and d_raw5 written (backward);
    ~30 float32 operations per (row, lane, step) forward, ~50 backward."""
    nbytes = n * k * t * 5 * 4 + n * t * 2 * 4 + n * t * 4 + n * k * 4
    if backward:
        nbytes += n * k * t * 5 * 4
    return nbytes, (50 if backward else 30) * n * k * t


# -- training -----------------------------------------------------------------
# float32: the IOC backward kernel and autograd through the plain version
# differ in the order of float32 sums and in fused multiply-adds,
# compounded through the reverse GRU chain of every pass (the JAX kernel
# suite holds its Pallas backward to jax.grad with these tolerances).
F32_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
# float32 NLL: a sum of 12 terms per lane, the same formula term by term.
NLL_TOL = dict(rtol=1e-5, atol=1e-5)
# float32 NLL gradient: the analytic gradient against autograd of the same
# formula, other operation orders; |d raw5| reaches 1e4 where sigma is tiny.
NLL_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# bfloat16 gradients, leaf by leaf: the kernel rounds only the operands of
# its products to bf16 and keeps every cotangent in float32, autograd
# through the plain version rounds each gradient to bf16 at every cast; over
# 5 passes x 12 reverse GRU steps such rounding differences of 2^-8 add up
# to a few per cent of a gradient's norm, never to a systematic fault.
BF16_GRAD_REL_L2 = 0.05
BF16_GRAD_REL_MEAN = 0.05
# bf16 training forward: as the serving IOC's (BF16_TOL), per-pass positions
# included.
# whole float32 step, card vs CPU: Adam's first update is lr * g / |g|, so a
# gradient within float32 noise of 0 may flip sign: an element may move by
# up to 2 lr, but only a few of them may.
STEP_MAX_ABS = lambda lr: 2.0 * lr + 1e-5
STEP_FLIP_SHARE = 1e-3
# the optimizer kernels against ops.adam's plain version: given the same
# norm the same bits (neither contracts into fused multiply-adds); the
# norms differ by the order of their float32 sums (OPT_NORM_RTOL), which
# reaches m and v through the clip's scale and the params times lr
# (OPT_TOL; tests/test_torch_cuda.py's NORM_RTOL and ADAM_TOL).
OPT_NORM_RTOL = 1e-5
OPT_TOL = dict(rtol=1e-5, atol=1e-7)


def ioc_train_args(cfg, b, rng, device):
    """IOC inputs with the training leaves made differentiable."""
    traj, dec_h, fmap, live, fut = ioc_inputs(cfg, b, rng, device)
    return (traj.requires_grad_(True), dec_h.requires_grad_(True),
            fmap.requires_grad_(True), live, fut)


def tree_paths(tree, prefix=""):
    """Dotted names of a tree's leaves, in tree_leaves order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k],
                                                            f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def ioc_train_outputs(params, cfg, args, kernel, social_freeze=False):
    """The training IOC's (refined, scores, iters) and its differentiable
    leaves (inputs, then the IOC and message parameters), by name: through
    the kernels, or the plain version on the same device."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.models.ioc import _DELTA_SCALE
    from desire_tpu_torch.ops import ioc_fused
    from desire_tpu_torch.train.state import tree_leaves, tree_unflatten
    traj, dec_h, fmap, live, fut = args
    trees = {"ioc": params["ioc"],
             "scf": {"soc_msg": params["scf"]["soc_msg"],
                     "soc_logtau": params["scf"]["soc_logtau"]}}
    leaves = [x.detach().clone().requires_grad_(True)
              for x in tree_leaves(trees)]
    trees = tree_unflatten(trees, leaves)
    names = ["traj", "dec_h", "feat_map"] + tree_paths(trees)
    kw = dict(num_refine=max(cfg.num_refine, 1), delta_scale=_DELTA_SCALE,
              social_freeze=social_freeze)
    if kernel:
        refined, scores, iters = ops.ioc_refine_train(
            trees["ioc"], trees["scf"], traj, dec_h, fmap, live, fut, **kw)
    else:
        refined, scores, iters = ioc_fused.ioc_refine_plain(
            trees["ioc"], trees["scf"], traj, dec_h, fmap, live, fut,
            collect_iters=True, **kw)
        scores = scores.to(dec_h.dtype)
    return (refined, scores, iters), dict(zip(names,
                                              [traj, dec_h, fmap] + leaves))


def ioc_test_loss(outs, wts):
    """The JAX kernel suite's IOC gradient test loss."""
    refined, scores, iters = outs
    return ((refined ** 2).sum() + (scores.float() * wts).sum()
            + (iters ** 2).sum() + torch.sin(refined).sum())


def ioc_train_grads(params, cfg, args, wts, kernel, social_freeze=False):
    """Gradients of :func:`ioc_test_loss` for every input and parameter
    leaf of :func:`ioc_train_outputs`."""
    outs, leaves = ioc_train_outputs(params, cfg, args, kernel,
                                     social_freeze)
    grads = torch.autograd.grad(ioc_test_loss(outs, wts),
                                list(leaves.values()))
    return outs, dict(zip(leaves, grads))


def check_grads_bf16(name, got, ref, verbose=True):
    """Relative L2 and relative mean absolute error of one gradient leaf
    (verbose=False prints only a failure)."""
    g, r = got.float(), ref.float()
    diff = g - r
    rel_l2 = float(diff.norm() / max(float(r.norm()), 1e-30))
    rel_mean = float(diff.abs().mean() / max(float(r.abs().mean()), 1e-30))
    ok = (bool(torch.isfinite(g).all()) and rel_l2 <= BF16_GRAD_REL_L2
          and rel_mean <= BF16_GRAD_REL_MEAN)
    if verbose or not ok:
        print(f"  d {name}: rel_l2={rel_l2:.3e} (<= {BF16_GRAD_REL_L2}) "
              f"rel_mean_abs={rel_mean:.3e} (<= {BF16_GRAD_REL_MEAN}) "
              f"max_abs_err={float(diff.abs().max()):.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"d {name}: bf16 IOC backward disagrees with "
                             f"autograd through the plain version")
    return float(diff.abs().max())


def nll_inputs(n, k, t, rng, device):
    """NLL inputs; every 7th row is far off target with tiny sigmas, so
    that the log-density floor is active there."""
    raw5 = rng.standard_normal((n, k, t, 5)) * 0.5
    target = rng.uniform(0.2, 0.8, (n, t, 2))
    raw5[:, :, :, :2] += target[:, None]
    raw5[::7, :, :, :2] = target[::7, None] + 5.0
    raw5[::7, :, :, 2:4] = -8.0
    mask = (rng.random((n, t)) > 0.1).astype(np.float32)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return f(raw5), f(target), f(mask)


def check_nll(n, k, t, rng, device):
    """Kernels 4 and 5 against the plain version. Returns the max abs
    errors (forward, backward) and the inputs."""
    from desire_tpu_torch.ops import nll
    raw5, target, mask = nll_inputs(n, k, t, rng, device)
    got = nll.nll_fwd_cuda(raw5, target, mask)
    ref = nll.bivariate_nll_plain(raw5, target, mask)
    floor = float(ref.max())
    print(f"  (N, K, T) = {(n, k, t)}; largest lane NLL {floor:.1f} "
          f"(floor active where a step reaches 46.05)", flush=True)
    e_f = check_close("nll forward", got, ref, **NLL_TOL)
    g = torch.as_tensor(rng.standard_normal((n, k)).astype(np.float32),
                        device=device)
    got = nll.nll_bwd_cuda(raw5, target, mask, g)
    r = raw5.clone().requires_grad_(True)
    ref, = torch.autograd.grad((nll.bivariate_nll_plain(r, target, mask)
                                * g).sum(), [r])
    if float(ref[::7].abs().max()) != 0.0 or float(got[::7].abs().max()):
        raise AssertionError("NLL gradient not zero where the floor is "
                             "active")
    e_b = check_close("nll backward", got, ref, **NLL_GRAD_TOL)
    return e_f, e_b, (raw5, target, mask, g)


def synthetic_batch(cfg, rng):
    """A training batch of normalized positions (B, To+Tf, A, 2): straight
    walks with noise, some dead slots (id 0), some late entries."""
    b, t, a = cfg.batch_size, cfg.total_len, cfg.max_num_obj
    p0 = rng.uniform(0.15, 0.85, (b, 1, a, 2))
    v = rng.uniform(-0.01, 0.01, (b, 1, a, 2))
    xy = p0 + v * np.arange(t)[None, :, None, None] + rng.normal(
        0, 0.002, (b, t, a, 2))
    mask = np.ones((b, t, a), np.float32)
    late = rng.random((b, a)) < 0.2
    mask[:, :3][np.broadcast_to(late[:, None], (b, 3, a))] = 0.0
    ids = np.tile(np.arange(1, a + 1), (b, 1)).astype(np.float32)
    ids[rng.random((b, a)) < 0.1] = 0.0
    mask = mask * (ids[:, None] > 0)
    return (np.clip(xy, 0.0, 1.0).astype(np.float32) * mask[..., None],
            mask, ids)


class SyntheticLoader:
    """``epoch_batches`` over a fixed number of synthetic batches, the
    interface ``train.trainer.run_epoch`` reads (``rows``: a rank's rows of
    each batch, as ``data.loader.SDDLoader``'s)."""
    drop_remainder = True

    def __init__(self, cfg, rng, batches):
        self.cfg = cfg
        self.batches = [dict(zip(("xy", "mask", "ids"),
                                 synthetic_batch(cfg, rng)))
                        for _ in range(batches)]

    def epoch_batches(self, epoch, start_batch=0, rows=None):
        from types import SimpleNamespace
        for b in self.batches[start_batch:]:
            yield SimpleNamespace(**{k: v if rows is None else v[rows]
                                     for k, v in b.items()})


def train_noise(cfg, rng, device):
    """A training step's pinned random draws (desire_loss's noise keys)."""
    b, a, k = cfg.batch_size, cfg.max_num_obj, cfg.num_samples
    n = b * a
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return {"eps": f(rng.standard_normal((n, k, cfg.latent_size))),
            "lane_u": f(rng.random((b, a, k))),
            "keep_x": f(rng.random((n, cfg.obs_len, cfg.embedding_size))
                        < cfg.keep_prob),
            "keep_y": f(rng.random((n, cfg.pred_len, cfg.embedding_size))
                        < cfg.keep_prob)}


@contextlib.contextmanager
def plain_train_ops():
    """Route the training kernel call sites (the trainable IOC, the NLL,
    the scene pool, the optimizer) to the plain versions, under autograd
    (for timing the plain training step on the same card). The plain
    update of the card's flat optimizer state runs leaf by leaf on its
    views, and its results go into fresh buffers in the state's layout."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.ops import adam, ioc_fused, nll, scene_pool
    saved = ops.ioc_refine_train, ops.bivariate_nll_sum, ops.bilinear_pool
    saved_opt = adam.global_norm, adam.clip_adam

    def ioc_plain(*a, **kw):
        refined, scores, iters = ioc_fused.ioc_refine_plain(
            *a, collect_iters=True, **kw)
        return refined, scores.to(a[3].dtype), iters

    def clip_adam_plain(flat, grads, *args):
        lay = flat.layout
        p, m, v = (lay.views(x) for x in (flat.params, flat.mu, flat.nu))
        new = adam.clip_adam_plain(p, grads, m, v, *args)
        return adam.Flat(lay, *(lay.pack(x) for x in new))
    ops.ioc_refine_train = ioc_plain
    ops.bivariate_nll_sum = nll.bivariate_nll_plain
    ops.bilinear_pool = scene_pool.bilinear_pool_plain
    adam.global_norm = adam.global_norm_plain
    adam.clip_adam = clip_adam_plain
    try:
        yield
    finally:
        (ops.ioc_refine_train, ops.bivariate_nll_sum,
         ops.bilinear_pool) = saved
        adam.global_norm, adam.clip_adam = saved_opt


def routed_step(cfg):
    """make_train_step's step_fn, one for each routing of the training
    kernel call sites: a graphed step replays the kernels its capture
    recorded, so the plain turns (plain_train_ops) take a step function
    captured under them."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.train.trainer import make_train_step
    fns = {}

    def step_fn(*args, **kwargs):
        route = ops.bivariate_nll_sum
        if route not in fns:
            fns[route] = make_train_step(cfg, steps_per_epoch=190)
        return fns[route](*args, **kwargs)
    return step_fn


def check_step_card_vs_cpu(scfg, sp, rng):
    """One float32 make_train_step step from the params sp: the kernels on
    the card against the plain versions on the CPU, on the same batch and
    noise. Returns the card's launches in the step."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.params import to_device
    from desire_tpu_torch.train.state import create_train_state, tree_leaves
    from desire_tpu_torch.train.trainer import make_train_step
    sp_cpu = to_device(sp, "cpu")
    batch = synthetic_batch(scfg, rng)
    noise = train_noise(scfg, rng, "cpu")
    after = {}
    for where in ("cpu", "cuda"):
        step_fn = make_train_step(scfg, steps_per_epoch=190)
        st = create_train_state(scfg, to_device(sp_cpu, where), seed=0)
        T = lambda x: torch.as_tensor(x, device=where)
        ops.reset_launch_counts()
        st, met = step_fn(st, *map(T, batch),
                          noise={k: T(v) for k, v in noise.items()})
        after[where] = (tree_leaves(st.params), met)
    launches = dict(ops.LAUNCHES)
    check_step_rule(after["cuda"], after["cpu"], scfg.learning_rate,
                    f"card launches {launches}")
    return launches


def check_step_rule(card, cpu, lr, note=""):
    """Hold a float32 step's (params leaves, metrics) on the card against
    the plain step's on the CPU: STEP_MAX_ABS and STEP_FLIP_SHARE on the
    params, the loss within 1e-4."""
    worst, moved, total_n = 0.0, 0, 0
    for a_, b_ in zip(card[0], cpu[0]):
        diff = (a_.cpu() - b_).abs()
        worst = max(worst, float(diff.max()))
        moved += int((diff > 1e-4).sum())
        total_n += diff.numel()
    share = moved / total_n
    for key in ("loss", "grad_norm"):
        print(f"  {key}: card {float(card[1][key]):.6f} "
              f"CPU {float(cpu[1][key]):.6f}", flush=True)
    ok = worst <= STEP_MAX_ABS(lr) and share <= STEP_FLIP_SHARE
    print(f"  params after the step: max_abs_err={worst:.3e} (<= "
          f"{STEP_MAX_ABS(lr):.3e}), share off by > 1e-4: {share:.2e} "
          f"(<= {STEP_FLIP_SHARE}) {'ok' if ok else 'FAIL'}; {note}",
          flush=True)
    check_close("step loss", card[1]["loss"].cpu(), cpu[1]["loss"],
                rtol=1e-4, atol=1e-5)
    if not ok:
        raise AssertionError("the float32 step on the card disagrees with "
                             "the plain step on the CPU")


def epoch_run(cfg, params, loader, label):
    """run_epoch over all of loader's batches from a fresh state (seed 0),
    every step logged. Checks finite losses and gradient norms and moved
    params. Returns (logged metrics, launches, peak device bytes)."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.train.state import create_train_state, tree_leaves
    from desire_tpu_torch.train.trainer import make_train_step, run_epoch
    n = len(loader.batches)
    step_fn = make_train_step(cfg, steps_per_epoch=190)
    state = create_train_state(cfg, params, seed=0)
    before = [x.clone() for x in tree_leaves(state.params)]
    logged = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, mean_loss = run_epoch(state, loader, 0, step_fn,
                                 log_fn=lambda m, st: logged.append(m),
                                 log_every=1)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    moved = sum(int((x != y).sum()) for x, y in
                zip(tree_leaves(state.params), before))
    print(f"  {label}: steps {state.step}; mean loss {mean_loss:.6f}; losses "
          f"{[m['loss'] for m in logged]}; grad_norm "
          f"{[round(m['grad_norm'], 4) for m in logged]}; params changed "
          f"{moved}; launches {launches}; peak device memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    if state.step != n or len(logged) != n or not np.isfinite(mean_loss):
        raise AssertionError(f"{label}: {n} finite training steps expected")
    if not all(np.isfinite(m["grad_norm"]) for m in logged) or moved == 0:
        raise AssertionError(f"{label}: non-finite gradients or unmoved "
                             f"params")
    return logged, launches, peak


def check_launches(label, launches, names, least):
    for name in names:
        if launches[name] < least:
            raise AssertionError(f"{label}: kernel {name} launched "
                                 f"{launches[name]} times (want >= {least})")


def check_not_launched(label, launches, names):
    for name in names:
        if launches[name]:
            raise AssertionError(f"{label}: kernel {name} launched "
                                 f"{launches[name]} times (want 0)")


def optimizer_work(n):
    """(bytes, operations) of grad_sumsq and of clip_adam over n values:
    the norm reads g; the update reads g, p, m and v and writes p', m' and
    v' (~20 float32 operations a value)."""
    return {"grad_sumsq": (4 * n, 2 * n), "clip_adam": (28 * n, 20 * n)}


def check_optimizer(cfg, params, rng, dev):
    """The optimizer kernels at the flagship's tree (params' leaves): the
    norm and the update against ops.adam's plain version on the card, an
    unclipped and a clipped step (OPT_NORM_RTOL, OPT_TOL; the plain update
    with the kernel's norm bit for bit); the kernels alone on the card in
    an update, no copy (torch.profiler). The state holds the params and
    moments in its flat buffers (``TrainState.flat``); the plain version
    takes the leaves they were copied from. Returns (max abs errors of the
    norm and of the update, {kernel: device ms}, plain ms of the norm and
    of the update, the wrapper's ms)."""
    from desire_tpu_torch.ops import adam
    from desire_tpu_torch.train import state as tstate
    p = tstate.tree_leaves(params)
    n = sum(x.numel() for x in p)
    T = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    mu = [T(rng.standard_normal(x.shape) * 1e-2) for x in p]
    nu = [T(np.abs(rng.standard_normal(x.shape)) * 1e-4) for x in p]
    st = tstate.TrainState(step=4, params=p, mu=mu, nu=nu, count=4,
                           generator=None)
    lr = tstate.learning_rate(cfg, 190, st.count)
    bc = [1.0 - torch.tensor(b, dtype=torch.float32) ** (st.count + 1)
          for b in (tstate.B1, tstate.B2)]
    err_n = err_u = 0.0
    for scale in (1e-3, 1.0):
        g = [T(rng.standard_normal(x.shape) * scale) for x in p]
        norm = tstate.global_norm(g)
        got = tstate.apply_updates(cfg, 190, st, g, g_norm=norm)
        ref_n = adam.global_norm_plain(g)
        clipped = float(norm) >= cfg.grad_clip
        print(f"  {n} values in {len(p)} leaves, |g| kernel "
              f"{float(norm):.6f} plain {float(ref_n):.6f} "
              f"({'clipped' if clipped else 'kept'})", flush=True)
        if clipped != (scale == 1.0):
            raise AssertionError("the optimizer check's gradients did not "
                                 "take the clip they were drawn for")
        err_n = max(err_n, check_close("grad_sumsq norm", norm.reshape(1),
                                       ref_n.reshape(1), rtol=OPT_NORM_RTOL,
                                       atol=0.0))
        ref = adam.clip_adam_plain(p, g, mu, nu, ref_n, cfg.grad_clip, lr,
                                   *bc)
        same = adam.clip_adam_plain(p, g, mu, nu, norm, cfg.grad_clip, lr,
                                    *bc)
        for name, a_, r_, s_ in zip(("params", "mu", "nu"), got[:3], ref,
                                    same):
            flat = lambda xs: torch.cat([x.reshape(-1) for x in xs])
            err_u = max(err_u, check_close(f"clip_adam {name}", flat(a_),
                                           flat(r_), **OPT_TOL))
            if not all(torch.equal(x, y) for x, y in zip(a_, s_)):
                raise AssertionError(f"clip_adam {name}: not the plain "
                                     f"update's bits with the same norm")

    def update():
        return tstate.apply_updates(cfg, 190, st, g,
                                    g_norm=tstate.global_norm(g))

    def plain_update():
        return adam.clip_adam_plain(p, g, mu, nu, adam.global_norm_plain(g),
                                    cfg.grad_clip, lr, *bc)
    dev_ms = device_ms_by_kernel(update)
    print(f"  device time of an update by kernel: {dev_ms}", flush=True)
    if set(dev_ms) != {"grad_sumsq_kernel", "clip_adam_kernel"}:
        raise AssertionError("an update ran more on the card than the two "
                             "optimizer kernels (a copy, another kernel)")
    t_norm_p = time_ms(lambda: adam.global_norm_plain(g))
    t_plain = time_ms(plain_update)
    t_wrap = time_ms(update)
    print(f"  optimizer ms: kernels {t_wrap:.3f} (the wrappers' host time "
          f"with the card's), plain {t_plain:.3f} (its norm {t_norm_p:.3f})",
          flush=True)
    return (err_n, err_u), dev_ms, (t_norm_p, t_plain), t_wrap


def training_phase(dev, smi, rng):
    """Phase 6. Returns the per-kernel results of the four training
    kernels, of the IOC backward's social_freeze variant and of the two
    optimizer kernels."""
    from desire_tpu_torch.models.ioc import _DELTA_SCALE
    from desire_tpu_torch.ops import ioc_bwd, ioc_fused, nll
    from desire_tpu_torch.train.state import create_train_state, tree_leaves

    # -- 6a. float32, small shape -------------------------------------------
    print("training kernels, float32, small shape:", flush=True)
    scfg = small_cfg()
    sp = make_params(scfg, dev)
    args = ioc_train_args(scfg, 2, rng, dev)
    wts = torch.as_tensor(rng.standard_normal(
        (2, scfg.max_num_obj, scfg.num_samples)).astype(np.float32),
        device=dev)
    for freeze in (False, True):
        tag = " (social_freeze)" if freeze else ""
        out_k, g_k = ioc_train_grads(sp, scfg, args, wts, kernel=True,
                                     social_freeze=freeze)
        out_p, g_p = ioc_train_grads(sp, scfg, args, wts, kernel=False,
                                     social_freeze=freeze)
        for name, a_, b_ in zip(("refined", "scores", "iters"), out_k, out_p):
            check_close(f"ioc train {name}{tag}", a_.detach(), b_.detach(),
                        **(F32_SCORE_TOL if name == "scores" else F32_TOL))
        for name in g_p:
            check_close(f"d {name}{tag}", g_k[name], g_p[name],
                        **F32_GRAD_TOL)
    check_nll(9, scfg.num_samples, scfg.pred_len, rng, dev)
    # odd shapes of the NLL forward's staging: K not a multiple of its 32
    # lanes a block (blocks straddle rows n), T = 1 and 6 (read float by
    # float), T = 20 (16-byte pieces), T = 8 (a 10-piece row padded to 11),
    # T = 100 and 400 (chunks of 32 steps, the last one partial; 33 rows n
    # a block at K = 1), T = 37 (float by float in chunks)
    for odd in ((37, 7, 1), (50, 13, 20), (40, 5, 8), (11, 3, 6),
                (10, 9, 100), (40, 1, 400), (12, 20, 400), (9, 5, 37)):
        check_nll(*odd, rng, dev)

    # -- 6b. bfloat16, flagship shape -----------------------------------------
    print("training kernels, bfloat16, flagship shape:", flush=True)
    cfg = flagship_cfg()
    params = make_params(cfg, dev)
    b = cfg.batch_size
    args = ioc_train_args(cfg, b, rng, dev)
    wts = torch.as_tensor(rng.standard_normal(
        (b, cfg.max_num_obj, cfg.num_samples)).astype(np.float32),
        device=dev)
    fwd_err, bwd_err = {}, {}
    for freeze in (False, True):
        if freeze:
            print("  with social_freeze:", flush=True)
        out_k, g_k = ioc_train_grads(params, cfg, args, wts, kernel=True,
                                     social_freeze=freeze)
        out_p, g_p = ioc_train_grads(params, cfg, args, wts, kernel=False,
                                     social_freeze=freeze)
        fwd_err[freeze] = max(
            check_bf16("refined", out_k[0].detach(), out_p[0].detach()),
            check_bf16("refined", out_k[2].detach(), out_p[2].detach()),
            check_bf16("scores", out_k[1].detach(), out_p[1].detach()))
        bwd_err[freeze] = max(check_grads_bf16(name, g_k[name], g_p[name])
                              for name in g_p)
        del out_k, g_k, out_p, g_p
    nll_f_err, nll_b_err, nll_args = check_nll(
        b * cfg.max_num_obj, cfg.num_samples, cfg.pred_len, rng, dev)

    # -- 6c. determinism ------------------------------------------------------
    traj, dec_h, fmap, live, fut = (x.detach() for x in args)
    w = ioc_fused.pack_ioc(params["ioc"], params["scf"], torch.bfloat16, dev,
                           cfg.max_num_obj)
    msg = ioc_bwd.social_messages(params["scf"], dec_h).contiguous()
    # the backward's weights packed once, as the training forward does
    wb = ioc_bwd.pack_ioc_bwd(params["ioc"], params["scf"], torch.bfloat16,
                              dev)
    bwd_args, kws = {}, {}
    for freeze in (False, True):
        kw = dict(num_refine=cfg.num_refine, delta_scale=_DELTA_SCALE,
                  social_freeze=freeze)
        refined, scores, iters = ioc_fused.ioc_refine_cuda(
            w, traj, dec_h, fmap, live, fut, collect_iters=True, **kw)
        cts = [torch.as_tensor(rng.standard_normal(x.shape).astype(
            np.float32), device=dev) for x in (refined, scores, iters)]
        bwd_args[freeze] = (params["ioc"], params["scf"], traj, dec_h, msg,
                            fmap, live, fut, iters, *cts)
        kws[freeze] = kw
        first = ioc_bwd.ioc_refine_bwd_cuda(*bwd_args[freeze], weights=wb,
                                            **kw)
        second = ioc_bwd.ioc_refine_bwd_cuda(*bwd_args[freeze], weights=wb,
                                             **kw)
        flat = lambda o: [x for x in o[:4]] + [o[4][n] for n in sorted(o[4])] \
            + [o[5][h][n] for h in sorted(o[5]) for n in ("w", "b")] + [o[6]]
        same = all(torch.equal(x, y)
                   for x, y in zip(flat(first), flat(second)))
        print(f"  ioc backward (social_freeze={freeze}) run twice: bitwise "
              f"equal = {same}", flush=True)
        if not same:
            raise AssertionError("the IOC backward kernel is not "
                                 "deterministic")
        del first, second

    # -- 6d. one float32 step: card vs CPU ------------------------------------
    print("one float32 training step, card (kernels) vs CPU (plain):",
          flush=True)
    check_step_card_vs_cpu(scfg, sp, rng)

    # -- 6e. run_epoch at the flagship training shape -----------------------
    print("training: run_epoch at B=64, A=60, K=20, bf16", flush=True)
    train_names = ("ioc_refine_train", "ioc_refine_bwd", "nll_fwd",
                   "nll_bwd")
    _, launches, _ = epoch_run(cfg, params, SyntheticLoader(cfg, rng, 5),
                               "5 steps")
    check_launches("5 training steps", launches, train_names, 5)
    cfg_fz = flagship_cfg(social_freeze=True)
    _, launches_fz, _ = epoch_run(cfg_fz, params,
                                  SyntheticLoader(cfg, rng, 3),
                                  "3 steps, social_freeze")
    check_launches("3 social_freeze training steps", launches_fz,
                   train_names, 3)
    for label, got, steps in (("5 training steps", launches, 5),
                              ("3 social_freeze training steps",
                               launches_fz, 3)):
        # the optimizer: exactly one launch of each kernel a step
        if (got["grad_sumsq"], got["clip_adam"]) != (steps, steps):
            raise AssertionError(f"{label}: grad_sumsq and clip_adam "
                                 f"launched {got['grad_sumsq']} and "
                                 f"{got['clip_adam']} times (want {steps})")
        # the IOC backward's weight-gradient product: once a backward call
        if got["ioc_bwd_wgrad"] != got["ioc_refine_bwd"]:
            raise AssertionError(f"{label}: ioc_bwd_wgrad launched "
                                 f"{got['ioc_bwd_wgrad']} times, the IOC "
                                 f"backward {got['ioc_refine_bwd']}")

    # -- 6f. timing -----------------------------------------------------------
    print(f"training timing on {smi} (CUDA events, median):", flush=True)
    xy, mask, ids = (torch.as_tensor(x, device=dev)
                     for x in synthetic_batch(cfg, rng))
    step_ms = {}
    for name, c in (("train_step_ms", cfg),
                    ("train_step_ms social_freeze", cfg_fz)):
        st0 = create_train_state(c, params, seed=0)
        step_fn = routed_step(c)
        step_ms[name] = time_in_turns(
            lambda: step_fn(st0, xy, mask, ids), plain_train_ops, name,
            repeats=3, iters=2)
    step_split("train_step", cfg, params, (xy, mask, ids),
               step_ms["train_step_ms"][0])
    step_split("train_step social_freeze", cfg_fz, params, (xy, mask, ids),
               step_ms["train_step_ms social_freeze"][0])
    kw = kws[False]
    t_fwd = time_ms(lambda: ioc_fused.ioc_refine_cuda(
        w, traj, dec_h, fmap, live, fut, collect_iters=True, **kw))
    t_fwd_p = time_ms(lambda: ioc_fused.ioc_refine_plain(
        params["ioc"], params["scf"], traj, dec_h, fmap, live, fut,
        collect_iters=True, **kw))
    t_bwd, t_bwd_p = {}, {}
    for freeze in (False, True):
        t_bwd[freeze] = time_ms(lambda: ioc_bwd.ioc_refine_bwd_cuda(
            *bwd_args[freeze], weights=wb, **kws[freeze]), repeats=3,
            iters=2)
        # the plain backward: autograd through the plain version, on a
        # graph recorded once
        outs, leaves = ioc_train_outputs(params, cfg, args, kernel=False,
                                         social_freeze=freeze)
        loss = ioc_test_loss(outs, wts)
        t_bwd_p[freeze] = time_ms(lambda: torch.autograd.grad(
            loss, list(leaves.values()), retain_graph=True), repeats=3,
            iters=1)
        del outs, leaves, loss
    raw5, target, mask_n, g = nll_args
    # the NLL kernels take ~20 us, less than their wrappers' host time, so
    # CUDA events around the calls would time the host: their device time
    t_nf = sum(device_ms_by_kernel(
        lambda: nll.nll_fwd_cuda(raw5, target, mask_n)).values())
    t_nf_p = time_ms(lambda: nll.bivariate_nll_plain(raw5, target, mask_n))
    t_nb = sum(device_ms_by_kernel(
        lambda: nll.nll_bwd_cuda(raw5, target, mask_n, g)).values())
    r = raw5.clone().requires_grad_(True)
    nll_graph = nll.bivariate_nll_plain(r, target, mask_n)
    t_nb_p = time_ms(lambda: torch.autograd.grad(nll_graph, [r], g,
                                                 retain_graph=True))
    # the backward's two kernels apart (device time), the weight-gradient
    # product beside its floor: its operand log read once
    log_bytes = 2 * (b * cfg.num_samples * (cfg.num_refine + 1)
                     * cfg.pred_len * -(-cfg.max_num_obj // 16) * 16
                     * (cfg.scene_channels + 7 * cfg.d_dim + 16))
    for freeze in (False, True):
        split = device_ms_by_kernel(lambda: ioc_bwd.ioc_refine_bwd_cuda(
            *bwd_args[freeze], weights=wb, **kws[freeze]), calls=3)
        wg = sum(v for n, v in split.items() if "wgrad" in n)
        print(f"ioc_refine_bwd (social_freeze={freeze}) device ms by kernel "
              f"{ {n: round(v, 4) for n, v in split.items()} }; the "
              f"weight-gradient product {wg:.4f} against its byte floor "
              f"{log_bytes / HBM_BYTES_S * 1e3:.4f} ({log_bytes / 2**30:.3f} "
              f"GiB of operand log)", flush=True)
    for name, t_k, t_p in (("ioc_refine_train", t_fwd, t_fwd_p),
                           ("ioc_refine_bwd", t_bwd[False], t_bwd_p[False]),
                           ("ioc_refine_bwd_social_freeze", t_bwd[True],
                            t_bwd_p[True]),
                           ("nll_fwd", t_nf, t_nf_p),
                           ("nll_bwd", t_nb, t_nb_p)):
        print(f"{name} ms kernel {t_k:.3f} plain {t_p:.3f}", flush=True)
    n_rows = b * cfg.max_num_obj
    for name, t_k, bwd in (("nll_fwd", t_nf, False), ("nll_bwd", t_nb, True)):
        b_ms = bound(*nll_work(n_rows, cfg.num_samples, cfg.pred_len,
                               backward=bwd), "f32")[0]
        print(f"{name} ms kernel {t_k:.4f} (device time) bound {b_ms:.4f}",
              flush=True)

    # -- 6g. the optimizer kernels at the flagship's tree ---------------------
    print("optimizer kernels at the flagship's tree, float32:", flush=True)
    # its own draws: the later phases keep the shared generator's inputs
    opt_err, opt_dev, opt_plain, opt_wrap = check_optimizer(
        cfg, params, np.random.default_rng(0), dev)

    rows = []
    for name, src, rep, err, t_k, t_p, work, runs in (
            ("ioc_refine_train", "ioc_refine.cu",
             "desire_tpu/ops/ioc_fused.py:244", fwd_err[False], t_fwd,
             t_fwd_p, (ioc_fwd_work(cfg, b, iters_out=True), "bf16"),
             launches),
            ("ioc_refine_bwd", "ioc_refine_bwd.cu",
             "desire_tpu/ops/ioc_bwd.py:93", bwd_err[False], t_bwd[False],
             t_bwd_p[False], (ioc_bwd_work(cfg, b), "bf16"), launches),
            ("ioc_refine_bwd_social_freeze", "ioc_refine_bwd.cu",
             "desire_tpu/ops/ioc_bwd.py:859", bwd_err[True], t_bwd[True],
             t_bwd_p[True], (ioc_bwd_work(cfg, b, social_freeze=True),
                             "bf16"), launches_fz),
            ("nll_fwd", "nll.cu", "desire_tpu/ops/nll.py:83", nll_f_err,
             t_nf, t_nf_p, (nll_work(n_rows, cfg.num_samples, cfg.pred_len),
                            "f32"), launches),
            ("nll_bwd", "nll.cu", "desire_tpu/ops/nll.py:91", nll_b_err,
             t_nb, t_nb_p, (nll_work(n_rows, cfg.num_samples, cfg.pred_len,
                                     backward=True), "f32"), launches)):
        (nbytes, flops), kind = work
        b_ms, b_by = bound(nbytes, flops, kind)
        count = runs["ioc_refine_bwd" if name.startswith("ioc_refine_bwd")
                     else name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"desire_tpu_torch/csrc/{src}",
                     "replaces": rep, "launches": count,
                     "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    # the optimizer kernels replace no TPU kernel (optax's chain, which XLA
    # fused); their times are device time, the plain ones the plain norm
    # and the plain norm with the update
    n_values = sum(x.numel() for x in tree_leaves(params))
    for name, err, t_p in (("grad_sumsq", opt_err[0], opt_plain[0]),
                           ("clip_adam", opt_err[1], opt_plain[1])):
        t_k = opt_dev[name + "_kernel"]
        b_ms, b_by = bound(*optimizer_work(n_values)[name], "f32")
        print(f"{name} ms kernel {t_k:.4f} (device time) plain {t_p:.3f} "
              f"bound {b_ms:.4f}", flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": "desire_tpu_torch/csrc/adam.cu",
                     "replaces": None, "launches": launches[name],
                     "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "wrapper_ms": opt_wrap})
    return rows


def step_split(name, cfg, params, batch, step_ms):
    """Where a training step's time goes: the eager loss forward, its
    backward (forward + backward less forward) and the optimizer with the
    rest (the step less both: below zero where the step replays the
    loss's CUDA graphs, faster than the eager loss), CUDA events."""
    from desire_tpu_torch.models.desire import desire_loss
    from desire_tpu_torch.train.state import tree_leaves, tree_unflatten
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    p_req = tree_unflatten(params, leaves)
    gen = torch.Generator(device=leaves[0].device)

    def loss_fwd():
        return desire_loss(p_req, cfg, *batch, step=0, generator=gen)[0]
    t_loss = time_ms(loss_fwd, repeats=3, iters=2)
    # allow_unused: use_social=False leaves the social weights out
    t_loss_bwd = time_ms(lambda: torch.autograd.grad(
        loss_fwd(), leaves, allow_unused=True), repeats=3, iters=2)
    print(f"{name} split ms: eager loss forward {t_loss:.3f}, backward "
          f"{t_loss_bwd - t_loss:.3f}, optimizer and the rest "
          f"{step_ms - t_loss_bwd:.3f}", flush=True)


def time_in_turns(fn, plain_ctx, name, repeats=5, iters=3):
    """fn through the kernels and under plain_ctx (the plain versions), in
    turns: kernels, plain, kernels, plain. Prints both; returns the medians
    (kernels, plain)."""
    got, plain = [], []
    for _ in range(2):
        got.append(time_ms(fn, repeats=repeats, iters=iters))
        with plain_ctx():
            plain.append(time_ms(fn, repeats=repeats, iters=iters))
    k, p = statistics.median(got), statistics.median(plain)
    print(f"{name} kernels {k:.3f} (runs {got})", flush=True)
    print(f"{name} plain {p:.3f} (runs {plain})", flush=True)
    return k, p


def flagship_windows(cfg, rng, device):
    """A timing batch: (B, To+Tf, A, 2) positions, an all-ones mask, ids."""
    bx = torch.as_tensor(
        rng.uniform(0.2, 0.8, (cfg.batch_size, cfg.total_len,
                               cfg.max_num_obj, 2)).astype(np.float32),
        device=device)
    bm = torch.ones(bx.shape[:3], device=device)
    bids = torch.arange(1, cfg.max_num_obj + 1, device=device).repeat(
        cfg.batch_size, 1)
    return bx, bm, bids


# -- the scene pool -------------------------------------------------------------
# float32: the kernels and the plain versions take the same products and sum
# them in another order: the forward 4 terms; d_map every point at a node
# (hundreds at the flagship); d_pos C terms of up to ~(G - 1) * 4 each,
# whose float32 rounding reaches ~1e-4 where they cancel.
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
POOL_DMAP_TOL = dict(rtol=1e-4, atol=1e-4)
POOL_DPOS_TOL = dict(rtol=1e-4, atol=1e-3)
# bfloat16 results (the forward and d_map): a float32 sum taken in another
# order can round to the neighbouring bf16 value, 2^-7 relative at most.
POOL_BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-4)


def scene_pool_inputs(b, g, c, p, cd, rng, device):
    """Map, positions and a cotangent: a quarter of the positions exactly
    on grid nodes, a quarter outside [0, 1], the last six on the borders
    and corners, the rest uniform in [0, 1]."""
    pos = rng.uniform(0.0, 1.0, (b, p, 2))
    q = p // 4
    pos[:, :q] = rng.integers(0, g, (b, q, 2)) / (g - 1)
    pos[:, q:2 * q] = rng.uniform(-0.5, 1.5, (b, q, 2))
    pos[:, -6:] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.3],
                   [0.7, 0.0], [1.0, 0.0]]
    f = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x, np.float32), device=device).to(dt)
    return (f(rng.standard_normal((b, g, g, c)), cd), f(pos),
            f(rng.standard_normal((b, p, c)), cd))


def scene_pool_pile_inputs(b, g, c, p, cd, rng, device):
    """Map, positions that pile up and a cotangent (p >= 8,129): 3,000
    beyond (1, 1) (the far corner cell, whose four corners coincide), 2,000
    inside cell (0, 0), 3,000 below the first grid row (clamped onto its
    cells), 64 and 65 in two cells (a bucket of exactly one segment of the
    gradient's sums and of just over one), the rest uniform in [0, 1]."""
    h = 1.0 / (g - 1)
    pos = rng.uniform(0.0, 1.0, (b, p, 2))
    pos[:, :3000] = rng.uniform(1.0, 1.3, (b, 3000, 2))
    pos[:, 3000:5000] = rng.uniform(0.0, h, (b, 2000, 2)) * 0.999
    pos[:, 5000:8000, 1] = rng.uniform(-0.4, 0.0, (b, 3000))
    pos[:, 8000:8064] = (np.asarray([3, 5]) + rng.uniform(
        0.01, 0.99, (b, 64, 2))) * h
    pos[:, 8064:8129] = (np.asarray([6, 2]) + rng.uniform(
        0.01, 0.99, (b, 65, 2))) * h
    f = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x, np.float32), device=device).to(dt)
    return (f(rng.standard_normal((b, g, g, c)), cd), f(pos),
            f(rng.standard_normal((b, p, c)), cd))


def check_scene_pool(b, g, c, p, cd, rng, device, piles=False):
    """The scene-pool kernels against their plain versions on the card, and
    the gradient kernels bitwise equal in two runs, on scene_pool_inputs
    (or, with piles, scene_pool_pile_inputs). Returns the max abs errors
    (forward, backward) and the inputs."""
    from desire_tpu_torch.ops import scene_pool
    make = scene_pool_pile_inputs if piles else scene_pool_inputs
    fm, pos, gct = make(b, g, c, p, cd, rng, device)
    bf = cd == torch.bfloat16
    tag = (f"scene pool (B, G, C, P) = {(b, g, c, p)} {cd}"
           f"{' piles' if piles else ''}")
    got = scene_pool.scene_pool_fwd_cuda(fm, pos)
    ref = scene_pool.bilinear_pool_plain(fm, pos)
    e_f = check_close(f"{tag} forward", got, ref,
                      **(POOL_BF16_TOL if bf else POOL_TOL))
    if bf:
        # both round the four weights to bf16 and add the four products in
        # float32 in the same order: the same bits
        same = torch.equal(got, ref)
        print(f"  {tag} forward bitwise equal to the plain version = {same}",
              flush=True)
        if not same:
            raise AssertionError("the bf16 scene-pool forward is not "
                                 "bitwise equal to its plain version")
    d_map, d_pos = scene_pool.scene_pool_bwd_cuda(fm, pos, gct)
    r_map, r_pos = scene_pool.bilinear_pool_plain_bwd(fm, pos, gct)
    e_m = check_close(f"{tag} d_map", d_map, r_map,
                      **(POOL_BF16_TOL if bf else POOL_DMAP_TOL))
    e_p = check_close(f"{tag} d_pos", d_pos, r_pos, **POOL_DPOS_TOL)
    outside = (pos < 0) | (pos > 1)
    if float(d_pos[outside].abs().max()) != 0.0:
        raise AssertionError(f"{tag}: d_pos not zero outside [0, 1]")
    again = scene_pool.scene_pool_bwd_cuda(fm, pos, gct)
    same = torch.equal(again[0], d_map) and torch.equal(again[1], d_pos)
    print(f"  {tag} backward run twice: bitwise equal = {same}", flush=True)
    if not same:
        raise AssertionError("the scene-pool gradient kernels are not "
                             "deterministic")
    return e_f, max(e_m, e_p), (fm, pos, gct)


def unfused_phase(dev, smi, rng, params):
    """Phase 7: the layer-by-layer IOC path (use_social=False when serving
    and training, fused_train=False when training) through the scene-pool
    kernels. params: the flagship params. Returns the scene-pool kernels'
    results."""
    import torch.nn.functional as F
    from desire_tpu_torch.models.desire import (desire_forward,
                                                pack_kernel_weights)
    from desire_tpu_torch.ops import scene_pool
    from desire_tpu_torch.train.state import create_train_state
    from desire_tpu_torch.train.trainer import make_train_step

    # -- 7a. float32, small shapes ------------------------------------------
    print("scene-pool kernels, float32, small shapes:", flush=True)
    for b, g, c, p in ((2, 8, 8, 700), (2, 8, 32, 700), (3, 32, 32, 1000),
                       (2, 8, 12, 701), (2, 8, 6, 701), (2, 27, 32, 2001)):
        check_scene_pool(b, g, c, p, torch.float32, rng, dev)
    # thousands of points in a bucket: the gradient's long buckets
    for b, g, c in ((2, 32, 32), (2, 27, 12)):
        check_scene_pool(b, g, c, 14400, torch.float32, rng, dev, piles=True)
    # bfloat16 at small shapes: C = 8 and 32 take the forward's vector path
    # (P not a multiple of its points per warp), C = 12 its channel loop
    print("scene-pool kernels, bfloat16, small shapes:", flush=True)
    for b, g, c, p in ((2, 8, 8, 701), (2, 8, 32, 701), (2, 8, 12, 701)):
        check_scene_pool(b, g, c, p, torch.bfloat16, rng, dev)
    scfg = small_cfg(use_social=False)
    sp = make_params(scfg, dev)
    r_s = max(scfg.num_refine, 1) + 1            # pooling calls per forward
    print("compare float32 forward with use_social=False, card (kernels) vs "
          "CPU (plain):", flush=True)
    launches = check_forward_card_vs_cpu(scfg, sp, rng)
    check_launches("use_social=False forward", launches,
                   ("sgm_sample", "scene_pool_fwd"), 1)
    if launches["scene_pool_fwd"] != r_s:
        raise AssertionError(f"scene_pool_fwd launched "
                             f"{launches['scene_pool_fwd']} times, want {r_s}")
    print("one float32 training step with fused_train=False, card (kernels) "
          "vs CPU (plain):", flush=True)
    launches = check_step_card_vs_cpu(small_cfg(fused_train=False), sp, rng)
    check_launches("fused_train=False step", launches,
                   ("scene_pool_fwd", "scene_pool_bwd"), r_s)

    # -- 7b. bfloat16, flagship shape -----------------------------------------
    cfg = flagship_cfg()
    b, a, k, t = cfg.batch_size, cfg.max_num_obj, cfg.num_samples, cfg.pred_len
    g, c, p = cfg.scene_grid, cfg.scene_channels, a * k * t
    print("scene-pool kernels, bfloat16, flagship shape:", flush=True)
    pf_err, pb_err, pool_args = check_scene_pool(b, g, c, p, torch.bfloat16,
                                                 rng, dev)
    pb_err = max(pb_err, check_scene_pool(b, g, c, p, torch.bfloat16, rng,
                                          dev, piles=True)[1])
    # K = 50 lanes (B = 16): P = 36,000 points a row
    print("scene-pool kernels, bfloat16, K = 50, B = 16:", flush=True)
    pb_err = max(pb_err, check_scene_pool(16, g, c, a * 50 * t,
                                          torch.bfloat16, rng, dev)[1])
    r_f = max(cfg.num_refine, 1) + 1

    # -- 7c. serving with use_social=False --------------------------------------
    print("serve: Predictor at B=64, A=60, K=20, bf16, use_social=False",
          flush=True)
    cfg_ns = flagship_cfg(use_social=False)
    launches = serve_requests(params, cfg_ns, rng)
    check_launches("3 requests, use_social=False", launches, ("sgm_sample",),
                   3)
    check_launches("3 requests, use_social=False", launches,
                   ("scene_pool_fwd",), 3 * r_f)

    # -- 7d. training through the layer-by-layer IOC ---------------------------
    print("training: 3 run_epoch steps at B=64, A=60, K=20, bf16, "
          "layer-by-layer IOC", flush=True)
    cfg_u = flagship_cfg(fused_train=False)
    cfg_ur = flagship_cfg(fused_train=False, remat=True)
    loader = SyntheticLoader(cfg, rng, 3)
    runs = {}
    for label, c_ in (("fused_train=False", cfg_u),
                      ("fused_train=False, remat=True", cfg_ur),
                      ("use_social=False", cfg_ns)):
        runs[label] = epoch_run(c_, params, loader, label)
        check_launches(label, runs[label][1],
                       ("scene_pool_fwd", "scene_pool_bwd"), 3 * r_f)
        check_launches(label, runs[label][1], ("nll_fwd", "nll_bwd"), 3)
    plain_l = [m["loss"] for m in runs["fused_train=False"][0]]
    remat_l = [m["loss"] for m in runs["fused_train=False, remat=True"][0]]
    # the same batches, noise and arithmetic; only float32 sums whose order
    # is not fixed on the card (the occupancy splat's index_add_, cuDNN's
    # weight gradients) may differ, and through Adam's first steps
    diff = max(abs(x - y) / max(abs(x), 1e-6) for x, y in zip(plain_l,
                                                               remat_l))
    peak_off, peak_on = (runs["fused_train=False"][2],
                         runs["fused_train=False, remat=True"][2])
    print(f"  remat: losses off {plain_l} on {remat_l}, max relative "
          f"difference {diff:.3e} (<= 1e-3); peak device memory off "
          f"{peak_off / 2**30:.3f} GiB, on {peak_on / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    if diff > 1e-3:
        raise AssertionError("remat changed the training losses")
    launches = runs["fused_train=False"][1]

    # -- 7e. timing -----------------------------------------------------------
    print(f"layer-by-layer timing on {smi} (CUDA events, median):",
          flush=True)
    # the check's inputs put a quarter of the points on the border rows
    # (clamped), the gradient's worst case; the path's positions lie inside
    fm, pos_edge, gct = pool_args
    t_b_edge = time_ms(lambda: scene_pool.scene_pool_bwd_cuda(fm, pos_edge,
                                                              gct))
    pos = torch.as_tensor(rng.uniform(0.15, 0.85, (b, p, 2)).astype(
        np.float32), device=dev)
    t_f = time_ms(lambda: scene_pool.scene_pool_fwd_cuda(fm, pos))
    # the forward's other kernel, the channel loop, at a C whose rows are
    # not whole 16-byte pieces
    fm12 = fm[..., :12].contiguous()
    if scene_pool.fwd_vector_width(12, fm12.dtype, fm12.data_ptr(),
                                   pos.data_ptr(), 0) != 0:
        raise AssertionError("C = 12 in bfloat16 should take the channel "
                             "loop")
    t_f12 = time_ms(lambda: scene_pool.scene_pool_fwd_cuda(fm12, pos))
    t_f12_p = time_ms(lambda: scene_pool.bilinear_pool_plain(fm12, pos))
    t_f_p = time_ms(lambda: scene_pool.bilinear_pool_plain(fm, pos))
    t_b = time_ms(lambda: scene_pool.scene_pool_bwd_cuda(fm, pos, gct))
    t_b_p = time_ms(lambda: scene_pool.bilinear_pool_plain_bwd(fm, pos,
                                                               gct))
    # the library yardstick: grid_sample on the map in NCHW and the grid of
    # the clamped positions in [-1, 1] (in the map's dtype, as grid_sample
    # takes it), border padding, align_corners; its backward as one call
    fm_nchw = fm.permute(0, 3, 1, 2).contiguous()
    grid = (2.0 * torch.clamp(pos, 0.0, 1.0) - 1.0).to(fm.dtype).reshape(
        b, 1, p, 2)
    g_nchw = gct.permute(0, 2, 1).reshape(b, c, 1, p).contiguous()
    t_f_lib = time_ms(lambda: F.grid_sample(
        fm_nchw, grid, mode="bilinear", padding_mode="border",
        align_corners=True))
    t_b_lib = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        g_nchw, fm_nchw, grid, 0, 1, True, [True, True]))
    print(f"scene pool timing at (B, P, G, C) = {(b, p, g, c)}, positions "
          f"uniform in [0.15, 0.85]:", flush=True)
    print(f"scene_pool_fwd ms kernel {t_f:.4f} plain {t_f_p:.4f} grid_sample "
          f"{t_f_lib:.4f}", flush=True)
    print(f"scene_pool_fwd at C=12 (channel loop) ms kernel {t_f12:.4f} "
          f"plain {t_f12_p:.4f}", flush=True)
    print(f"scene_pool_bwd ms kernel {t_b:.4f} plain {t_b_p:.4f} "
          f"grid_sample backward {t_b_lib:.4f}; kernel on the check's "
          f"inputs (a quarter on the borders) {t_b_edge:.4f}", flush=True)
    for label, pp in (("uniform", pos), ("check inputs", pos_edge)):
        split = device_ms_by_kernel(
            lambda: scene_pool.scene_pool_bwd_cuda(fm, pp, gct))
        print(f"scene_pool_bwd on {label} positions, device ms by kernel "
              f"(torch.profiler): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in sorted(split.items())),
              flush=True)
    bx, bm, bids = flagship_windows(cfg, rng, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    packed_ns = pack_kernel_weights(params, cfg_ns, dev)
    time_in_turns(lambda: desire_forward(params, cfg_ns, bx, bm, bids,
                                         generator=gen,
                                         kernel_weights=packed_ns),
                  plain_ops, "forward_ms use_social=False")
    batch = tuple(torch.as_tensor(x, device=dev)
                  for x in synthetic_batch(cfg, rng))
    for name, c_ in (("train_step_ms fused_train=False", cfg_u),
                     ("train_step_ms fused_train=False remat=True", cfg_ur),
                     ("train_step_ms use_social=False", cfg_ns)):
        st0 = create_train_state(c_, params, seed=0)
        step_fn = make_train_step(c_, steps_per_epoch=190)
        t_k, _ = time_in_turns(lambda: step_fn(st0, *batch), plain_train_ops,
                               name, repeats=3, iters=2)
        if c_ is cfg_u:
            step_split("train_step fused_train=False", c_, params, batch,
                       t_k)

    cs = 2 if cfg.compute_dtype == "bfloat16" else 4
    rows = []
    for name, rep, err, t_k, t_p, t_l, bwd in (
            ("scene_pool_fwd", "desire_tpu/ops/scene_pool.py:75", pf_err,
             t_f, t_f_p, t_f_lib, False),
            ("scene_pool_bwd", "desire_tpu/ops/scene_pool.py:85", pb_err,
             t_b, t_b_p, t_b_lib, True)):
        b_ms, b_by = bound(*scene_pool_work(b, p, g, c, cs, backward=bwd),
                           "f32")
        rows.append({"name": name, "route": "cuda",
                     "source": "desire_tpu_torch/csrc/scene_pool.cu",
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l})
    return rows


# -- the training entry point ---------------------------------------------------

def write_sdd_tree(root, rng, scenes=2, videos=2, frames=3600, alive=60):
    """A synthetic SDD tree: <root>/scene<i>/video<j>/annotations_processed.csv
    in the dataset's transposed 4-row layout (frames, ids, xs, ys), a
    record every frame (30 fps) of agents walking straight lines in a
    1000 x 1000 px scene, each alive 1200-2400 frames, about `alive` of
    them at any frame."""
    for s in range(scenes):
        for v in range(videos):
            n = int(alive * (frames + 1800) / 1800)
            start = rng.integers(-1800, frames, n)
            life = rng.integers(1200, 2401, n)
            p0 = rng.uniform(100.0, 900.0, (n, 2))
            vel = rng.uniform(-0.5, 0.5, (n, 2))
            recs = []
            for i in range(n):
                f = np.arange(max(start[i], 0), min(start[i] + life[i], frames))
                if len(f):
                    xy = np.clip(p0[i] + vel[i] * (f - start[i])[:, None]
                                 + rng.normal(0, 0.3, (len(f), 2)), 0, 1000)
                    recs.append(np.column_stack(
                        [f, np.full(len(f), i + 1), xy]))
            rec = np.concatenate(recs)
            rec = rec[np.lexsort((rec[:, 1], rec[:, 0]))].T
            path = os.path.join(root, f"scene{s}", f"video{v}",
                                "annotations_processed.csv")
            os.makedirs(os.path.dirname(path))
            with open(path, "w") as fh:
                np.savetxt(fh, rec, fmt="%.2f", delimiter=",")
    return root


@contextlib.contextmanager
def deterministic_algorithms():
    """torch.use_deterministic_algorithms for the block, warning (not
    raising) where an op has no deterministic CUDA implementation; yields
    the list of warnings caught."""
    import warnings
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.benchmark = bench


def entry_step_ms(metrics_path, epochs):
    """Per-batch wall ms of the logged training steps of `epochs` in a
    metrics.jsonl (every batch logged), from run_epoch's running
    sec_per_batch: loader, copy, step and the log's sync."""
    rows = [json.loads(line) for line in open(metrics_path)]
    out = []
    for e in epochs:
        tr = [r for r in rows if r["event"] == "train" and r["epoch"] == e]
        done = [r["sec_per_batch"] * (i + 1) for i, r in enumerate(tr)]
        out += [1e3 * (b - a) for a, b in zip([0.0] + done[:-1], done)]
    return out


def entry_cfg(data_dir, save_dir):
    """Phase 8's configuration: the flagship at the dataset's geometry,
    holding out a video of each scene."""
    return flagship_cfg(data_dir=data_dir, save_dir=save_dir, subsample=12,
                        window_hop=2, eval_hop=4, holdout="video",
                        num_epochs=2, save_every=128, seed=0)


@contextlib.contextmanager
def recorded_serving_calls():
    """Record every call of the model's serving kernel call sites (sampler,
    IOC refine; under a mesh, the launches of the sharded wrappers on the
    rank's block), which go through as usual; yields the list of (kernel
    name, args, kwargs, outputs)."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.ops import ioc_fused, sgm_fused
    calls = []
    saved = ops.sgm_sample_decode, ops.ioc_refine

    def recorder(name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            calls.append((name, a, kw, out))
            return out
        return call
    ops.sgm_sample_decode = sgm_fused.sgm_sample_decode = recorder(
        "sgm_sample", saved[0])
    ops.ioc_refine = ioc_fused.ioc_refine = recorder("ioc_refine", saved[1])
    try:
        yield calls
    finally:
        ops.sgm_sample_decode = sgm_fused.sgm_sample_decode = saved[0]
        ops.ioc_refine = ioc_fused.ioc_refine = saved[1]


def check_recorded_calls(calls, verbose=True, path=False):
    """Hold each recorded bf16 serving kernel call (recorded_serving_calls)
    against its plain version on the inputs that call was given (BF16_TOL,
    BF16_MEAN_TOL; verbose=False prints only failures). path: the IOC
    calls are on the model's own inputs (phase 11), held by
    check_ioc_path_call, the first with a live agent also planting faults.
    Returns {kernel name: [calls checked, max abs error]} (on a path, the
    IOC's [calls, {output: bf16 max abs error}, {output: float32 max abs
    error}]), and under "faults" the planted faults' errors (the faults of
    ioc_faults_caught and the refine passes skipped)."""
    from desire_tpu_torch.ops import ioc_fused, sgm_fused
    out = {}
    for name, a, kw, got in calls:
        kw = {k: v for k, v in kw.items() if k != "weights"}
        if name == "sgm_sample":
            row = out.setdefault(name, [0, 0.0])
            ref = sgm_fused.sgm_sample_decode_plain(*a, **kw)
            for key, x, y in zip(("dec_h", "hx"), got, ref):
                row[1] = max(row[1], check_bf16(key, x, y, verbose))
        elif not path:
            row = out.setdefault(name, [0, 0.0])
            ref = ioc_fused.ioc_refine_plain(*a, **kw)
            for key, x, y in zip(("refined", "scores"), got, ref):
                row[1] = max(row[1], check_bf16(key, x, y, verbose))
        else:
            row, ref = out.setdefault(name, [0, {}, {}]), None
            p_ioc, p_scf, *data = a
            e16, e32, faults = check_ioc_path_call(
                lambda *d: ioc_fused.ioc_refine(p_ioc, p_scf, *d, **kw),
                lambda *d: ioc_fused.ioc_refine_plain(p_ioc, p_scf, *d,
                                                      **kw),
                data, (("refined", "refined"), ("scores", "scores")),
                plant=out.get("faults") is None, got=got,
                skipped=lambda *d: ioc_fused.ioc_refine(
                    p_ioc, p_scf, *d, **dict(kw, num_refine=0)))
            for errs, e in ((row[1], e16), (row[2], e32)):
                for key, x in e.items():
                    errs[key] = max(errs.get(key, 0.0), x)
            out["faults"] = out.get("faults") or faults
        row[0] += 1
        del ref
    if path and "ioc_refine" in out:
        faults_planted(out)
    return out


def faults_planted(out):
    if out.get("faults") is None:
        raise AssertionError("no IOC call with a live agent to plant the "
                             "faults in")


def widen(data):
    """IOC inputs (traj, dec_h, feat_map, live, fut_mask) with the
    activations in float32."""
    traj, dec_h, fmap, live, fut = data
    return traj, dec_h.float(), fmap.float(), live, fut


def f32_path_errors(got, ref, keys):
    """Max abs errors of float32 IOC outputs by name, and whether all lie
    within phase 6's float32 tolerances (F32_SCORE_TOL for the scores,
    F32_TOL for positions)."""
    errs, ok = {}, True
    for (label, key), x, y in zip(keys, got, ref):
        errs[label] = errors(x, y)[0]
        ok &= torch.allclose(x, y, **(F32_SCORE_TOL if key == "scores"
                                      else F32_TOL))
    return errs, ok


def check_ioc_path_call(kernel, plain, data, keys, plant, got=None,
                        skipped=None):
    """Hold one bf16 IOC kernel call on the model's own inputs (phases
    10-11) against its plain version, two ways: its bf16 outputs within
    PATH_BF16_TOL (max) and BF16_MEAN_TOL (mean); and the kernel run in
    float32 on the same inputs against the plain float32 computation,
    within phase 6's float32 tolerances, where the rounding noise that
    bf16 amplifies over the passes is gone. kernel(*inputs), plain(*inputs)
    compute in dec_h's dtype; data = (traj, dec_h, feat_map, live,
    fut_mask); keys: each output's (name, PATH_BF16_TOL entry); got: the
    bf16 kernel's outputs if already computed. With plant, also the planted
    faults (ioc_faults_caught; skipped as there). Returns ({name: bf16 max
    abs error}, {name: float32 max abs error}, the faults' errors or
    None)."""
    wide = widen(data)
    ref, ref32 = plain(*data), plain(*wide)
    e16 = {label: check_bf16(key, x, y, verbose=False, tol=PATH_BF16_TOL)
           for (label, key), x, y in zip(keys, got or kernel(*data), ref)}
    e32, ok = f32_path_errors(kernel(*wide), ref32, keys)
    if not ok:
        raise AssertionError(f"the float32 IOC kernel on the path's inputs "
                             f"disagrees with its plain version: {e32}")
    faults = (ioc_faults_caught(kernel, data, ref, ref32, keys, skipped)
              if plant else None)
    return e16, e32, faults


def ioc_faults_caught(kernel, data, ref, ref32, keys, skipped=None):
    """Planted faults that check_ioc_path_call must reject: the kernel on
    inputs with the fault, in bf16 and in float32, against the sound plain
    outputs ref and ref32 (keys as there). The faults: the positions read
    at bf16 (a lower-precision control), the scene map one cell off (an
    index fault of the pooling), one lane's last hidden state lost (a
    missed load) and, where skipped is given (the kernel with num_refine=0
    on the sound inputs), the refine passes skipped, so that only the
    re-score runs. Raises unless each fault moves some bf16 output past its
    PATH_BF16_TOL or BF16_MEAN_TOL, or some float32 output past phase 6's
    float32 tolerance. Returns {fault: {"bf16": max abs error by output,
    "float32": the same, "caught": by which}}, or None where no agent is
    live (a warm-up's empty window)."""
    traj, dec_h, fmap, live, fut = data
    if not bool((live > 0).any()):
        return None
    b0, a0 = (live > 0).nonzero()[0].tolist()
    lost = dec_h.clone()
    lost[b0, a0, 0, -1] = 0
    faults = {"positions at bf16": (kernel, (traj.bfloat16().float(),
                                             dec_h, fmap, live, fut)),
              "scene map one cell off": (kernel, (
                  traj, dec_h, fmap.roll(1, 2).contiguous(), live, fut)),
              "a lane's last hidden state lost": (kernel, (
                  traj, lost, fmap, live, fut))}
    if skipped is not None:
        faults["the refine passes skipped"] = (skipped, data)
    out = {}
    for fault, (fn, inputs) in faults.items():
        e16, by_bf16 = {}, False
        for (label, key), x, y in zip(keys, fn(*inputs), ref):
            mx, mean = errors(x, y)
            e16[label] = mx
            by_bf16 |= mx > PATH_BF16_TOL[key] or mean > BF16_MEAN_TOL[key]
        e32, ok = f32_path_errors(fn(*widen(inputs)), ref32, keys)
        caught = [w for w, c in (("bf16", by_bf16), ("float32", not ok)) if c]
        if not caught:
            raise AssertionError(f"the planted fault '{fault}' passes the "
                                 f"path check: bf16 {e16}, float32 {e32}")
        out[fault] = {"bf16": e16, "float32": e32, "caught": caught}
    return out


@contextlib.contextmanager
def recorded_training_calls():
    """Record the inputs of every call of the training kernels' call
    sites: the trainable IOC (``ops.ioc_refine_train``; under a mesh, its
    launches on the rank's lane block inside ``ioc_refine_train_sharded``),
    the NLL (``ops.bivariate_nll_sum``) and the scene pool of the layer-by-
    layer IOC (``ops.bilinear_pool``, with the gradient that reaches its
    output, appended to its args when the backward runs); all go through as
    usual. The training steps run eagerly meanwhile: a graphed step's
    replays launch the kernels its capture recorded with no call to record
    (phase 11d holds the graphed step against the eager one). Yields the
    list of (kernel name, detached args, kwargs)."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.ops import ioc_bwd
    from desire_tpu_torch.train import graphed
    calls = []
    saved = ops.ioc_refine_train, ops.bivariate_nll_sum, ops.bilinear_pool
    engages = graphed.engages

    def detach(x):
        if isinstance(x, dict):
            return {k: detach(v) for k, v in x.items()}
        if isinstance(x, list):
            return [detach(v) for v in x]
        return x.detach() if torch.is_tensor(x) else x

    def recorder(name, fn):
        def call(*a, **kw):
            calls.append((name, detach(list(a)), kw))
            return fn(*a, **kw)
        return call

    def pool(feat_map, pos):
        args = [feat_map.detach(), pos.detach().float()]
        calls.append(("scene_pool", args, {}))
        out = saved[2](feat_map, pos)
        if out.requires_grad:
            out.register_hook(lambda g: args.append(g.detach()))
        return out
    ops.ioc_refine_train = ioc_bwd.ioc_refine_train = recorder(
        "ioc_refine_train", saved[0])
    ops.bivariate_nll_sum = recorder("nll", saved[1])
    ops.bilinear_pool = pool
    graphed.engages = lambda *a, **kw: False
    try:
        yield calls
    finally:
        ops.ioc_refine_train = ioc_bwd.ioc_refine_train = saved[0]
        ops.bivariate_nll_sum, ops.bilinear_pool = saved[1:]
        graphed.engages = engages


# each recorded training call site and the launches it makes, one each
TRAINING_CALL_LAUNCHES = {"ioc_refine_train": ("ioc_refine_train",
                                               "ioc_refine_bwd"),
                          "nll": ("nll_fwd", "nll_bwd"),
                          "scene_pool": ("scene_pool_fwd",)}


def check_training_calls(calls, cfg, launches, seed=0):
    """Hold each recorded bf16 training kernel call
    (recorded_training_calls) against its plain version on the inputs it
    was given, after checking that every launch of these kernels in
    ``launches`` (the run's counts) has its recorded call, so that no
    launch goes unchecked: the IOC training forward kernel's refined
    positions, float32 scores and every pass's positions
    (check_ioc_path_call; the first call also plants faults) and, for a
    test loss of the training op's outputs, its backward kernel against
    autograd through the plain version, leaf by leaf (BF16_GRAD_REL_*), as
    phase 6b; the NLL forward (NLL_TOL) and its backward kernel for a
    random cotangent (NLL_GRAD_TOL); the scene pool's
    forward (bitwise for bf16, as phase 7) and its gradient kernel for the
    gradient its output received (POOL_*_TOL). Prints only failures.
    Returns {kernel name: {"calls", "fwd" and "bwd" max abs errors (the
    IOC's "fwd" and "fwd32", bf16 and float32, by output)}}, and under
    "faults" the planted faults' errors.

    The forward is compared before the training op rounds its scores to
    the compute dtype (the same cast on both sides): on the path's data
    scores reach |s| ~ 16, where one bf16 step is 0.125."""
    from desire_tpu_torch.ops import ioc_fused, nll, scene_pool
    counts = {name: sum(c[0] == name for c in calls)
              for name in TRAINING_CALL_LAUNCHES}
    counts["scene_pool_bwd"] = sum(c[0] == "scene_pool" and len(c[1]) == 3
                                   for c in calls)
    for name, kernels in TRAINING_CALL_LAUNCHES.items():
        for k in kernels:
            if launches[k] != counts[name]:
                raise AssertionError(f"{launches[k]} launches of {k}, "
                                     f"{counts[name]} recorded {name} calls")
    if launches["scene_pool_bwd"] != counts["scene_pool_bwd"]:
        raise AssertionError("a scene_pool_bwd launch without its recorded "
                             "call")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    ioc_keys = (("refined", "refined"), ("scores", "scores"),
                ("iters", "refined"))
    out = {}
    for name, a, kw in calls:
        row = out.setdefault(name, {"calls": 0, "fwd": 0.0, "bwd": 0.0})
        if name == "ioc_refine_train" and not row["calls"]:
            row.update(fwd={}, fwd32={})
        row["calls"] += 1
        if name == "ioc_refine_train":
            p_ioc, p_scf, *data = a
            traj, dec_h, fmap, live, fut = data
            fwd = (traj.float().contiguous(), dec_h.contiguous(),
                   fmap.contiguous(), live.float().contiguous(),
                   fut.float().contiguous())
            w = {cd: ioc_fused.pack_ioc(p_ioc, p_scf, cd, traj.device,
                                        traj.shape[1])
                 for cd in {dec_h.dtype, torch.float32}}
            e16, e32, faults = check_ioc_path_call(
                lambda *d: ioc_fused.ioc_refine_cuda(
                    w[d[1].dtype], *d, collect_iters=True, **kw),
                lambda *d: ioc_fused.ioc_refine_plain(
                    p_ioc, p_scf, *d, collect_iters=True, **kw),
                fwd, ioc_keys, plant=out.get("faults") is None)
            for label in e16:
                row["fwd"][label] = max(row["fwd"].get(label, 0.0),
                                        e16[label])
                row["fwd32"][label] = max(row["fwd32"].get(label, 0.0),
                                          e32[label])
            out["faults"] = out.get("faults") or faults
            params = {"ioc": p_ioc, "scf": p_scf}
            args = [x.clone().requires_grad_(i < 3)
                    for i, x in enumerate(data)]
            b, na, k = traj.shape[:3]
            wts = torch.randn((b, na, k), generator=gen).to(traj.device)
            freeze = kw.get("social_freeze", False)
            _, g_k = ioc_train_grads(params, cfg, args, wts, kernel=True,
                                     social_freeze=freeze)
            _, g_p = ioc_train_grads(params, cfg, args, wts, kernel=False,
                                     social_freeze=freeze)
            row["bwd"] = max(row["bwd"], *(check_grads_bf16(
                leaf, g_k[leaf], g_p[leaf], verbose=False) for leaf in g_p))
            del g_k, g_p
        elif name == "nll":
            raw5, target, mask = a
            got = nll.nll_fwd_cuda(raw5, target, mask)
            ref = nll.bivariate_nll_plain(raw5, target, mask)
            if not torch.allclose(got, ref, **NLL_TOL):
                raise AssertionError("a recorded NLL forward call disagrees "
                                     "with its plain version")
            g = torch.randn(got.shape, generator=gen).to(got.device)
            got_b = nll.nll_bwd_cuda(raw5, target, mask, g)
            r = raw5.clone().requires_grad_(True)
            ref_b, = torch.autograd.grad(
                (nll.bivariate_nll_plain(r, target, mask) * g).sum(), [r])
            if not torch.allclose(got_b, ref_b, **NLL_GRAD_TOL):
                raise AssertionError("a recorded NLL backward call disagrees"
                                     " with autograd through its plain "
                                     "version")
            row["fwd"] = max(row["fwd"], errors(got, ref)[0])
            row["bwd"] = max(row["bwd"], errors(got_b, ref_b)[0])
        else:
            fm, pos, *g = a
            bf = fm.dtype == torch.bfloat16
            got = scene_pool.scene_pool_fwd_cuda(fm.contiguous(),
                                                 pos.contiguous())
            ref = scene_pool.bilinear_pool_plain(fm, pos)
            if not (torch.equal(got, ref) if bf
                    else torch.allclose(got, ref, **POOL_TOL)):
                raise AssertionError("a recorded scene-pool forward call "
                                     "disagrees with its plain version")
            row["fwd"] = max(row["fwd"], errors(got, ref)[0])
            if g:
                g = g[0].to(fm.dtype).contiguous()
                d_map, d_pos = scene_pool.scene_pool_bwd_cuda(
                    fm.contiguous(), pos.contiguous(), g)
                r_map, r_pos = scene_pool.bilinear_pool_plain_bwd(fm, pos, g)
                if not (torch.allclose(d_map.float(), r_map.float(), **(
                        POOL_BF16_TOL if bf else POOL_DMAP_TOL))
                        and torch.allclose(d_pos, r_pos, **POOL_DPOS_TOL)):
                    raise AssertionError("a recorded scene-pool gradient "
                                         "call disagrees with its plain "
                                         "version")
                row["bwd"] = max(row["bwd"], errors(d_map, r_map)[0],
                                 errors(d_pos, r_pos)[0])
    if "ioc_refine_train" in out:
        faults_planted(out)
    return out


def resume_check(data_dir, tmp):
    """Phase 8d, in a process of its own started with cuBLAS's
    deterministic workspace (CUBLAS_WORKSPACE_CONFIG): 4 steps of the entry
    point at once against 2 steps, a stop and 2 resumed steps, under
    deterministic algorithms; params and Adam's moments must agree bit for
    bit, or within the step tolerance where an op of the path has no
    deterministic CUDA implementation (named)."""
    from desire_tpu_torch.train import run
    from desire_tpu_torch.train.state import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("resume: 4 steps at once vs 2 steps, stop, resume, 2 steps "
          f"(deterministic algorithms, CUBLAS_WORKSPACE_CONFIG="
          f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')})", flush=True)
    cfg = entry_cfg(data_dir, None).replace(num_epochs=1)
    runs = {}
    with deterministic_algorithms() as caught:
        for name, batches, resume in (("whole", 4, False),
                                      ("stopped", 2, False),
                                      ("resumed", 2, True)):
            sd = os.path.join(tmp, "whole" if name == "whole" else "parts")
            runs[name] = run.train(cfg.replace(save_dir=sd), resume=resume,
                                   eval_every=0, max_train_batches=batches,
                                   device="cuda")
    a, b = runs["whole"], runs["resumed"]
    leaves = [(x, y) for f in ("params", "mu", "nu")
              for x, y in zip(tree_leaves(getattr(a, f)),
                              tree_leaves(getattr(b, f)))]
    bitwise = all(torch.equal(x, y) for x, y in leaves) and \
        (a.step, a.count) == (b.step, b.count) == (4, 4)
    nondet = sorted({str(w.message).split("\n")[0] for w in caught
                     if "deterministic" in str(w.message)})
    print(f"  steps {a.step} / {b.step}; params, Adam moments bitwise "
          f"equal: {bitwise}; ops without a deterministic CUDA "
          f"implementation: {nondet or 'none'}", flush=True)
    if not bitwise:
        worst = max(float((x - y).abs().max()) for x, y in leaves)
        moved = sum(int(((x - y).abs() > 1e-4).sum()) for x, y in leaves)
        share = moved / sum(x.numel() for x, _ in leaves)
        lim = 4 * STEP_MAX_ABS(cfg.learning_rate)
        print(f"  resumed vs whole: max_abs_err={worst:.3e} (<= "
              f"{lim:.3e}), share off by > 1e-4 {share:.2e} (<= "
              f"{STEP_FLIP_SHARE})", flush=True)
        if not nondet or worst > lim or share > STEP_FLIP_SHARE:
            raise AssertionError("the resumed run parts from the "
                                 "uninterrupted one")


def entry_point_phase(dev, smi, rng, tmp):
    """Phase 8: the port's training entry point (train.run.train) on a
    synthetic SDD tree at the flagship width: train, checkpoint, evaluate
    on the held-out split, keep and re-select the best checkpoint, fit the
    rank blend, resume bit for bit, serve the best checkpoint. tmp: the
    phase's directory (the caller removes it): the tree in tmp/data, the
    index cache in tmp/cache."""
    import dataclasses
    from desire_tpu_torch import ops
    from desire_tpu_torch.data import loader as loader_mod
    from desire_tpu_torch.data.native import build as native_build
    from desire_tpu_torch.data.native import fast_csv
    from desire_tpu_torch.eval.sampler import evaluate
    from desire_tpu_torch.models.desire import desire_forward
    from desire_tpu_torch.serve import Predictor
    from desire_tpu_torch.train import checkpoint as ckpt_mod
    from desire_tpu_torch.train import run
    from desire_tpu_torch.train.trainer import (batch_to_device,
                                                make_eval_forward)

    t_phase = time.perf_counter()
    old_cache = os.environ.get("DESIRE_TORCH_CACHE_DIR")
    os.environ["DESIRE_TORCH_CACHE_DIR"] = os.path.join(tmp, "cache")
    try:
        # -- 8a. data ---------------------------------------------------------
        try:
            native_build.build(verbose=False)
            fast_csv._lib = None
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            print(f"  native CSV parser not built ({e}): the Python reader "
                  f"reads the CSVs", flush=True)
        t0 = time.perf_counter()
        data_dir = write_sdd_tree(os.path.join(tmp, "data"), rng)
        print(f"  synthetic SDD tree: 2 scenes x 2 videos x 3600 frames in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        save_dir = os.path.join(tmp, "run")
        cfg = entry_cfg(data_dir, save_dir)

        # -- 8b. train through the entry point ------------------------------
        print("training entry point: 2 epochs x 4 batches at B=64, A=60, "
              "K=20, bf16; eval on 2 held-out batches an epoch, final "
              "selection of 2 on the whole held-out split", flush=True)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state = run.train(cfg, eval_every=1, max_eval_batches=2,
                          final_select_top=2, max_train_batches=4,
                          device="cuda", log_every=1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        print(f"  train(): {train_s:.1f} s, step {state.step}; launches "
              f"{launches}", flush=True)
        events = [json.loads(line) for line in
                  open(os.path.join(save_dir, "metrics.jsonl"))]
        kinds = {}
        for e in events:
            kinds.setdefault(e["event"], []).append(e)
        for need in ("data", "eval_data", "train", "epoch", "eval", "best",
                     "final_select_candidate", "final_select",
                     "rank_blend_fit"):
            if need not in kinds:
                raise AssertionError(f"no '{need}' event in metrics.jsonl")
        fit = kinds["rank_blend_fit"][0]
        if "error" in fit:
            raise AssertionError(f"rank_blend_fit failed: {fit['error']}")
        for sub in ("best", "best_pool"):
            if not ckpt_mod.CheckpointManager(
                    os.path.join(save_dir, sub)).all_steps():
                raise AssertionError(f"no checkpoint in {sub}/")
        evs = kinds["eval"]
        if state.step != 8 or len(evs) != 2 or not all(
                np.isfinite(e["minADE_px"]) and e["num_agents"] > 0
                for e in evs):
            raise AssertionError("8 steps and 2 finite evals expected")
        print(f"  data: {kinds['data'][0]}", flush=True)
        print(f"  evals: {[round(e['minADE_px'], 3) for e in evs]} px "
              f"minADE; final selection {kinds['final_select'][0]}; rank "
              f"blend {fit['blend']}", flush=True)
        # 8 training steps; eval forwards: 2 epochs x 2 batches, 2
        # candidates x the whole held-out split, the blend fit's slice
        check_launches("the entry point's training steps", launches,
                       ("ioc_refine_train", "ioc_refine_bwd", "nll_fwd",
                        "nll_bwd"), 8)
        check_launches("the entry point's evaluation", launches,
                       ("sgm_sample", "ioc_refine"), 4 + 2 * 3)

        # -- 8c. the short held-out batch against the plain versions --------
        eval_loader = loader_mod.SDDLoader(cfg.replace(window_hop=4),
                                           split="heldout",
                                           drop_remainder=False)
        short = list(eval_loader.epoch_batches(0))[-1]
        bs = short.batch_size
        print(f"short held-out batch: B = {bs} of {eval_loader.num_windows} "
              f"windows", flush=True)
        if bs == cfg.batch_size:
            raise AssertionError("the held-out split has no short batch")
        params = state.params
        xy, mask, ids = batch_to_device(short, dev)
        n = bs * cfg.max_num_obj
        # the batch's bf16 forward as evaluate runs it, its kernels' calls
        # recorded, then each held against its plain version on the very
        # inputs it was given
        eps = torch.as_tensor(rng.standard_normal(
            (n, cfg.num_samples, cfg.latent_size)).astype(np.float32),
            device=dev)
        with recorded_serving_calls() as calls:
            make_eval_forward(cfg)(params, xy, mask, ids, eps=eps)
        if sorted(c[0] for c in calls) != ["ioc_refine", "sgm_sample"]:
            raise AssertionError(f"the short batch's forward called "
                                 f"{[c[0] for c in calls]}")
        check_recorded_calls(calls)
        del calls
        # the whole forward of the batch in float32: kernels vs plain
        cfg32 = cfg.replace(compute_dtype="float32")
        eps = torch.as_tensor(rng.standard_normal(
            (n, cfg.num_samples, cfg.latent_size)).astype(np.float32),
            device=dev)
        outs = {}
        for name, ctx in (("kernels", contextlib.nullcontext),
                          ("plain", plain_ops)):
            with ctx():
                outs[name] = desire_forward(params, cfg32, xy, mask, ids,
                                            eps=eps)
        for key, tol in (("sgm_traj", F32_TOL), ("refined_traj", F32_TOL),
                         ("scores", F32_SCORE_TOL)):
            check_close(f"short batch forward {key}", outs["kernels"][key],
                        outs["plain"][key], **tol)
        del outs

        # -- 8d. resume bit for bit -----------------------------------------
        # in a process of its own: cuBLAS reads its deterministic workspace
        # setting when it starts, and the other phases keep the default
        sys.stdout.flush()
        release_card()
        rc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--resume-check",
             data_dir, tmp], env=dict(os.environ,
                                      CUBLAS_WORKSPACE_CONFIG=":4096:8"),
            timeout=600).returncode
        if rc != 0:
            raise AssertionError(f"the resume check exited with {rc}")

        # -- 8e. serve the best checkpoint -----------------------------------
        # the caller's config (bf16, K = 20) under the saved geometry
        pred = Predictor.from_checkpoint(save_dir, best=True, device="cuda",
                                         cfg=cfg, max_windows=64)
        best_cfg = ckpt_mod.load_config(os.path.join(save_dir, "best"))
        if pred.cfg.rank_blend_fit != best_cfg.rank_blend_fit \
                or best_cfg.rank_blend_fit != fit["blend"]:
            raise AssertionError("best/ does not carry the fitted blend")
        wins = synthetic_windows(cfg, rng, 64)
        res = pred.predict_windows(wins, scales=1000.0)
        for (oxy, _, wids), r in zip(wins, res):
            na = min(len(wids), cfg.max_num_obj)
            if r["traj"].shape != (na, cfg.num_samples, cfg.pred_len, 2) \
                    or not np.isfinite(r["traj"]).all():
                raise AssertionError("a served forecast of the best "
                                     "checkpoint is malformed")
        print(f"  served 64 windows from best/ (step "
              f"{ckpt_mod.CheckpointManager(os.path.join(save_dir, 'best')).latest_step()}"
              f", rank blend {pred.cfg.rank_blend_fit}): stats "
              f"{pred.stats()}", flush=True)

        # -- 8f. timing -------------------------------------------------------
        step_ms = entry_step_ms(os.path.join(save_dir, "metrics.jsonl"),
                                (0, 1))
        tr_loader = loader_mod.SDDLoader(cfg, split="train")
        t0 = time.perf_counter()
        nb = sum(1 for _ in tr_loader.epoch_batches(0))
        load_ms = (time.perf_counter() - t0) * 1e3 / nb
        mgr = ckpt_mod.CheckpointManager(os.path.join(tmp, "timing"),
                                         keep=1)
        save_ms = []
        for i in range(3):
            st = dataclasses.replace(state, step=100 + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(st, tr_loader.state, cfg)
            save_ms.append((time.perf_counter() - t0) * 1e3)
        # the card's share of a step through run_epoch (loader, copy, step,
        # the log's sync at log_every=1), over 4 batches, by log cadence
        from torch.profiler import ProfilerActivity, profile
        from desire_tpu_torch.train.trainer import make_train_step, run_epoch
        step_fn = make_train_step(cfg, tr_loader.num_batches)
        busy = {}
        for every in (1, 20):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run_epoch(state, tr_loader, 1, step_fn, log_every=every,
                          log_fn=lambda m, st: None, max_batches=4)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / 4
            busy[every] = (sum(e.self_device_time_total
                               for e in prof.key_averages()
                               if e.device_type
                               == torch.autograd.DeviceType.CUDA) / 4e3,
                           wall)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate(params, cfg, eval_loader)
        eval_ms = (time.perf_counter() - t0) * 1e3 / eval_loader.num_batches
        print(f"entry point on {smi} (host clock): step median "
              f"{statistics.median(step_ms):.3f} ms over {len(step_ms)} "
              f"logged steps ({[round(x, 1) for x in step_ms]}), "
              f"{1e3 * len(step_ms) / sum(step_ms):.2f} steps/s; loader "
              f"{load_ms:.3f} ms a batch; checkpoint save "
              f"{statistics.median(save_ms):.3f} ms (median of 3); eval "
              f"{eval_ms:.3f} ms a batch ({eval_loader.num_batches} "
              f"batches); CSV reader {tr_loader.reader}", flush=True)
        for every, (b_ms, w_ms) in busy.items():
            print(f"run_epoch on {smi}, 4 batches, log_every={every}: "
                  f"{w_ms:.3f} ms a step (host clock), card busy "
                  f"{b_ms:.3f} ms (idle share {1 - b_ms / w_ms:.3f})",
                  flush=True)
        print(f"phase 8: {time.perf_counter() - t_phase:.1f} s", flush=True)

        # -- 9. evaluation and forecasting on phase 8's tree and best/ -------
        return forecast_phase(dev, smi, rng, cfg, data_dir, save_dir,
                              eval_loader, tmp)
    finally:
        if old_cache is None:
            os.environ.pop("DESIRE_TORCH_CACHE_DIR", None)
        else:
            os.environ["DESIRE_TORCH_CACHE_DIR"] = old_cache


# the keys of the JAX package's evaluate.py result line at phase 9's flags
# (desire_tpu/eval/sampler.py evaluate: --horizons, --calibration with the
# train-split fit); "rank_blend" only where the blend is not 0, the along-
# and cross-track errors where a step has a ground-truth tangent
EVAL_KEYS = {"minADE_px", "minFDE_px", "top1ADE_px", "num_agents", "K",
             "sgm_minADE_px", "sgm_minFDE_px", "rank_top1_pctile",
             "rank_score_corr", "horizons", "calibration"}
EVAL_OPTIONAL_KEYS = {"rank_blend", "alongADE_px", "crossADE_px"}
EVAL_HORIZON_KEYS = {"minADE_px", "minFDE_px", "top1ADE_px", "top1FDE_px",
                     "minADE_px_fifth", "minFDE_px_fifth", "num_agents"}
EVAL_CALIBRATION_KEYS = {"pit_ks", "coverage_50", "coverage_90", "pit_hist",
                         "sigma_temp", "pit_ks_cal", "coverage_50_cal",
                         "coverage_90_cal", "sigma_fit"}
DUMP_KEYS = ("obs_xy", "obs_mask", "fut_xy", "fut_mask", "traj", "scores",
             "best", "live", "video", "scale")


def check_eval_result(res, horizons):
    """evaluate's result line: the JAX script's keys, finite numbers."""
    keys = set(res)
    if not EVAL_KEYS <= keys <= EVAL_KEYS | EVAL_OPTIONAL_KEYS:
        raise AssertionError(f"evaluate's result keys {sorted(keys)}")
    if sorted(res["horizons"]) != [f"{float(h):.1f}s" for h in horizons] \
            or any(set(v) != EVAL_HORIZON_KEYS
                   for v in res["horizons"].values()):
        raise AssertionError(f"evaluate's horizons {res['horizons']}")
    if set(res["calibration"]) != EVAL_CALIBRATION_KEYS:
        raise AssertionError(f"evaluate's calibration keys "
                             f"{sorted(res['calibration'])}")

    def numbers(x):
        if isinstance(x, dict):
            return [y for v in x.values() for y in numbers(v)]
        if isinstance(x, list):
            return [y for v in x for y in numbers(v)]
        return [x]
    vals = np.asarray(numbers(res), np.float64)
    if not np.isfinite(vals).all() or res["num_agents"] <= 0:
        raise AssertionError("evaluate's result has a non-finite value or "
                             "no agents")


def check_forecast_line(rec, cfg, top_k=5):
    """One forecast_to_json line: agents with id, top1 (Tf, 2), the top_k
    scores and hypotheses (top_k, Tf, 2) (at most K of them), finite, in
    the scene's pixels."""
    top_k = min(top_k, cfg.num_samples)
    if not rec["agents"]:
        raise AssertionError("a forecast without agents")
    for ag in rec["agents"]:
        top1 = np.asarray(ag["top1"], np.float64)
        hyp = np.asarray(ag["hypotheses"], np.float64)
        if set(ag) != {"id", "top1", "scores", "hypotheses"} \
                or top1.shape != (cfg.pred_len, 2) \
                or hyp.shape != (top_k, cfg.pred_len, 2) \
                or len(ag["scores"]) != top_k or ag["id"] == 0 \
                or not (np.isfinite(top1).all() and np.isfinite(hyp).all()
                        and np.isfinite(ag["scores"]).all()) \
                or np.abs(top1).max() > 3000.0:
            raise AssertionError(f"a malformed forecast of agent "
                                 f"{ag.get('id')}")


def forecast_phase(dev, smi, rng, cfg, data_dir, save_dir, eval_loader,
                   tmp):
    """Phase 9: the evaluation and forecasting entry points on phase 8's
    tree and its best/ checkpoint at the flagship width: (a) ``python -m
    desire_tpu_torch.evaluate`` with the calibration fit, horizons and a
    dump, in a process of its own and in this one; (b) ``predict`` in file
    mode over the tree's CSVs and in stream mode over a video's frames;
    (c) ``make_rollout`` of two chunks on a held-out batch; (d)
    ``bench_serve``; (e) the imagery raster through a serving forward and
    a training step. Every serving kernel call of (a)-(c) and (e) is held
    against its plain version on its own inputs. Returns the kernels'
    launches in (a)-(e)."""
    import glob
    import io
    from desire_tpu_torch import bench_serve, ops
    from desire_tpu_torch import evaluate as evaluate_cli
    from desire_tpu_torch import predict as predict_cli
    from desire_tpu_torch.data.loader import (SDDLoader,
                                              _native_or_python_reader)
    from desire_tpu_torch.data.windows import build_video_index
    from desire_tpu_torch.eval.sampler import evaluate, make_rollout
    from desire_tpu_torch.models.desire import desire_forward
    from desire_tpu_torch.serve import Predictor, StreamServer
    from desire_tpu_torch.train import checkpoint as ckpt_mod
    from desire_tpu_torch.train.state import create_train_state, tree_leaves
    from desire_tpu_torch.train.trainer import (batch_to_device,
                                                make_train_step)

    t_phase = time.perf_counter()
    launches = {}

    @contextlib.contextmanager
    def counted():
        """The kernels' launches of the block, added to the phase's."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        yield
        torch.cuda.synchronize()
        for k, v in ops.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v

    def hold(calls, label):
        res = check_recorded_calls(calls, verbose=False)
        if sorted(res) != ["ioc_refine", "sgm_sample"]:
            raise AssertionError(f"{label}: recorded {sorted(res)}")
        print(f"  {label}: " + "; ".join(
            f"{k} {n} calls, max_abs_err {e:.3e}"
            for k, (n, e) in sorted(res.items()))
            + " against the plain versions: ok", flush=True)

    def run_cli(main, argv, stdin=""):
        """An entry point's main(argv) in this process: (stdout lines,
        stderr lines, wall s)."""
        out, err = io.StringIO(), io.StringIO()
        saved = sys.stdin
        sys.stdin = io.StringIO(stdin)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                main(argv)
        finally:
            sys.stdin = saved
        torch.cuda.synchronize()
        return (out.getvalue().splitlines(), err.getvalue().splitlines(),
                time.perf_counter() - t0)

    best_dir = os.path.join(save_dir, "best")
    cfg_b = ckpt_mod.overlay_geometry(cfg, ckpt_mod.load_config(best_dir))
    params = ckpt_mod.restore_params(best_dir, cfg_b, dev)
    horizons = (1, 2, 3, 4)

    # -- 9a. evaluate -------------------------------------------------------
    argv = ["--device", dev.type, "--save_dir", save_dir, "--data_dir",
            data_dir, "--best", "1", "--batch_size", str(cfg.batch_size),
            "--num_samples", str(cfg.num_samples), "--compute_dtype",
            cfg.compute_dtype, "--calibration", "1", "--calib_fit_batches", "2", "--horizons",
            ",".join(map(str, horizons))]
    dump = os.path.join(tmp, "dump.npz")
    print("evaluate: python -m desire_tpu_torch.evaluate "
          + " ".join(argv[2:]) + " --dump ...", flush=True)
    sys.stdout.flush()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "desire_tpu_torch.evaluate", *argv, "--dump",
         dump], cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stderr[-4000:], flush=True)
        raise AssertionError(f"evaluate exited with {proc.returncode}")
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    header, dumped, result = lines[0], lines[1], lines[-1]
    check_eval_result(result, horizons)
    # --dump_batches 4 (the default)
    n_win = min(header["windows"], 4 * cfg.batch_size)
    z = np.load(dump)
    a, k, to, tf = cfg.max_num_obj, cfg.num_samples, cfg.obs_len, cfg.pred_len
    want = {"obs_xy": (n_win, a, to, 2), "obs_mask": (n_win, a, to),
            "fut_xy": (n_win, a, tf, 2), "fut_mask": (n_win, a, tf),
            "traj": (n_win, a, k, tf, 2), "scores": (n_win, a, k),
            "best": (n_win, a, tf, 2), "live": (n_win, a),
            "video": (n_win,), "scale": (n_win,)}
    if dumped["windows"] != n_win or tuple(z.files) != DUMP_KEYS or any(
            z[key].shape != shape for key, shape in want.items()) or any(
            z[key].dtype != np.float32 for key in DUMP_KEYS
            if key != "video") or not np.isfinite(z["traj"]).all():
        raise AssertionError(f"the dump: {dumped}, "
                             f"{[(f, z[f].shape, z[f].dtype) for f in z.files]}")
    print(f"  exit 0 in {cli_s:.1f} s; {header}; minADE "
          f"{result['minADE_px']:.3f} px, top-1 {result['top1ADE_px']:.3f}, "
          f"coverage@50 {result['calibration']['coverage_50']:.3f} raw, "
          f"{result['calibration']['coverage_50_cal']:.3f} at tau "
          f"{result['calibration']['sigma_temp']}; dump {n_win} windows, "
          f"traj {z['traj'].shape} float32", flush=True)
    # the same run in this process: its kernel calls, held against plain
    with counted(), recorded_serving_calls() as calls:
        _, _, eval_s = run_cli(evaluate_cli.main, argv + [
            "--dump", os.path.join(tmp, "dump_in.npz")])
    n_fwd = len(calls) // 2
    hold(calls, "evaluate")
    del calls
    # the held-out pass as the entry point makes it (horizons, calibration
    # at the fitted temperature), timed alone
    tau = result["calibration"]["sigma_temp"]
    with counted():
        t0 = time.perf_counter()
        evaluate(params, cfg_b, eval_loader, horizons=horizons,
                 calibration=True, rank_blend=max(cfg_b.rank_blend_fit, 0.0),
                 sigma_temps=(1.0, tuple(tau) if isinstance(tau, list)
                              else tau))
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3 / eval_loader.num_batches

    # -- 9b. predict: file mode, stream mode -----------------------------------
    csvs = sorted(glob.glob(os.path.join(data_dir, "*", "*",
                                         "annotations_processed.csv")))
    with counted(), recorded_serving_calls() as calls:
        out, err, file_s = run_cli(predict_cli.main, [
            "--device", dev.type, "--save_dir", save_dir, "--best", "1",
            "--num_samples", str(cfg.num_samples), "--csv", *csvs])
    recs = [json.loads(x) for x in out]
    if len(csvs) != 4 or [r["video"] for r in recs] != csvs:
        raise AssertionError(f"{len(recs)} file-mode forecasts for "
                             f"{len(csvs)} CSVs")
    for r in recs:
        if set(r) != {"frame", "step", "agents", "video", "scale"}:
            raise AssertionError(f"file-mode keys {sorted(r)}")
        check_forecast_line(r, cfg_b)
    file_stats = json.loads(err[-1])
    hold(calls, f"predict file mode ({len(recs)} CSVs, "
                f"{sum(len(r['agents']) for r in recs)} agents)")
    del calls
    # stream mode over (obs_len + 2) * subsample frames of one video from
    # frame 1200, with the agents of each frame
    frames, ids, xs, ys = _native_or_python_reader(True)(csvs[0])
    v = build_video_index(csvs[0], frames, ids, np.stack([xs, ys], -1),
                          subsample=cfg.subsample, normalize=cfg.normalize)
    f0, n_frames = 1200, (cfg.obs_len + 2) * cfg.subsample
    feed = []
    for f in range(f0, f0 + n_frames):
        sel = frames == f
        feed.append((f, [[int(i), float(x), float(y)] for i, x, y in
                         zip(ids[sel], xs[sel], ys[sel])]))
    # the JAX server's schedule (tests/test_serve.py): a forecast at every
    # frame on the subsample grid from step obs_len - 1 on, where an agent
    # is present
    due = [f for f, ag in feed if (f - f0) % cfg.subsample == 0
           and (f - f0) // cfg.subsample >= cfg.obs_len - 1
           and any(i != 0 for i, _, _ in ag)]
    stdin = "\n".join(json.dumps({"frame": f, "agents": ag})
                       for f, ag in feed) + "\n"
    with counted(), recorded_serving_calls() as calls:
        out, err, _ = run_cli(predict_cli.main, [
            "--device", dev.type, "--save_dir", save_dir, "--best", "1",
            "--num_samples", str(cfg.num_samples), "--stream", "--scale",
            repr(v.scale)], stdin)
    recs = [json.loads(x) for x in out]
    fcs = recs[1:]
    if not recs[0].get("ready") or [r["frame"] for r in fcs] != due \
            or len(due) != 3:
        raise AssertionError(f"stream mode: {recs[0]}, forecasts at "
                             f"{[r.get('frame') for r in fcs]}, due {due}")
    for r, f in zip(fcs, due):
        present = {i for i, _, _ in feed[f - f0][1]}
        if r["step"] != (f - f0) // cfg.subsample \
                or not {ag["id"] for ag in r["agents"]} <= present:
            raise AssertionError(f"stream forecast at frame {f}")
        check_forecast_line(r, cfg_b)
    stream_stats = json.loads(err[-1])
    hold(calls, f"predict stream mode ({n_frames} frames, {len(fcs)} "
                f"forecasts, warm-up included)")
    del calls
    # the stream server's time a frame, over the same feed
    pred = Predictor.from_checkpoint(save_dir, best=True, device=dev.type,
                                     k_samples=cfg.num_samples,
                                     max_windows=8).warmup()
    server = StreamServer(pred, scale=v.scale)
    with counted():
        t0 = time.perf_counter()
        for f, ag in feed:
            server.observe(f, ag)
        torch.cuda.synchronize()
        stream_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    del pred, server

    # -- 9c. rollout ------------------------------------------------------------
    batch = next(iter(eval_loader.epoch_batches(0)))
    xy, mask, ids_t = batch_to_device(batch, dev)
    obs_xy = xy[:, :to].transpose(1, 2).contiguous()
    obs_mask = mask[:, :to].transpose(1, 2).contiguous()
    roll = make_rollout(cfg_b)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with counted(), recorded_serving_calls() as calls:
        traj = roll(params, obs_xy, obs_mask, ids_t, num_chunks=2,
                    generator=gen)
    if tuple(traj.shape) != (batch.batch_size, a, to + 2 * tf, 2) \
            or not bool(torch.isfinite(traj).all()) \
            or not torch.equal(traj[:, :, :to], obs_xy):
        raise AssertionError(f"rollout: {tuple(traj.shape)}")
    hold(calls, f"rollout, 2 chunks at B={batch.batch_size}")
    del calls
    with counted():
        t0 = time.perf_counter()
        roll(params, obs_xy, obs_mask, ids_t, num_chunks=2, generator=gen)
        torch.cuda.synchronize()
        roll_ms = (time.perf_counter() - t0) * 1e3 / 2

    # -- 9d. bench_serve ----------------------------------------------------------
    with counted():
        out, _, _ = run_cli(bench_serve.main, [
            "--device", dev.type, "--save_dir", save_dir, "--num_samples",
            str(cfg.num_samples), "--max_windows", "64", "--iters", "20"])
    bench = json.loads(out[-1])
    if bench["calls"] != 20 or bench["metric"] != "serve_latency":
        raise AssertionError(f"bench_serve: {bench}")
    print(json.dumps(bench), flush=True)

    # -- 9e. the imagery raster ---------------------------------------------------
    cfg_i = cfg.replace(scene_image_channels=1, save_dir="")
    p_i = make_params(cfg_i, dev, seed=1)
    loader_i = SDDLoader(cfg_i, split="train")
    batch = next(iter(loader_i.epoch_batches(0)))
    xy, mask, ids_t, img = batch_to_device(batch, dev)
    g = cfg.scene_grid
    if tuple(img.shape) != (cfg.batch_size, g, g, 1) or float(img.max()) <= 0:
        raise AssertionError("the loader's occupancy rasters")
    eps = torch.as_tensor(rng.standard_normal(
        (cfg.batch_size * a, k, cfg.latent_size)).astype(np.float32),
        device=dev)
    with counted(), recorded_serving_calls() as calls:
        out_k = desire_forward(p_i, cfg_i, xy, mask, ids_t, eps=eps,
                               scene_image=img)
    hold(calls, "imagery forward, bf16, flagship")
    del calls
    zero = desire_forward(p_i, cfg_i, xy, mask, ids_t, eps=eps)
    if torch.equal(out_k["scores"], zero["scores"]):
        raise AssertionError("the raster did not reach the model")
    del out_k, zero
    cfg_i32 = cfg_i.replace(compute_dtype="float32")
    outs = {}
    for name, ctx in (("kernels", contextlib.nullcontext),
                      ("plain", plain_ops)):
        with ctx():
            outs[name] = desire_forward(p_i, cfg_i32, xy, mask, ids_t,
                                        eps=eps, scene_image=img)
    for key, tol in (("sgm_traj", F32_TOL), ("refined_traj", F32_TOL),
                     ("scores", F32_SCORE_TOL)):
        check_close(f"imagery forward float32 {key}", outs["kernels"][key],
                    outs["plain"][key], **tol)
    del outs
    # one float32 training step at the flagship width on the loader's
    # batch: the training kernels against the plain versions, on the card
    noise = train_noise(cfg_i32, rng, dev)
    after = {}
    for name, ctx in (("kernels", counted), ("plain", plain_train_ops)):
        step_fn = make_train_step(cfg_i32, loader_i.num_batches)
        st = create_train_state(cfg_i32, p_i, seed=0)
        with ctx():
            st, met = step_fn(st, xy, mask, ids_t, img, noise=noise)
        after[name] = (tree_leaves(st.params), met)
    lr = cfg.learning_rate
    diffs = [(x - y).abs() for x, y in zip(after["kernels"][0],
                                           after["plain"][0])]
    worst = max(float(d.max()) for d in diffs)
    share = sum(int((d > 1e-4).sum()) for d in diffs) / sum(
        d.numel() for d in diffs)
    ok = worst <= STEP_MAX_ABS(lr) and share <= STEP_FLIP_SHARE
    print(f"  imagery step float32: loss kernels "
          f"{float(after['kernels'][1]['loss']):.6f} plain "
          f"{float(after['plain'][1]['loss']):.6f}; params after the step: "
          f"max_abs_err={worst:.3e} (<= {STEP_MAX_ABS(lr):.3e}), share off "
          f"by > 1e-4: {share:.2e} (<= {STEP_FLIP_SHARE}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check_close("imagery step loss", after["kernels"][1]["loss"],
                after["plain"][1]["loss"], rtol=1e-4, atol=1e-5)
    if not ok:
        raise AssertionError("the imagery step through the kernels "
                             "disagrees with the plain step")
    del after, diffs

    check_launches("phase 9", launches, ("sgm_sample", "ioc_refine",
                                         "ioc_refine_train",
                                         "ioc_refine_bwd", "nll_fwd",
                                         "nll_bwd"), 1)
    print(f"evaluation and forecasting on {smi} (host clock): evaluate "
          f"entry point {cli_s:.1f} s in its own process, {eval_s:.1f} s in "
          f"this one (restore, loaders, {n_fwd} forward batches: fit, dump, "
          f"eval); its held-out pass {eval_ms:.3f} ms a batch "
          f"({eval_loader.num_batches} batches, horizons, calibration at "
          f"the fitted temperature); predict file "
          f"mode {file_s:.1f} s, p50 {file_stats['latency_ms_p50']:.3f} ms "
          f"p95 {file_stats['latency_ms_p95']:.3f} ms; stream p50 "
          f"{stream_stats['latency_ms_p50']:.3f} ms p95 "
          f"{stream_stats['latency_ms_p95']:.3f} ms a forecast, "
          f"{stream_ms:.3f} ms a frame over {n_frames} frames; rollout "
          f"{roll_ms:.3f} ms a chunk (B={eval_loader.cfg.batch_size}); "
          f"bench_serve (64 windows) p50 {bench['latency_ms_p50']:.3f} ms "
          f"p95 {bench['latency_ms_p95']:.3f} ms, "
          f"{bench['agent_forecasts_per_sec']} agent forecasts/s",
          flush=True)
    print(f"  phase 9 launches {launches}", flush=True)
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# -- 10. the mesh on one card ----------------------------------------------------
# Phase 10 puts MESH_RANKS processes on cuda:0, joined by gloo (NCCL refuses
# two ranks on one card); they load the kernel library phase 2 built.
MESH_SHAPES = ((2, 1), (1, 2), (2, 2))
MESH_RANKS = 4
MESH_STEPS = 3
# seconds a rank waits in a collective, and the ranks' wall limit in all
MESH_TIMEOUT_S = 120.0
MESH_WALL_S = 300.0
# data-parallel bf16 steps against the unsharded ones: each rank's loss
# terms over 32 of the 64 windows, the gradients summed over the two; bf16
# products in another grouping move a loss by ~1e-3 relative, and the
# params' differences grow over the steps
DP_REL_TOL = 1e-2
# lane-parallel bf16 steps against the unsharded ones: losses within 1e-3
# relative, gradient norms 1e-2 (the data-parallel steps' measured margins
# are 3e-5 and 6e-4)
LANE_LOSS_TOL, LANE_NORM_TOL = 1e-3, 1e-2
# lane-parallel training: the meshes, and its variants' one step each
LANE_SHAPES = ((1, 2), (2, 2))
LANE_VARIANTS = {"social_freeze": ((2, 2), dict(social_freeze=True)),
                 "fused_train=False": ((1, 2), dict(fused_train=False))}


def warm_step_ms(logged):
    """The median ms of run_epoch's steps after the first, from the logged
    cumulative mean host seconds a batch (every step logged; logging waits
    for the card)."""
    ends = [m["sec_per_batch"] * (i + 1) for i, m in enumerate(logged)]
    return statistics.median(b - a for a, b in zip(ends, ends[1:])) * 1e3


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def lane_rank(rank, meshes, inp, dev, say):
    """Phase 10's lane-parallel training on this rank: on each mesh of
    LANE_SHAPES that holds it, MESH_STEPS run_epoch steps of the flagship
    training from the unsharded run's state (its rows, all 20 lanes of
    the sampler, 10 of the IOC), each IOC training and NLL call held
    against its plain version (phase 6's tolerances), the ranks' params
    compared and a checkpoint saved (rank 0 alone writes); one step of
    each LANE_VARIANTS config; on (2, 2), one float32 step at small_cfg
    held against the plain unsharded step on the CPU (rank 0). Returns
    (report, launches of the default and fused_train=False runs,
    launches of the social_freeze run)."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.data.loader import LoaderState
    from desire_tpu_torch.parallel import mesh as mesh_mod
    from desire_tpu_torch.params import to_device
    from desire_tpu_torch.train.checkpoint import CheckpointManager
    from desire_tpu_torch.train.state import create_train_state, tree_leaves
    from desire_tpu_torch.train.trainer import make_train_step, run_epoch

    report = {}
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    launches_fz = dict.fromkeys(ops.LAUNCHES, 0)

    def run(cfg, m, batches, into):
        loader = SyntheticLoader(cfg, None, 0)
        loader.batches = batches
        state = create_train_state(cfg, to_device(inp["params"], dev),
                                   seed=0)
        step_fn = make_train_step(cfg, steps_per_epoch=190, mesh=m)
        logged = []
        ops.reset_launch_counts()
        with recorded_training_calls() as calls:
            state, _ = run_epoch(state, loader, 0, step_fn, log_every=1,
                                 log_fn=lambda mm, st: logged.append(mm),
                                 mesh=m)
        torch.cuda.synchronize()
        got = dict(ops.LAUNCHES)
        for name, n in got.items():
            into[name] += n
        checked = check_training_calls(calls, cfg, got, seed=rank)
        del calls
        flat = torch.cat([x.reshape(-1) for x in tree_leaves(state.params)])
        equal = bool(torch.equal(mesh_mod.broadcast(m, flat.clone()), flat))
        return state, {"losses": [mm["loss"] for mm in logged],
                       "grad_norms": [mm["grad_norm"] for mm in logged],
                       "params_equal": equal, "checked": checked,
                       "step_ms": (warm_step_ms(logged) if len(logged) > 1
                                   else None)}

    cfg = flagship_cfg()
    for shape in LANE_SHAPES:
        m = meshes[shape]
        if m is None:
            continue
        name = f"{shape[0]}x{shape[1]}"
        state, rep = run(cfg, m, inp["batches"], launches)
        rep["checkpoint_written"] = CheckpointManager(
            os.path.join(inp["tmp"], f"ckpt_{name}_rank{rank}")).save(
            state, LoaderState(), cfg)
        report[name] = rep
        say(f"lane-parallel {name}, {MESH_STEPS} steps on rows "
            f"{m.rows(cfg.batch_size)}, IOC lanes "
            f"{m.lanes(cfg.num_samples)}: {rep['step_ms']:.3f} ms a step "
            f"after the first (host clock), losses {rep['losses']}, params "
            f"equal to rank 0's: {rep['params_equal']}; calls held against "
            f"plain {rep['checked']}")
    for label, (shape, kw) in LANE_VARIANTS.items():
        m = meshes[shape]
        if m is None:
            continue
        _, rep = run(flagship_cfg(**kw), m, inp["batches"][:1],
                     launches_fz if kw.get("social_freeze") else launches)
        report[label] = rep
        say(f"lane-parallel {label} on {shape}: loss {rep['losses']}, "
            f"calls held against plain {rep['checked']}")
    m = meshes[(2, 2)]
    if m is not None:
        check_meshed_step(m, small_cfg(num_samples=4), inp["snoise4"], inp,
                          dev, "float32 (2, 2) lane-parallel step on the "
                          "card vs the plain unsharded step on the CPU")
    return report, launches, launches_fz


def check_meshed_step(m, scfg, noise, inp, dev, note):
    """One float32 make_train_step(mesh=m) step at scfg (params
    inp["sparams"], batch inp["sbatch"], the global draws ``noise``) on
    the rank's rows on the card; rank 0 holds its params and metrics
    against the plain unsharded step on the CPU (check_step_rule)."""
    from desire_tpu_torch.params import to_device
    from desire_tpu_torch.train.state import create_train_state, tree_leaves
    from desire_tpu_torch.train.trainer import make_train_step

    def step(where, mesh, part):
        T = lambda x: torch.as_tensor(x, device=where)
        st = create_train_state(scfg, to_device(inp["sparams"], where),
                                seed=0)
        st, met = make_train_step(scfg, 190, mesh=mesh)(
            st, *(T(x)[part] for x in inp["sbatch"]),
            noise={k: T(v) for k, v in noise.items()})
        return tree_leaves(st.params), met
    card = step(dev, m, m.rows(scfg.batch_size))
    if m.coords == (0, 0):
        check_step_rule(card, step("cpu", None, slice(None)),
                        scfg.learning_rate, note)


def mesh_rank(rank, port, tmp):
    """Phase 10, rank ``rank`` of MESH_RANKS on cuda:0 (gloo): (a) the bf16
    serving forward on every mesh of MESH_SHAPES that holds the rank, each
    kernel call held against its plain version, the outputs of mesh rank
    (0, 0) written for the parent; (b) on the (2, 1) mesh, MESH_STEPS
    run_epoch steps of the flagship training on the rank's 32 rows, the
    ranks' params compared, a checkpoint saved (rank 0 alone writes), and
    one float32 step at small_cfg held against the plain unsharded step on
    the CPU (rank 0); (c) lane-parallel training (:func:`lane_rank`).
    Writes ``rank<r>.json``: launches of (a), (b) and (c) (social_freeze's
    apart), times, losses."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.data.loader import LoaderState
    from desire_tpu_torch.models.desire import (desire_forward,
                                                pack_kernel_weights)
    from desire_tpu_torch.parallel import mesh as mesh_mod
    from desire_tpu_torch.params import to_device
    from desire_tpu_torch.train.checkpoint import CheckpointManager
    from desire_tpu_torch.train.state import create_train_state, tree_leaves
    from desire_tpu_torch.train.trainer import make_train_step, run_epoch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_mod.init_multihost(f"localhost:{port}", MESH_RANKS, rank, "cuda",
                            MESH_TIMEOUT_S)
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    meshes = {shape: mesh_mod.make_mesh(*shape, device="cuda",
                                        timeout_s=MESH_TIMEOUT_S)
              for shape in MESH_SHAPES}
    dev = torch.device("cuda", 0)
    say = lambda msg: print(f"  rank {rank}: {msg}", flush=True)
    report = {"rank": rank, "forward_ms": {},
              "launches": dict.fromkeys(ops.LAUNCHES, 0)}

    def count(launches):
        for name, n in launches.items():
            report["launches"][name] += n

    cfg = flagship_cfg()
    params = to_device(inp["params"], dev)
    packed = pack_kernel_weights(params, cfg, dev)
    batch = [inp[k].to(dev) for k in ("xy", "mask", "ids")]
    eps = inp["eps"].to(dev)
    for shape, m in meshes.items():
        if m is None:
            continue

        def fwd():
            return desire_forward(params, cfg, *batch, eps=eps,
                                  kernel_weights=packed, mesh=m)
        name = f"{shape[0]}x{shape[1]}"
        ops.reset_launch_counts()
        with recorded_serving_calls() as calls:
            out = fwd()
        torch.cuda.synchronize()
        count(ops.LAUNCHES)
        checked = check_recorded_calls(calls, verbose=False)
        del calls
        if m.coords == (0, 0):
            torch.save({k: out[k].cpu() for k in ("raw5", "refined_traj",
                                                  "scores")},
                       os.path.join(tmp, f"fwd_{name}.pt"))
        times = []
        for _ in range(6):
            mesh_mod.barrier(m)
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        report["forward_ms"][name] = statistics.median(times[1:])
        say(f"mesh {name} at {m.coords}: forward of its block (B/"
            f"{shape[0]}, K/{shape[1]}) {report['forward_ms'][name]:.3f} ms "
            f"(host clock, median of 5, the gather included); kernel calls "
            f"held against plain {checked}")

    m = meshes[(2, 1)]
    if m is not None:
        loader = SyntheticLoader(cfg, None, 0)
        loader.batches = inp["batches"]
        state = create_train_state(cfg, to_device(inp["params"], dev),
                                   seed=0)
        step_fn = make_train_step(cfg, steps_per_epoch=190, mesh=m)
        logged = []
        ops.reset_launch_counts()
        state, _ = run_epoch(state, loader, 0, step_fn, log_every=1,
                             log_fn=lambda mm, st: logged.append(mm),
                             mesh=m)
        count(ops.LAUNCHES)
        report["step_ms"] = warm_step_ms(logged)
        report["losses"] = [mm["loss"] for mm in logged]
        report["grad_norms"] = [mm["grad_norm"] for mm in logged]
        flat = torch.cat([x.reshape(-1) for x in tree_leaves(state.params)])
        report["params_equal"] = bool(torch.equal(
            mesh_mod.broadcast(m, flat.clone()), flat))
        report["checkpoint_written"] = CheckpointManager(
            os.path.join(tmp, f"ckpt_rank{rank}")).save(
            state, LoaderState(), cfg)
        say(f"{MESH_STEPS} data-parallel steps on rows {m.rows(64)}: "
            f"{report['step_ms']:.3f} ms a step after the first (host "
            f"clock, the loader included), losses {report['losses']}, "
            f"params equal to rank 0's: {report['params_equal']}")
        check_meshed_step(m, small_cfg(), inp["snoise"], inp, dev,
                          "float32 (2, 1) step on the card vs the plain "
                          "unsharded step on the CPU")
    # (c) lane-parallel training
    inp["tmp"] = tmp
    report["lane"], lane_launches, report["launches_freeze"] = lane_rank(
        rank, meshes, inp, dev, say)
    count(lane_launches)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    mesh_mod.barrier(meshes[(2, 2)])
    torch.distributed.destroy_process_group()


def mesh_phase(dev, smi, rng):
    """Phase 10: the (data, k) mesh on one card. MESH_RANKS processes
    (``chip_smoke.py --mesh-rank``, gloo on cuda:0) run ``mesh_rank``; this
    process computes the unsharded references on the same inputs (the bf16
    serving forward of phases 4-5, MESH_STEPS steps of phase 6's training
    from the same state, one step of each LANE_VARIANTS config), compares,
    and shows that a one-rank NCCL group initialises and all-reduces.
    Returns the ranks' launches (the meshed forwards and training steps;
    those of the social_freeze steps apart)."""
    import torch.distributed as dist
    from desire_tpu_torch.models.desire import (desire_forward,
                                                pack_kernel_weights)
    from desire_tpu_torch.parallel import mesh as mesh_mod
    from desire_tpu_torch.params import to_device

    print(f"phase 10: the mesh on one card, {MESH_RANKS} gloo ranks on "
          f"cuda:0 ({smi})", flush=True)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="desire_mesh_")
    cfg = flagship_cfg()
    params = make_params(cfg, "cpu", seed=10)
    batch = flagship_windows(cfg, rng, "cpu")
    eps = torch.randn((cfg.batch_size * cfg.max_num_obj, cfg.num_samples,
                       cfg.latent_size),
                      generator=torch.Generator().manual_seed(10))
    loader = SyntheticLoader(cfg, rng, MESH_STEPS)
    scfg = small_cfg()
    torch.save(dict(params=params, xy=batch[0], mask=batch[1], ids=batch[2],
                    eps=eps, batches=loader.batches,
                    sparams=make_params(scfg, "cpu", seed=11),
                    sbatch=synthetic_batch(scfg, rng),
                    snoise=train_noise(scfg, rng, "cpu"),
                    snoise4=train_noise(small_cfg(num_samples=4), rng,
                                        "cpu")),
               os.path.join(tmp, "inputs.pt"))
    p_dev = to_device(params, dev)
    ref = desire_forward(p_dev, cfg, *(x.to(dev) for x in batch),
                         eps=eps.to(dev),
                         kernel_weights=pack_kernel_weights(p_dev, cfg, dev))
    ref = {k: ref[k].cpu() for k in ("raw5", "refined_traj", "scores")}
    logged, _, _ = epoch_run(cfg, p_dev, loader, "unsharded reference")
    one = SyntheticLoader(cfg, None, 0)
    one.batches = loader.batches[:1]
    variant_ref = {label: epoch_run(flagship_cfg(**kw), p_dev, one,
                                    f"unsharded reference, {label}")[0]
                   for label, (_, kw) in LANE_VARIANTS.items()}
    del p_dev

    port = free_port()
    release_card()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--mesh-rank",
         str(r), str(port), tmp], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(MESH_RANKS)]
    logs = [""] * MESH_RANKS
    deadline = time.perf_counter() + MESH_WALL_S
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(
                timeout=max(deadline - time.perf_counter(), 1.0))[0]
    except subprocess.TimeoutExpired:
        pass
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                logs[r] += p.communicate()[0]
    for lg in logs:
        print(lg, end="", flush=True)
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(f"phase 10: ranks {failed} failed or ran out "
                             f"of {MESH_WALL_S} s")
    reports = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
               for r in range(MESH_RANKS)]

    # (a) the meshed forwards against the unsharded one
    for shape in MESH_SHAPES:
        name = f"{shape[0]}x{shape[1]}"
        got = torch.load(os.path.join(tmp, f"fwd_{name}.pt"))
        same = {k: bool(torch.equal(got[k], ref[k])) for k in got}
        print(f"  mesh {name} forward vs unsharded: bitwise equal {same}",
              flush=True)
        check_bf16("refined", got["raw5"][..., :2], ref["raw5"][..., :2])
        check_bf16("refined", got["refined_traj"], ref["refined_traj"])
        check_bf16("scores", got["scores"], ref["scores"])
        ms = [rp["forward_ms"][name] for rp in reports
              if name in rp["forward_ms"]]
        print(f"  mesh {name}: per-rank forward ms {ms} ({smi}; ranks "
              f"share one card: no speed-up is measured)", flush=True)

    # (b) data-parallel training against the unsharded steps
    dp = reports[:2]
    for key, ref_key in (("losses", "loss"), ("grad_norms", "grad_norm")):
        want = [m[ref_key] for m in logged]
        for rp in dp:
            rel = [abs(a - b) / abs(b) for a, b in zip(rp[key], want)]
            print(f"  rank {rp['rank']} {key} {rp[key]} vs unsharded {want}: "
                  f"max rel {max(rel):.2e} (<= {DP_REL_TOL})", flush=True)
            if len(rel) != MESH_STEPS or max(rel) > DP_REL_TOL:
                raise AssertionError(f"phase 10: data-parallel {key} "
                                     f"disagree with the unsharded steps")
    if not all(rp["params_equal"] for rp in dp):
        raise AssertionError("phase 10: the ranks' params differ")
    written = [rp["checkpoint_written"] for rp in dp]
    on_disk = [bool(os.listdir(os.path.join(tmp, f"ckpt_rank{r}")))
               for r in range(2)]
    print(f"  checkpoint: save() wrote {written}, on disk {on_disk}; step ms "
          f"after the first, per rank {[round(rp['step_ms'], 3) for rp in dp]}"
          f", unsharded {warm_step_ms(logged):.3f} ({smi}; the two ranks "
          f"share the card)", flush=True)
    if written != [True, False] or on_disk != [True, False]:
        raise AssertionError("phase 10: rank 0 alone must write checkpoints")

    # (c) lane-parallel training against the unsharded steps
    for label, ranks, ref_logged in (
            [(f"{a}x{b}", range(a * b), logged) for a, b in LANE_SHAPES]
            + [(label, range(shape[0] * shape[1]), variant_ref[label])
               for label, (shape, _) in LANE_VARIANTS.items()]):
        for key, ref_key, tol in (("losses", "loss", LANE_LOSS_TOL),
                                  ("grad_norms", "grad_norm",
                                   LANE_NORM_TOL)):
            want = [m[ref_key] for m in ref_logged]
            for r in ranks:
                got = reports[r]["lane"][label][key]
                rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
                print(f"  lane-parallel {label} rank {r} {key} {got} vs "
                      f"unsharded {want}: max rel {max(rel):.2e} (<= {tol})",
                      flush=True)
                if len(rel) != len(want) or max(rel) > tol:
                    raise AssertionError(f"phase 10: lane-parallel {label} "
                                         f"{key} disagree with the "
                                         "unsharded steps")
        if not all(reports[r]["lane"][label]["params_equal"] for r in ranks):
            raise AssertionError(f"phase 10: the lane-parallel {label} "
                                 "ranks' params differ")
        if label in LANE_VARIANTS:
            continue
        written = [reports[r]["lane"][label]["checkpoint_written"]
                   for r in ranks]
        on_disk = [bool(os.listdir(os.path.join(
            tmp, f"ckpt_{label}_rank{r}"))) for r in ranks]
        ms = [round(reports[r]["lane"][label]["step_ms"], 3) for r in ranks]
        print(f"  lane-parallel {label}: checkpoint save() wrote {written}, "
              f"on disk {on_disk}; step ms after the first, per rank {ms} "
              f"({smi}; the ranks share the card)", flush=True)
        if written != [r == 0 for r in ranks] or on_disk != written:
            raise AssertionError("phase 10: rank 0 alone must write "
                                 "checkpoints")

    # (d) the backend of ranks with a card each: a one-rank NCCL group
    mesh_mod.init_multihost(f"localhost:{free_port()}", 1, 0, "cuda", 60.0)
    try:
        x = torch.full((4,), 3.0, device=dev)
        dist.all_reduce(x)
        backend = dist.get_backend()
        ok = backend == "nccl" and bool((x == 3.0).all())
    finally:
        dist.destroy_process_group()
    print(f"  one-rank {backend} group: all_reduce on the card "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("phase 10: the NCCL group failed")

    launches, launches_fz = {}, {}
    for rp in reports:
        for into, got in ((launches, rp["launches"]),
                          (launches_fz, rp["launches_freeze"])):
            for k, n in got.items():
                into[k] = into.get(k, 0) + n
    check_launches("phase 10", launches, ("sgm_sample", "ioc_refine",
                                          "ioc_refine_train",
                                          "ioc_refine_bwd", "nll_fwd",
                                          "nll_bwd", "scene_pool_fwd",
                                          "scene_pool_bwd"), 1)
    check_launches("phase 10, social_freeze", launches_fz,
                   ("ioc_refine_train", "ioc_refine_bwd", "nll_fwd",
                    "nll_bwd"), 1)
    print(f"  phase 10 launches {launches}; social_freeze {launches_fz}",
          flush=True)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s ({smi})",
          flush=True)
    return launches, launches_fz


def check_forward_card_vs_cpu(scfg, sp, rng):
    """desire_forward(train=False) through the kernels on the card against
    the plain versions on the CPU (float32, the same params, inputs and
    latent noise). Returns the card forward's launches."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.models.desire import desire_forward
    from desire_tpu_torch.params import to_device
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
        ops.reset_launch_counts()
        outs[where] = desire_forward(p, scfg, T(xy), T(mask), T(ids),
                                     eps=T(eps))
    launches = dict(ops.LAUNCHES)
    for key, tol in (("sgm_traj", F32_TOL), ("refined_traj", F32_TOL),
                     ("scores", F32_SCORE_TOL)):
        check_close(f"forward {key}", outs["cuda"][key].cpu(),
                    outs["cpu"][key], **tol)
    print(f"  card launches {launches}", flush=True)
    return launches


def serve_requests(params, cfg, rng, n_req=3, n_win=64):
    """n_req requests of n_win synthetic windows through serve.Predictor;
    checks every forecast's shape, finiteness and distance from its agent.
    Returns the launches of the requests."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.serve import Predictor
    pred = Predictor(params, cfg, max_windows=n_win, device="cuda", seed=0)
    pred.warmup()
    ops.reset_launch_counts()
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
    return launches


# -- 11. the deconv mask decoder and the reference facade ----------------------
# the deconv stack's layers: (param name, input side, stride, padding)
DECONV_LAYERS = (("vdec1", 1, 1, "VALID"), ("vdec2", 4, 1, "VALID"),
                 ("vdec3", 8, 2, "SAME"), ("vdec4", 16, 2, "SAME"))


def reference_args(**kw):
    """The reference's flags (``desire_tpu/compat.py``'s contract) at the
    flagship widths: 60 agent slots, d 48, latent 128, embedding 64,
    windows of seq_length 8."""
    import argparse
    ns = argparse.Namespace(
        rnn_size=512, num_layers=1, model="gru", batch_size=1, seq_length=8,
        num_epochs=1, save_every=400, grad_clip=10.0, learning_rate=1e-3,
        decay_rate=0.95, keep_prob=0.8, embedding_size=64,
        neighborhood_size=32, grid_size=4, max_num_obj=60, leave_dataset=5,
        latent_size=128, e_dim=256, d_dim=48, stride=1)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def reference_traj(rng, t, a):
    """(t, a, 3) in the reference's layout, column 0 the id (0: an empty
    slot), in raw pixels: straight walks, a tenth of the slots empty."""
    out = np.zeros((t, a, 3), np.float32)
    for i in range(a):
        if rng.random() < 0.1:
            continue
        p0, v = rng.uniform(100.0, 900.0, 2), rng.uniform(-8.0, 8.0, 2)
        out[:, i, 0] = i + 1
        out[:, i, 1:3] = p0 + np.arange(t)[:, None] * v
    return out


def conv_phase(dev, smi, rng):
    """Phase 11: a model with the deconv mask decoder (vae_dec='conv') at
    the flagship width, and the reference facade on the card. Returns the
    launches of its main paths (the conv model's requests and steps, the
    facade's steps and sample)."""
    from desire_tpu_torch import compat, ops
    from desire_tpu_torch.models import layers as L
    from desire_tpu_torch.models import sgm
    from desire_tpu_torch.params import to_device

    print(f"phase 11: vae_dec='conv' and the reference facade ({smi})",
          flush=True)
    t_phase = time.perf_counter()
    launches = dict.fromkeys(ops.LAUNCHES, 0)

    def add(got):
        for k, n in got.items():
            launches[k] += n

    # -- 11a. deconv2d and the decoder: card vs CPU, float32 -------------------
    cfg32 = flagship_cfg(vae_dec="conv", compute_dtype="float32")
    p = make_params(cfg32, "cpu", seed=20)["sgm"]
    gen = torch.Generator().manual_seed(20)
    for name, side, stride, pad in DECONV_LAYERS:
        x = torch.randn((256, side, side, p[name]["w"].shape[2]),
                        generator=gen)
        ref = L.deconv2d(p[name], x, stride=stride, padding=pad)
        got = L.deconv2d(to_device(p[name], dev), x.to(dev), stride=stride,
                         padding=pad)
        check_close(f"deconv2d {name} {tuple(x.shape)} -> "
                    f"{tuple(got.shape)}", got.cpu(), ref, **F32_TOL)
    z = torch.randn((256, cfg32.latent_size), generator=gen)
    ref = sgm.vae_decode_mask(p, z, cfg32.vae_side)
    got = sgm.vae_decode_mask(to_device(p, dev), z.to(dev), cfg32.vae_side)
    for name, g, r in zip(("beta", "recon"), got, ref):
        check_close(f"conv vae_decode_mask {name}", g.cpu(), r, **F32_TOL)

    # -- 11b. the float32 forward: card vs CPU ---------------------------------
    print("compare float32 conv forward, card (kernels) vs CPU (plain):",
          flush=True)
    scfg = small_cfg(rnn_size=512, vae_dec="conv")
    got = check_forward_card_vs_cpu(scfg, make_params(scfg, dev, seed=21),
                                    rng)
    # the fused sampler needs the MLP decoder: the sampler is layer by layer
    check_launches("the conv forward", got, ("ioc_refine",), 1)
    check_not_launched("the conv forward", got, ("sgm_sample",))

    # -- 11c. serve ---------------------------------------------------------------
    print("serve: a conv model, Predictor at B=64, A=60, K=20, bf16",
          flush=True)
    cfg = flagship_cfg(vae_dec="conv")
    params = make_params(cfg, dev, seed=22)
    with recorded_serving_calls() as calls:
        got = serve_requests(params, cfg, rng)
    if len(calls) != got["ioc_refine"] + 1:   # and the warm-up's call
        raise AssertionError(f"{got['ioc_refine']} IOC launches and the "
                             f"warm-up's, {len(calls)} recorded calls")
    # on the model's own inputs, as phase 10's training calls
    print(f"  every IOC call held against plain [calls, max abs error by "
          f"output bf16, float32]: "
          f"{check_recorded_calls(calls, False, path=True)}", flush=True)
    del calls
    check_launches("3 conv requests", got, ("ioc_refine",), 3)
    check_not_launched("3 conv requests", got, ("sgm_sample",))
    add(got)

    # -- 11d. train, remat off and on -------------------------------------------
    print("training: a conv model, 2 run_epoch steps at B=64, A=60, K=20, "
          "bf16, remat off and on", flush=True)
    loader = SyntheticLoader(cfg, rng, 2)
    runs = {}
    for remat in (False, True):
        cfg_r = flagship_cfg(vae_dec="conv", remat=remat)
        with recorded_training_calls() as calls:
            logged, got, peak = epoch_run(cfg_r, params, loader,
                                          f"remat={remat}")
        check_launches(f"conv, remat={remat}", got,
                       ("ioc_refine_train", "ioc_refine_bwd", "nll_fwd",
                        "nll_bwd"), 2)
        print(f"  remat={remat}: training calls held against plain "
              f"{check_training_calls(calls, cfg_r, got)}", flush=True)
        del calls
        add(got)
        runs[remat] = ([m["loss"] for m in logged], peak,
                       warm_step_ms(logged), got)
    # the same steps graphed (remat off; the recorded ones ran eagerly)
    logged, got, _ = epoch_run(flagship_cfg(vae_dec="conv"), params, loader,
                               "remat=False, graphed")
    graphed_losses = [m["loss"] for m in logged]
    diff = max(abs(x - y) / max(abs(x), 1e-6)
               for x, y in zip(graphed_losses, runs[False][0]))
    names = ("ioc_refine_train", "ioc_refine_bwd", "nll_fwd", "nll_bwd",
             "grad_sumsq", "clip_adam")
    print(f"  graphed: losses {graphed_losses} against the eager "
          f"{runs[False][0]}, max relative difference {diff:.3e} (<= "
          f"1e-3); launches as the eager step's: "
          f"{all(got[k] == runs[False][3][k] for k in names)}", flush=True)
    if diff > 1e-3 or any(got[k] != runs[False][3][k] for k in names):
        raise AssertionError("the graphed conv training step parts from "
                             "the eager one")
    diff = max(abs(x - y) / max(abs(x), 1e-6)
               for x, y in zip(runs[False][0], runs[True][0]))
    print(f"  remat: losses off {runs[False][0]} on {runs[True][0]}, max "
          f"relative difference {diff:.3e} (<= 1e-3); peak device memory off"
          f" {runs[False][1] / 2**30:.3f} GiB, on {runs[True][1] / 2**30:.3f}"
          f" GiB; the second step {runs[False][2]:.3f} / "
          f"{runs[True][2]:.3f} ms (host clock, logging waits for the "
          f"card; {smi})", flush=True)
    if diff > 1e-3:
        raise AssertionError("remat changed the conv model's losses")
    del params, loader

    # -- 11e. the reference facade ------------------------------------------------
    print("the reference facade: DESIREModel on the card, 3 train_steps and "
          "a sample of 12 frames", flush=True)
    model = compat.DESIREModel(reference_args(), seed=0, device="cuda")
    t = model.cfg.seq_length
    full = reference_traj(rng, t + 1, model.cfg.max_num_obj)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_training_calls() as calls:
        losses = [model.train_step(full[:-1], full[1:]) for _ in range(3)]
    train_ms = (time.perf_counter() - t0) * 1e3 / 3
    got = dict(ops.LAUNCHES)
    check_launches("DESIREModel.train_step", got,
                   ("ioc_refine_train", "ioc_refine_bwd", "nll_fwd",
                    "nll_bwd"), 3)
    train_checked = check_training_calls(calls, model.cfg, got)
    del calls
    add(got)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"DESIREModel losses {losses}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_serving_calls() as calls:
        out = model.sample(None, full[:-1], dimensions=(1000, 1000), num=12)
    torch.cuda.synchronize()
    sample_ms = (time.perf_counter() - t0) * 1e3
    got = dict(ops.LAUNCHES)
    if len(calls) != got["sgm_sample"] + got["ioc_refine"]:
        raise AssertionError("a sampler or IOC launch of the sample without "
                             "its recorded call")
    checked = check_recorded_calls(calls, verbose=False)
    del calls
    check_launches("DESIREModel.sample", got, ("sgm_sample", "ioc_refine"),
                   1)
    add(got)
    want = (t + 12, model.cfg.max_num_obj, 3)
    if out.shape != want or not np.isfinite(out).all():
        raise AssertionError(f"DESIREModel.sample gave {out.shape} (want "
                             f"{want}) or non-finite values")
    np.testing.assert_array_equal(out[:t], full[:-1])
    print(f"  losses {losses}; a train_step {train_ms:.1f} ms, the sample "
          f"{sample_ms:.1f} ms (host clock, the first calls included; the "
          f"steps' recording too); the steps' kernel calls held against "
          f"plain {train_checked}; sample {out.shape}, its kernel calls held "
          f"against plain {checked}", flush=True)
    print(f"  phase 11 launches {launches}", flush=True)
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s ({smi})",
          flush=True)
    return launches


# -- 12. the headline bench and the constant-velocity baseline ----------------
# the keys of ``python -m desire_tpu_torch.bench``'s line: bench.py's but
# its TPU and XLA tooling's, and the port's own
BENCH_LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "fwd_ms",
                   "fwd_ms_p90", "train_steps_per_sec_K20", "train_step_ms",
                   "mfu_fwd", "mfu_train", "train_busy_ms", "train_peak_gib",
                   "device"}
# the stage sweep's variants whose kernel calls are held against plain
# (the configurations no other phase runs: the sampler without SCF and
# IOC, one refine pass, K = 12 and K = 50 at B = 64)
BENCH_HELD_VARIANTS = ("sgm_only", "sgm_scf", "full_K12", "full_K50")


def check_bench_numbers(label, rec, keys, mfu_keys):
    """Each of keys a finite number > 0; each of mfu_keys in (0, 1]."""
    for k in keys:
        if not (isinstance(rec[k], (int, float)) and np.isfinite(rec[k])
                and rec[k] > 0):
            raise AssertionError(f"{label}: {k} = {rec[k]!r}")
    for k in mfu_keys:
        if not (isinstance(rec[k], float) and 0.0 < rec[k] <= 1.0):
            raise AssertionError(f"{label}: {k} = {rec[k]!r}, want (0, 1]")


def bench_phase(dev, smi, tmp):
    """Phase 12: (a) ``python -m desire_tpu_torch.bench`` in a process of
    its own (exit 0, one line, its keys, finite values, value = B*A*K /
    fwd_ms, mfu in (0, 1], the card's nvidia-smi line); (b) ``bench``,
    ``bench_train`` and ``breakdown`` in this process at fewer calls, which
    must launch the sampler, IOC refine, IOC training forward and backward
    and NLL kernels; (c) one forward of each of BENCH_HELD_VARIANTS, on
    make_params's parameters, with every kernel call recorded and held
    against plain (IOC calls by check_ioc_path_call: bf16 and float32, the
    refined positions and the scores each, planted faults, the refine
    passes skipped among them); (d)
    ``model_flops`` of a small configuration the same on the card and on
    the CPU, launching no kernel; (e) ``python -m
    desire_tpu_torch.baseline_cv`` on phase 8's tree (tmp/data, its index
    cache tmp/cache), in this process and in its own, the same line.
    Returns the kernels' launches in (b)."""
    import io
    from unittest import mock
    from desire_tpu_torch import baseline_cv, bench, ops

    print(f"phase 12: the headline bench and the constant-velocity "
          f"baseline ({smi})", flush=True)
    t_phase = time.perf_counter()
    env = dict(os.environ, DESIRE_TORCH_CACHE_DIR=os.path.join(tmp, "cache"))

    # -- 12a. the bench's own process ----------------------------------------
    release_card()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "desire_tpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    bench_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"python -m desire_tpu_torch.bench exited with "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    lines = out.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"the bench printed {len(lines)} lines")
    rec = json.loads(lines[0])
    if set(rec) != BENCH_LINE_KEYS:
        raise AssertionError(f"the bench's keys {sorted(rec)}")
    check_bench_numbers("the bench's line", rec,
                        ("value", "fwd_ms", "fwd_ms_p90",
                         "train_steps_per_sec_K20", "train_step_ms",
                         "train_busy_ms", "train_peak_gib"),
                        ("mfu_fwd", "mfu_train"))
    cfg = bench.flagship_cfg()
    want = cfg.batch_size * cfg.max_num_obj * cfg.num_samples / (
        rec["fwd_ms"] / 1e3)
    if abs(rec["value"] - want) > 1e-4 * want or rec["vs_baseline"] is not \
            None or rec["device"] != smi or rec["fwd_ms_p90"] < rec["fwd_ms"]:
        raise AssertionError(f"the bench's line {rec}: value (want "
                             f"{want:.1f}), vs_baseline, device or p90")
    print(f"  python -m desire_tpu_torch.bench ({bench_s:.1f} s): "
          f"{lines[0]}", flush=True)

    # -- 12b. bench, bench_train and breakdown in this process ---------------
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    fwd = bench.bench(iters=5, warmup=1, device=dev)
    train = bench.bench_train(iters=3, warmup=1, device=dev)
    rows = bench.breakdown(iters=3, warmup=1, device=dev)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check_launches("phase 12b", launches, ("sgm_sample", "ioc_refine",
                                           "ioc_refine_train",
                                           "ioc_refine_bwd", "nll_fwd",
                                           "nll_bwd"), 1)
    check_bench_numbers("bench", fwd, ("traj_per_sec", "fwd_ms", "gflops"),
                        ("mfu_fwd",))
    check_bench_numbers("bench_train", train,
                        ("train_step_ms", "train_busy_ms", "train_peak_gib"),
                        ("mfu_train",))
    if [r["variant"] for r in rows] != [n for n, _ in bench.VARIANTS]:
        raise AssertionError(f"the breakdown's rows {rows}")
    for r in rows:
        check_bench_numbers(f"breakdown {r['variant']}", r,
                            ("ms", "traj_per_sec", "gflops"), ("mfu",))
    print(f"  bench {fwd}; bench_train {train}; launches {launches}",
          flush=True)

    # -- 12c. the sweep's new configurations' kernel calls against plain ------
    for name, vcfg in bench.variant_cfgs():
        if name not in BENCH_HELD_VARIANTS:
            continue
        # make_params: with the init's zero delta and gate heads a refine
        # pass would leave the positions as they were
        forward = bench.forward_fn(vcfg, dev,
                                   params=make_params(vcfg, dev, seed=12))
        with recorded_serving_calls() as calls:
            res = forward()
        torch.cuda.synchronize()
        want = ["sgm_sample"] + (["ioc_refine"] if vcfg.use_ioc else [])
        if sorted(c[0] for c in calls) != sorted(want):
            raise AssertionError(f"{name}: the forward called "
                                 f"{[c[0] for c in calls]} (want {want})")
        b, a, k = vcfg.batch_size, vcfg.max_num_obj, vcfg.num_samples
        shape = (b, a, k, vcfg.pred_len, 2)
        if tuple(res["refined_traj"].shape) != shape or not bool(
                torch.isfinite(res["refined_traj"]).all()) or (
                vcfg.use_ioc and not bool(torch.isfinite(
                    res["scores"]).all())):
            raise AssertionError(f"{name}: refined_traj "
                                 f"{tuple(res['refined_traj'].shape)} "
                                 f"(want {shape}) or not finite")
        held = check_recorded_calls(calls, verbose=False, path=True)
        faults = {f: [v["caught"], v["bf16"]]
                  for f, v in (held.pop("faults", None) or {}).items()}
        print(f"  {name} (B={b}, K={k}, num_refine={vcfg.num_refine}, "
              f"use_ioc={vcfg.use_ioc}): kernel calls against plain "
              f"{held}; planted faults caught [by, bf16 max abs error] "
              f"{faults}", flush=True)
        del calls, res, forward

    # -- 12d. the FLOP count: the same on the card and the CPU ---------------
    scfg = small_cfg()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    card = [bench.model_flops(scfg, train, dev) for train in (False, True)]
    torch.cuda.synchronize()
    # no model kernel: the counter sees every product the plain path runs;
    # the step's optimizer runs its two kernels (use_pallas selects the
    # model's kernels), whose element-wise work the counter does not count
    # on either path
    launched = dict(ops.LAUNCHES)
    check_not_launched("model_flops", launched,
                       [n for n in launched
                        if n not in ("grad_sumsq", "clip_adam")])
    if (launched["grad_sumsq"], launched["clip_adam"]) != (1, 1):
        raise AssertionError(f"model_flops' step: optimizer launches "
                             f"{launched} (want one of each)")
    cpu = [bench.model_flops(scfg, train, "cpu") for train in (False, True)]
    if card != cpu or min(card) <= 0:
        raise AssertionError(f"model_flops on the card {card}, on the CPU "
                             f"{cpu}")
    print(f"  model_flops of the small configuration, forward and step: "
          f"{card} on the card and on the CPU", flush=True)

    # -- 12e. the constant-velocity baseline on phase 8's tree ----------------
    argv = ["--data_dir", os.path.join(tmp, "data"), "--subsample", "12",
            "--eval_hop", "4", "--holdout", "video", "--batch_size", "64",
            "--max_num_obj", "60", "--speed_bins", "5,15"]
    buf = io.StringIO()
    with mock.patch.dict(os.environ, env), contextlib.redirect_stdout(buf):
        res = baseline_cv.main(argv)
    out = subprocess.run([sys.executable, "-m", "desire_tpu_torch.baseline_cv",
                          *argv], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"baseline_cv exited with {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    if out.stdout != buf.getvalue() or res["num_agents"] <= 0 or not all(
            np.isfinite([res["ADE_px"], res["FDE_px"]])):
        raise AssertionError(f"baseline_cv: in process {buf.getvalue()!r}, "
                             f"in its own {out.stdout!r}")
    print(f"  baseline_cv on phase 8's held-out split, in this process and "
          f"in its own: {out.stdout.strip()}", flush=True)
    print(f"  phase 12 launches {launches}", flush=True)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s ({smi})",
          flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from desire_tpu_torch.models.desire import (desire_forward,
                                                pack_kernel_weights)
    from desire_tpu_torch.models.ioc import _DELTA_SCALE
    from desire_tpu_torch.ops import _build, ioc_fused, sgm_fused

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
        m = re.search(r"entry function .*?((?:sgm|ioc|nll|scene)_[a-z_]+?"
                      r"_kernel)(?:I(\w+?)EEv)?", line)
        if m:
            kernel = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
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
    check_forward_card_vs_cpu(scfg, sp, rng)

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
    # K = 50 lanes (B = 16): a K that the IOC kernel's lanes a block do not
    # all divide, and 50 lanes of each agent in the sampler's row blocks
    print("compare bfloat16, K = 50, B = 16:", flush=True)
    cfg50 = flagship_cfg(num_samples=50)
    packed50 = pack_kernel_weights(params, cfg50, dev)
    args50 = sampler_inputs(cfg50, 16 * cfg.max_num_obj, rng, dev)
    got = sgm_fused.sgm_sample_decode_cuda(packed50["sgm"], *args50,
                                           cfg.pred_len)
    ref = sgm_fused.sgm_sample_decode_plain(params["sgm"], *args50,
                                            cfg.pred_len, **kw_s)
    sgm_err = max(sgm_err, check_bf16("dec_h", got[0], ref[0]))
    check_bf16("hx", got[1], ref[1])
    args50 = ioc_inputs(cfg50, 16, rng, dev)
    got = ioc_fused.ioc_refine_cuda(packed50["ioc"], *args50, **kw_i)
    ref = ioc_fused.ioc_refine_plain(params["ioc"], params["scf"], *args50,
                                     **kw_i)
    ioc_err = max(ioc_err, check_bf16("refined", got[0], ref[0]),
                  check_bf16("scores", got[1], ref[1]))
    del got, ref, args50, packed50
    # A = 128 (B = 64): past 64 agents the tensor-core kernel holds one
    # lane a block, 8 lanes an attention row
    print("compare bfloat16, A = 128, B = 64, K = 20:", flush=True)
    cfg128 = flagship_cfg(max_num_obj=128)
    packed128 = pack_kernel_weights(params, cfg128, dev)
    # its own generator: the later phases keep their inputs
    ioc_err = max(ioc_err, check_crowd_ioc(
        params, cfg128, packed128["ioc"], np.random.default_rng(128), dev,
        kw_i))
    del packed128

    # -- 4. serve -------------------------------------------------------------
    print("serve: Predictor at B=64, A=60, K=20, bf16", flush=True)
    launches = serve_requests(params, cfg, rng)
    check_launches("3 requests", launches, ("sgm_sample", "ioc_refine"), 3)

    # -- 5. time --------------------------------------------------------------
    print(f"timing on {smi} (CUDA events, median):", flush=True)
    bx, bm, bids = flagship_windows(cfg, rng, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fwd_k, _ = time_in_turns(
        lambda: desire_forward(params, cfg, bx, bm, bids, generator=gen,
                               kernel_weights=packed), plain_ops,
        "forward_ms")
    traj_s = cfg.batch_size * cfg.max_num_obj * cfg.num_samples / fwd_k * 1e3
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
    sgm_bound = bound(*sampler_work(cfg, n), "bf16")
    ioc_bound = bound(*ioc_fwd_work(cfg, cfg.batch_size), "bf16")
    kernels = [
        {"name": "sgm_sample", "route": "cuda",
         "source": "desire_tpu_torch/csrc/sgm_sample.cu",
         "replaces": "desire_tpu/ops/sgm_fused.py:56",
         "launches": launches["sgm_sample"], "max_abs_err": sgm_err,
         "ms": t_sgm, "plain_ms": t_sgm_p, "bound_ms": sgm_bound[0],
         "bound_by": sgm_bound[1], "library_ms": None},
        {"name": "ioc_refine", "route": "cuda",
         "source": "desire_tpu_torch/csrc/ioc_refine.cu",
         "replaces": "desire_tpu/ops/ioc_fused.py:244",
         "launches": launches["ioc_refine"], "max_abs_err": ioc_err,
         "ms": t_ioc, "plain_ms": t_ioc_p, "bound_ms": ioc_bound[0],
         "bound_by": ioc_bound[1], "library_ms": None},
    ]
    del packed, s_args, i_args

    # -- 6. training -----------------------------------------------------------
    kernels += training_phase(dev, smi, rng)

    # -- 7. the layer-by-layer IOC path -----------------------------------------
    kernels += unfused_phase(dev, smi, rng, params)

    # phase 8's tree stays for phase 12's baseline
    tmp = tempfile.mkdtemp(prefix="desire_entry_")
    try:
        # -- 8. the training entry point, 9. evaluation and forecasting -------
        forecast_launches = entry_point_phase(dev, smi, rng, tmp)

        # -- 10. the mesh on one card -----------------------------------------
        mesh_launches, mesh_launches_fz = mesh_phase(dev, smi, rng)

        # -- 11. the deconv mask decoder, the reference facade ----------------
        conv_launches = conv_phase(dev, smi, rng)

        # -- 12. the headline bench, the constant-velocity baseline -----------
        bench_launches = bench_phase(dev, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for row in kernels:
        # the social_freeze backward's row counts the social_freeze steps'
        name = row["name"]
        for extra in (forecast_launches, mesh_launches, conv_launches,
                      bench_launches):
            row["launches"] += extra.get(name, 0)
        if name == "ioc_refine_bwd_social_freeze":
            row["launches"] += mesh_launches_fz["ioc_refine_bwd"]
        elif name != "ioc_refine_bwd":
            row["launches"] += mesh_launches_fz.get(name, 0)

    # -- 13. results ------------------------------------------------------------
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-check"]:   # phase 8d's own process
        if not torch.cuda.is_available():
            sys.exit(2)
        sys.path.insert(0, ROOT)
        resume_check(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1:2] == ["--mesh-rank"]:      # phase 10's ranks
        if not torch.cuda.is_available():
            sys.exit(2)
        sys.path.insert(0, ROOT)
        mesh_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit(main())
