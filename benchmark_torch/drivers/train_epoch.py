"""Training: ``train.trainer.run_epoch`` drives ``make_train_step`` over
the port's ``SDDLoader`` (the train split of a synthetic SDD tree), as
``python -m desire_tpu_torch.train`` does, without checkpoints or
evaluation.

Set-up builds one training state from the seed's parameters and takes the
first ``check_steps`` steps through ``run_epoch`` with the same step
function and loader as the window; the window then goes on from that
state and batch. Every step's random draws (latent noise, variety lanes,
dropout masks) come from the benchmark's generator and are passed to the
step pinned, so the reference repeats the first steps exactly.
``train_step_ms``: the window's ms over the steps it completed, the
loader's time included; ``loader_ms.train``: the host's ms a batch inside
the loader's iterator.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as np
import torch

from benchmark_torch import common, traffic
from benchmark_torch.reference import compare
from benchmark_torch.reference import params as ref_params
from benchmark_torch.trace import Tracer


def sdd_tree(h):
    """The synthetic SDD tree of the cell's ``tree`` parameters and the
    seed: one of ``trees`` trees, the seed's residue choosing it, written
    once into a fixed directory of the checkout named by both."""
    spec = h.traffic["tree"]
    which = h.seed % spec["trees"]
    key = hashlib.sha1(json.dumps([spec, which], sort_keys=True).encode()
                       ).hexdigest()
    root = os.path.join(h.cache, "sdd_" + key[:12])
    if not os.path.exists(os.path.join(root, "done")):
        t0 = time.perf_counter()
        tmp = root + ".partial"
        shutil.rmtree(tmp, ignore_errors=True)
        traffic.write_sdd_tree(tmp, np.random.default_rng([spec["seed"],
                                                           which]),
                               spec["scenes"], spec["videos"], spec["frames"],
                               spec["heldout_frames"], spec["alive"],
                               spec["subsample"])
        open(os.path.join(tmp, "done"), "w").close()
        shutil.rmtree(root, ignore_errors=True)
        os.replace(tmp, root)
        h.log(f"sdd tree {which} written in {time.perf_counter() - t0:.3f} s")
    return root


class StepDraws:
    """The step's draws from the benchmark's generator, in the step's
    shapes (``train.trainer.step_noise``'s keys)."""

    def __init__(self, cfg, device, seed):
        self.cfg = cfg
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed % 2 ** 63)
        self.device = device

    def __call__(self, xy_shape):
        b, t, a, _ = xy_shape
        c, g, dev = self.cfg, self.gen, self.device
        k, emb, to = c.num_samples, c.embedding_size, c.obs_len
        return {
            "lane_u": torch.rand((b, a, k), generator=g, device=dev),
            "eps": torch.randn((b * a, k, c.latent_size), generator=g,
                               device=dev),
            "keep_x": torch.rand((b * a, to, emb), generator=g,
                                 device=dev) < c.keep_prob,
            "keep_y": torch.rand((b * a, t - to, emb), generator=g,
                                 device=dev) < c.keep_prob,
        }


class TimedLoader:
    """The loader as ``run_epoch`` sees it: its batches until ``deadline``,
    the host's time inside its iterator counted."""

    def __init__(self, loader, deadline=None):
        self.loader = loader
        self.drop_remainder = loader.drop_remainder
        self.cfg = loader.cfg
        self.deadline = deadline
        self.batches = 0
        self.ends = []
        self.seconds = 0.0

    def epoch_batches(self, epoch, start_batch=0):
        it = self.loader.epoch_batches(epoch, start_batch)
        while self.deadline is None or time.perf_counter() < self.deadline:
            t0 = time.perf_counter()
            batch = next(it, None)
            self.seconds += time.perf_counter() - t0
            if batch is None:
                return
            self.batches += 1
            self.ends.append(time.perf_counter())
            yield batch


def setup(h, fault=None):
    """The loader, one training state from the seed's parameters, and a
    step function that pins its draws and records the first
    ``check_steps`` steps for the reference. ``fault`` plants one fault
    in the training step (``plant``)."""
    from desire_tpu_torch.data.loader import SDDLoader
    from desire_tpu_torch.train import trainer
    from desire_tpu_torch.train.state import create_train_state
    t = h.traffic
    cfg = h.desire_config(seed=h.seed % 2 ** 31, data_dir=sdd_tree(h),
                          batch_size=t["batch"], num_samples=t["k"],
                          window_hop=t["window_hop"])
    loader = SDDLoader(cfg, split="train")
    params = ref_params.make_params(h.model, h.seed, h.device)
    state = create_train_state(cfg, params, seed=h.seed % 2 ** 63)
    step_fn = plant(fault, trainer.make_train_step(cfg, loader.num_batches))
    draws = StepDraws(cfg, h.device, h.seed + 1)
    record = {"params0": [x.clone() for x in ref_params.leaves(params)],
              "batches": [], "noise": [], "loss": [], "mu1": None}

    def step(state, xy, mask, ids, *img):
        noise = draws(tuple(xy.shape))
        new, metrics = step_fn(state, xy, mask, ids, *img, noise=noise)
        if len(record["loss"]) < t["check_steps"]:
            record["batches"].append((xy.clone(), mask.clone(), ids.clone()))
            record["noise"].append(noise)
            record["loss"].append(metrics["loss"].detach().clone())
            if record["mu1"] is None:
                record["mu1"] = [x.clone() for x in ref_params.leaves(new.mu)]
        return new, metrics
    return cfg, loader, state, step, record


def first_steps(h, loader, state, step, record):
    """The first ``check_steps`` steps through ``run_epoch``; the
    parameters they leave go into ``record``."""
    from desire_tpu_torch.train import trainer
    t = h.traffic
    state, _ = trainer.run_epoch(state, loader, 0, step,
                                 log_every=t["log_every"],
                                 max_batches=t["check_steps"])
    record["after"] = [x.clone() for x in ref_params.leaves(state.params)]
    return state


def run(h):
    from desire_tpu_torch.train import trainer
    t = h.traffic
    cfg, loader, state, step, record = setup(h)
    state = first_steps(h, loader, state, step, record)
    epoch, first = 0, t["check_steps"]
    timed = TimedLoader(loader)
    start = h.start_window()
    timed.deadline = start + h.seconds
    while time.perf_counter() < timed.deadline:
        state, _ = trainer.run_epoch(state, timed, epoch, step,
                                     log_every=t["log_every"],
                                     start_batch=first)
        epoch, first = epoch + 1, 0
    if h.device.type == "cuda":
        torch.cuda.synchronize(h.device)
    window_s = time.perf_counter() - start
    steps = timed.batches
    peak = common.memory_peak(h.device)
    h.log_chunks(start, timed.ends, "batches")
    h.log(f"window: {steps} steps in {window_s:.4f} s, loader "
          f"{1e3 * timed.seconds / max(steps, 1):.4f} ms a batch, "
          f"{loader.num_batches} batches an epoch, peak {peak} B")
    result = common.Outcome(
        e2e={"train_step_ms": 1e3 * window_s / steps},
        attempted=steps, failed=0, memory_peak_bytes=peak,
        ctx={"steps_per_s": steps / window_s,
             "loader_ms": 1e3 * timed.seconds / steps,
             "batch": cfg.batch_size, "agents": cfg.max_num_obj,
             "k": cfg.num_samples})
    if h.trace:
        result.trace = trace_steps(h, loader, state, step, epoch)
    del state, step
    common.release(h.device)
    got = gaps(h, record, loader.num_batches,
               prec="fp8" if h.control else "f32")
    for name, limit in h.limits().items():
        h.check(name, got[name], limit)
    return result


def trace_steps(h, loader, state, step, epoch):
    """``trace_steps`` steps of epoch ``epoch`` traced: the loader's
    batches, the copy to the card, the step, the IOC training kernels'
    forward and backward calls, the optimizer."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.ops import ioc_bwd
    from desire_tpu_torch.train import trainer
    n = h.traffic["trace_steps"]
    tr = Tracer()
    tr.wrap(trainer, "batch_to_device", "copy")
    tr.wrap(ops, "ioc_refine_train", "ioc_refine_train")
    tr.wrap(ioc_bwd, "ioc_refine_bwd_cuda", "ioc_bwd")
    tr.wrap(trainer, "apply_updates", "adam")

    def ranged_step(*a):
        with torch.profiler.record_function("bench::step"):
            return step(*a)

    class Ranged(TimedLoader):
        def epoch_batches(self, epoch, start_batch=0):
            it = self.loader.epoch_batches(epoch, start_batch)
            for _ in range(n):
                with torch.profiler.record_function("bench::loader"):
                    batch = next(it, None)
                if batch is None:
                    return
                yield batch
    with tr.window():
        trainer.run_epoch(state, Ranged(loader), epoch, ranged_step,
                          log_every=h.traffic["log_every"])
    h.log(tr.result.summary())
    return tr.result


def gaps(h, record, steps_per_epoch, prec="f32"):
    """The training numbers of the recorded steps against the reference;
    with prec other than f32 the reference at that precision stands in
    the program's place (the control)."""
    common.reference_precision()
    like = ref_params.make_params(h.model, h.seed, h.device)
    start = ref_params.unflatten(like, record["params0"])
    t0 = time.perf_counter()
    args = (start, h.model, record["batches"], record["noise"],
            steps_per_epoch)
    refr = compare.reference_steps(*args)
    if prec == "f32":
        prog = ([float(x) for x in record["loss"]],
                [m / 0.1 for m in record["mu1"]], record["after"])
    else:
        prog = compare.reference_steps(*args, prec)
    out = compare.training_gaps(prog, refr, start)
    h.log(f"reference: {len(record['loss'])} steps in "
          f"{time.perf_counter() - t0:.3f} s; losses {prog[0]} against "
          f"{refr[0]}; {out.pop('left_out')} leaves left out of the update")
    return out


FAULTS = ("half", "unchanged")


def plant(fault, step_fn):
    """The step with one fault: ``half`` it trains on the first half of
    the batch's rows and their draws, the loss the mean over them;
    ``unchanged`` it returns the state it was given."""
    if fault == "half":
        def half(state, xy, mask, ids, *img, noise):
            b = xy.shape[0] // 2
            rows = b * xy.shape[2]
            cut = {k: v[:b] if k == "lane_u" else v[:rows]
                   for k, v in noise.items()}
            return step_fn(state, xy[:b], mask[:b], ids[:b],
                           *[x[:b] for x in img], noise=cut)
        return half
    if fault == "unchanged":
        def unchanged(state, *a, **kw):
            return state, step_fn(state, *a, **kw)[1]
        return unchanged
    return step_fn


def readings(h, requests, fault=None):
    """The program's numbers over the first ``check_steps`` steps, with
    ``fault`` planted, and the float8 control's on the same batches and
    draws."""
    cfg, loader, state, step, record = setup(h, fault)
    first_steps(h, loader, state, step, record)
    del state, step
    common.release(h.device)
    return (gaps(h, record, loader.num_batches),
            gaps(h, record, loader.num_batches, prec="fp8"))
