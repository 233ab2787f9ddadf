"""Data-parallel training: ``ranks`` processes, one card each, joined by
NCCL (gloo on the CPU, and where ranks share a card), each running
``train.trainer.run_epoch`` over its rows of every global batch of the
port's ``SDDLoader``, as ``python -m desire_tpu_torch.train --mesh_data
<ranks>`` does: ``parallel.mesh.init_multihost`` and ``make_mesh``, then
``make_train_step(mesh=)``, whose one all-reduce a step sums the ranks'
gradients (``trainer._reduce_over_mesh``).

The harness's process is rank 0; it builds the kernels and the SDD tree,
then starts ranks 1 to ranks - 1 as processes of this module, which read
the same cell files and seed. Every rank draws the step's global draws
from the benchmark's generator (the same on every rank) and the step
keeps its rows. The window's end is rank 0's clock: before each batch the
ranks agree on it over a gloo group of their own (no wait on the cards).

``train_step_ms``: rank 0's window ms over the steps it completed (a step
is ``ranks`` x ``batch`` windows). ``correct``: the first ``check_steps``
steps against the reference's steps on the same global batches (read by
an unsharded loader) and draws, whose gradient is the one the ranks' sum
has to equal; and ``rank_param_spread``, the largest difference of a
parameter between ranks after those steps and after the window, which
has to be 0 (bit-identical).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import torch
import torch.distributed as dist

from benchmark_torch import common
from benchmark_torch.drivers import train_epoch
from benchmark_torch.reference import params as ref_params
from benchmark_torch.trace import Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(h):
    """Rank 0, in the harness's process: the other ranks started, watched
    and stopped around this rank's run."""
    t = h.traffic
    ranks = t["ranks"]
    if h.device.type == "cuda":
        from desire_tpu_torch.ops import _build
        _build.library()
    train_epoch.sdd_tree(h)
    port = _free_port()
    spec = {"cell": h.cell, "config": h.config, "seed": h.seed,
            "seconds": h.seconds, "trace": h.trace, "toy": h.toy,
            "control": h.control, "device": h.device.type,
            "planted": PLANTED}
    fd, path = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as fh:
        json.dump(spec, fh)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "benchmark_torch.drivers.train_dp", path,
         str(r), str(ranks), str(port)], cwd=ROOT, stdout=2)
        for r in range(1, ranks)]
    stop = threading.Event()

    def watch():
        # a rank that fails leaves this one waiting in a collective
        while not stop.wait(0.5):
            for r, p in enumerate(procs, 1):
                if p.poll() not in (None, 0):
                    h.log(f"rank {r} exited with {p.returncode}")
                    os._exit(1)
    threading.Thread(target=watch, daemon=True).start()
    try:
        out, finish = rank_main(h, 0, ranks, port)
        for p in procs:
            p.wait(timeout=_timeout(h))
        stop.set()
        bad = [r for r, p in enumerate(procs, 1) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} failed")
        # the other ranks have left the cards: the reference runs now
        finish()
        return out
    finally:
        stop.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        os.unlink(path)


def _timeout(h):
    return float(h.traffic["timeout_s"])


class AgreedLoader(train_epoch.TimedLoader):
    """The loader as ``run_epoch`` sees it in the window: the rank's rows
    of each batch until the ranks agree that rank 0's clock passed
    ``deadline`` (one gloo all-reduce of a flag before each batch), the
    host's time inside its iterator counted."""

    def __init__(self, loader, group, deadline, rank):
        super().__init__(loader, deadline)
        self.group = group
        self.rank = rank
        self.stopped = False

    def agree(self):
        flag = torch.tensor([int(self.rank == 0 and time.perf_counter()
                                 >= self.deadline)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        self.stopped = bool(flag.item())
        return self.stopped

    def epoch_batches(self, epoch, start_batch=0, rows=None):
        it = self.loader.epoch_batches(epoch, start_batch, rows=rows)
        while not self.agree():
            t0 = time.perf_counter()
            batch = next(it, None)
            self.seconds += time.perf_counter() - t0
            if batch is None:
                return
            self.batches += 1
            self.ends.append(time.perf_counter())
            yield batch


def setup(h, rank, ranks, port):
    """This rank's process group, mesh, loader, training state and step
    (draws pinned; rank 0 records the first ``check_steps`` steps)."""
    from desire_tpu_torch.data.loader import SDDLoader
    from desire_tpu_torch.parallel import mesh as mesh_mod
    from desire_tpu_torch.train import trainer
    from desire_tpu_torch.train.state import create_train_state
    t = h.traffic
    mesh_mod.init_multihost(f"localhost:{port}", ranks, rank,
                            h.device.type, _timeout(h))
    mesh = mesh_mod.make_mesh(ranks, 1, h.device.type, _timeout(h))
    h.device = mesh.device
    group = dist.new_group(backend="gloo")
    cfg = h.desire_config(seed=h.seed % 2 ** 31,
                          data_dir=train_epoch.sdd_tree(h),
                          batch_size=t["batch"] * ranks, num_samples=t["k"],
                          window_hop=t["window_hop"], mesh_data=ranks)
    loader = SDDLoader(cfg, split="train")
    params = ref_params.make_params(h.model, h.seed, h.device)
    state = create_train_state(cfg, params, seed=h.seed % 2 ** 63)
    step_fn = trainer.make_train_step(cfg, loader.num_batches, mesh=mesh)
    if PLANTED and (rank == 0 or PLANTED in EVERY_RANK):
        step_fn = plant(PLANTED, step_fn, ranks)
    draws = train_epoch.StepDraws(cfg, h.device, h.seed + 1)
    record = {"params0": [x.clone() for x in ref_params.leaves(params)],
              "noise": [], "loss": [], "mu1": None}

    def step(state, xy, mask, ids, *img):
        shape = (xy.shape[0] * ranks, *xy.shape[1:])
        noise = draws(tuple(shape))
        new, metrics = step_fn(state, xy, mask, ids, *img, noise=noise)
        if rank == 0 and len(record["loss"]) < t["check_steps"]:
            record["noise"].append(noise)
            record["loss"].append(metrics["loss"].detach().clone())
            if record["mu1"] is None:
                record["mu1"] = [x.clone() for x in ref_params.leaves(new.mu)]
        return new, metrics
    return cfg, mesh, group, loader, state, step, record


def param_spread(state, mesh):
    """The largest difference of a parameter between the ranks (0 where
    every rank holds the same bits)."""
    flat = torch.cat([x.detach().float().reshape(-1)
                      for x in ref_params.leaves(state.params)])
    hi, lo = flat.clone(), flat.clone()
    g = mesh.groups["data"]
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=g)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=g)
    return float((hi - lo).abs().max())


def trace_steps(h, loader, state, step, epoch, mesh):
    """``trace_steps`` steps of epoch ``epoch`` on every rank, traced on
    rank 0 as ``train_epoch.trace_steps`` traces one process."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.ops import ioc_bwd
    from desire_tpu_torch.train import trainer
    n = h.traffic["trace_steps"]

    class Ranged:
        drop_remainder = loader.drop_remainder
        cfg = loader.cfg

        def epoch_batches(self, epoch, start_batch=0, rows=None):
            it = loader.epoch_batches(epoch, start_batch, rows=rows)
            for _ in range(n):
                with torch.profiler.record_function("bench::loader"):
                    batch = next(it, None)
                if batch is None:
                    return
                yield batch

    def ranged_step(*a):
        with torch.profiler.record_function("bench::step"):
            return step(*a)
    if mesh.coords[0] != 0:
        state, _ = trainer.run_epoch(state, Ranged(), epoch, step,
                                     log_every=h.traffic["log_every"],
                                     mesh=mesh)
        return state, None
    tr = Tracer()
    tr.wrap(trainer, "batch_to_device", "copy")
    tr.wrap(ops, "ioc_refine_train", "ioc_refine_train")
    tr.wrap(ioc_bwd, "ioc_refine_bwd_cuda", "ioc_bwd")
    tr.wrap(trainer, "apply_updates", "adam")
    with tr.window():
        state, _ = trainer.run_epoch(state, Ranged(), epoch, ranged_step,
                                     log_every=h.traffic["log_every"],
                                     mesh=mesh)
    h.log(tr.result.summary())
    return state, tr.result


def rank_main(h, rank, ranks, port):
    """One rank's run: set-up, the first steps, the window and the traced
    steps. Rank 0 returns its outcome and the function that compares the
    recorded steps with the reference's."""
    from desire_tpu_torch.train import trainer
    t = h.traffic
    cfg, mesh, group, loader, state, step, record = setup(h, rank, ranks,
                                                          port)
    try:
        state, _ = trainer.run_epoch(state, loader, 0, step,
                                     log_every=t["log_every"],
                                     max_batches=t["check_steps"], mesh=mesh)
        spread = param_spread(state, mesh)
        if rank == 0:
            record["after"] = [x.clone()
                               for x in ref_params.leaves(state.params)]
        epoch, first = 0, t["check_steps"]
        if rank == 0:
            start = h.start_window()
        else:
            import gc
            gc.collect()
            gc.freeze()
            start = time.perf_counter()
        timed = AgreedLoader(loader, group, start + h.seconds, rank)
        while not timed.stopped:
            state, _ = trainer.run_epoch(state, timed, epoch, step,
                                         log_every=t["log_every"],
                                         start_batch=first, mesh=mesh)
            epoch, first = epoch + 1, 0
        if h.device.type == "cuda":
            torch.cuda.synchronize(h.device)
        window_s = time.perf_counter() - start
        steps = timed.batches
        peak = common.memory_peak(h.device)
        trace = None
        if h.trace:
            state, trace = trace_steps(h, loader, state, step, epoch, mesh)
        spread = max(spread, param_spread(state, mesh))
        if rank != 0:
            return None
        h.log_chunks(start, timed.ends, "batches")
        loader_ms = 1e3 * timed.seconds / max(steps, 1)
        h.log(f"window: {steps} steps of {ranks} x {t['batch']} windows in "
              f"{window_s:.4f} s, loader {loader_ms:.4f} ms a batch, "
              f"{loader.num_batches} batches an epoch, peak {peak} B, "
              f"parameter spread over ranks {spread!r}")
        # no step in the window (the control's readings): no step time
        result = common.Outcome(
            e2e={"train_step_ms": 1e3 * window_s / steps if steps else None},
            attempted=steps, failed=0, memory_peak_bytes=peak, trace=trace,
            ctx={"steps_per_s": steps / window_s, "loader_ms": loader_ms,
                 "batch": t["batch"], "agents": cfg.max_num_obj,
                 "k": cfg.num_samples})
        del state

        def finish():
            got = checks(h, cfg, record, loader.num_batches, spread,
                         "fp8" if h.control else "f32")
            for name, limit in h.limits().items():
                h.check(name, got[name], limit)
            if getattr(h, "readings", None) is not None:
                h.readings = (got, checks(h, cfg, record, loader.num_batches,
                                          spread, "fp8"))
        return result, finish
    finally:
        dist.destroy_process_group()


def global_batches(cfg, device, n):
    """The first n global batches of epoch 0, every row, from an
    unsharded loader."""
    from desire_tpu_torch.data.loader import SDDLoader
    from desire_tpu_torch.train import trainer
    loader = SDDLoader(cfg, split="train")
    out = []
    for batch in loader.epoch_batches(0):
        out.append(tuple(trainer.batch_to_device(batch, device)[:3]))
        if len(out) == n:
            break
    return out


def checks(h, cfg, record, steps_per_epoch, spread, prec):
    """Rank 0's numbers: the recorded steps against the reference's on the
    global batches (with prec other than f32, the reference at that
    precision in the program's place: the control), and the ranks'
    parameter spread."""
    common.release(h.device)
    if "batches" not in record:
        record["batches"] = global_batches(cfg, h.device,
                                           len(record["loss"]))
    with recomputed():
        got = train_epoch.gaps(h, record, steps_per_epoch, prec=prec)
    got["rank_param_spread"] = spread
    return got


@contextlib.contextmanager
def recomputed():
    """The reference's sampler and IOC passes recomputed in its backward
    (``torch.utils.checkpoint``): the same products on the same inputs, so
    the same gradients, in about a third of the memory, so that a global
    batch of ranks x batch windows fits on one card."""
    from torch.utils.checkpoint import checkpoint
    from benchmark_torch.reference import model as ref
    saved = {name: getattr(ref, name) for name in ("sgm", "ioc_pass")}

    def wrap(fn):
        return lambda *a, **kw: checkpoint(fn, *a, use_reentrant=False,
                                           **kw)
    try:
        for name, fn in saved.items():
            setattr(ref, name, wrap(fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)


FAULTS = ("unchanged", "unreduced", "half")
# the faults planted on every rank; the others go on rank 0 alone
EVERY_RANK = ("half",)
# the fault the ranks of the next run plant (rehearsals and readings)
PLANTED = None


def _first_half(v, ranks):
    """The global draws of each rank's first half of its windows: a
    rank's rows are a contiguous block of the leading dimension, window
    by window."""
    per = v.shape[0] // ranks
    return v.reshape(ranks, per, *v.shape[1:])[:, :per // 2].reshape(
        -1, *v.shape[1:])


def plant(fault, step_fn, ranks):
    """The step with one fault: ``unchanged`` (``train_epoch.plant``'s:
    it returns the state it was given) or ``unreduced`` (the step's
    all-reduce runs, but the rank updates with its own gradients), each
    planted on one rank; or ``half``, planted on every rank: each trains
    on the first half of its rows and their draws, so the step's gradient
    is the mean over half of the global batch and the ranks still agree."""
    if fault == "half":
        def half(state, xy, mask, ids, *img, noise):
            b = xy.shape[0] // 2
            cut = {k: _first_half(v, ranks) for k, v in noise.items()}
            return step_fn(state, xy[:b], mask[:b], ids[:b],
                           *[x[:b] for x in img], noise=cut)
        return half
    if fault != "unreduced":
        return train_epoch.plant(fault, step_fn)
    from desire_tpu_torch.train import trainer
    orig = trainer._reduce_over_mesh

    def local(mesh, grads, metrics):
        orig(mesh, grads, metrics)
        return grads, metrics

    def step(*a, **kw):
        trainer._reduce_over_mesh = local
        try:
            return step_fn(*a, **kw)
        finally:
            trainer._reduce_over_mesh = orig
    return step


def readings(h, requests, fault=None):
    """The program's numbers over the first ``check_steps`` steps of all
    ranks, with ``fault`` planted (``PLANTED``), and the float8 control's
    on the same batches and draws (``benchmark_torch.control``; no
    window)."""
    global PLANTED
    h.seconds, h.trace, h.readings = 0.0, False, ()
    PLANTED = fault
    try:
        run(h)
    finally:
        PLANTED = None
    return h.readings


def _rank(path, rank, ranks, port):
    """Rank ``rank`` of the run whose cell, configuration and arguments
    rank 0 wrote to ``path``."""
    import argparse
    from benchmark_torch import run as harness
    global PLANTED
    with open(path) as fh:
        spec = json.load(fh)
    PLANTED = spec["planted"]
    args = argparse.Namespace(**{k: spec[k] for k in (
        "seed", "seconds", "trace", "toy", "control")})
    h = harness.Harness(args, spec["cell"], spec["config"])
    h.device = torch.device(spec["device"])
    torch.manual_seed(h.seed % 2 ** 63)
    torch.set_num_threads(2)
    ppid = os.getppid()

    def orphaned():
        # rank 0 gone: nothing would end this rank's collectives
        while os.getppid() == ppid:
            time.sleep(1.0)
        os._exit(1)
    threading.Thread(target=orphaned, daemon=True).start()
    rank_main(h, rank, ranks, port)


if __name__ == "__main__":
    _rank(sys.argv[1], *map(int, sys.argv[2:5]))
    sys.exit(0)
