"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark_torch.run --workload flagship.serve_b64 --seed 7 \\
        --seconds 15 --trace 0

Everything a cell needs is found by name: the cell in
``benchmark_torch/workloads/<cell>.json`` (its configuration, its driver
and its traffic parameters), the configuration in the file that
``BENCHMARK.json`` names for it, the driver in
``benchmark_torch/drivers/<driver>.py`` and each per-layer metric in
``benchmark_torch/metrics/<metric>.py``. With ``--trace 0`` the line
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, ``busy_s``, ``window_s`` and the trace's ``breakdown``.

The run exits non-zero and prints no result where CUDA is missing or has
fewer cards than the cell asks for. ``--device cpu --toy`` runs the cell
on the CPU at the toy sizes its files give (the rehearsal of
``test_correctness.py``); such a line is no measurement of the card.
``--control`` checks the control's answers, the reference in float8, in
the place of the program's on the same inputs: its ``correct`` has to
come out false. The benchmark's own runs pass neither.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()   # the process's start, before any heavy import

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Harness:
    """One run: its arguments, the cell's and configuration's files, the
    set-up clock and the correctness checks the driver records."""

    def __init__(self, args, cell, config):
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.toy = bool(args.toy)
        self.control = bool(args.control)
        self.cell = cell
        self.config = config
        self.model = dict(config["model"])
        if self.toy:
            self.model.update(config.get("toy", {}))
        self.traffic = dict(cell["traffic"])
        if self.toy:
            self.traffic.update(cell.get("toy", {}))
        self.device = None
        self.setup_s = None
        self.checks = []
        self.cache = os.path.join(HERE, "_cache")

    def log(self, msg):
        print(msg, file=sys.stderr, flush=True)

    def desire_config(self, **extra):
        from desire_tpu_torch.config import DesireConfig
        return DesireConfig(**{**self.model, **extra})

    def start_window(self):
        """Marks the end of set-up: the first timed call comes next. The
        objects set-up left are collected once and frozen, so the window's
        collections do not scan them again."""
        import gc
        gc.collect()
        gc.freeze()
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        self.setup_s = time.perf_counter() - T0
        return time.perf_counter()

    def log_chunks(self, start, ends, what, chunk=10.0):
        """How many of ``what`` ended in each ``chunk`` seconds of the
        window (a drift inside the run shows here, apart from one between
        runs)."""
        counts = {}
        for t in ends:
            n = int((t - start) // chunk)
            counts[n] = counts.get(n, 0) + 1
        self.log(f"{what} a {chunk:g} s chunk: "
                 + " ".join(str(counts.get(n, 0))
                            for n in range(max(counts, default=-1) + 1)))

    def check(self, name, value, limit):
        """A number compared with its limit: correct where value <= limit
        (a NaN fails)."""
        self.checks.append((name, float(value), float(limit)))

    def limits(self):
        return self.cell["limits"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell_metrics(bench, cell_name, kind):
    """The cell's metrics of BENCHMARK.json's ``kind`` list."""
    e2e = bench["end_to_end"]
    reported = {m["name"] for m in e2e
                if cell_name in m.get("workloads", [cell_name])}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in reported:
            out.append(m)
    return out


def _finite(x):
    return x is not None and math.isfinite(x)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--toy", action="store_true",
                    help="the toy sizes of the cell's files (rehearsal)")
    ap.add_argument("--control", action="store_true",
                    help="compare the control (the reference in float8) "
                         "in the program's place: correct has to be false")
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        raise SystemExit(f"unknown workload {args.workload!r}")
    with open(os.path.join(HERE, "workloads", args.workload + ".json")) as fh:
        cell = json.load(fh)
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(os.path.join(ROOT, cfg_entry["file"])) as fh:
        config = json.load(fh)

    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: nothing measured", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < entry["chips"]:
            print(f"{entry['chips']} cards asked, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 3
    # the loader's index cache lives in the checkout, at a fixed path
    h = Harness(args, cell, config)
    os.environ["DESIRE_TORCH_CACHE_DIR"] = os.path.join(h.cache, "index")
    torch.manual_seed(h.seed % 2 ** 63)
    # one process, few host threads: steadier host timings
    torch.set_num_threads(2)
    h.device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    driver = importlib.import_module(
        f"benchmark_torch.drivers.{cell['driver']}")
    out = driver.run(h)

    e2e = {}
    for m in _cell_metrics(bench, args.workload, "end_to_end"):
        val = h.setup_s if m["name"] == "setup_s" else out.e2e.get(m["name"])
        if _finite(val):
            e2e[m["name"]] = {"value": val, "unit": m["unit"]}
    metrics = e2e
    device = {"platform": "gpu" if h.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(h.device)
                       if h.device.type == "cuda" else "cpu"),
              "count": entry["chips"],
              "memory_peak_bytes": out.memory_peak_bytes}
    result = {}
    if h.trace:
        ctx = dict(out.ctx, trace=out.trace, model=h.model, cell=h.traffic,
                   config=h.config)
        metrics = {}
        for m in _cell_metrics(bench, args.workload, "per_layer"):
            reader = _load(os.path.join(HERE, "metrics", m["name"] + ".py"),
                           "benchmark_metric_" + m["name"].replace(".", "_"))
            val = reader.read(ctx)
            if _finite(val):
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        device.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
        result["breakdown"] = out.trace.breakdown()
    correct = bool(h.checks) and all(v <= lim for _, v, lim in h.checks)
    for name, v, lim in h.checks:
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    line.update(result)
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in h.checks}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
