"""The readings a cell's limits are set from, over many seeds in one
process: the program's numbers against the reference (sound, or with one
fault of the timed path planted) and the control's, the reference in the
precision below the configured one (float8 e4m3 for bfloat16) in the
program's place, on the same inputs.

    python3 -m benchmark_torch.control --workload flagship.serve_b64 \\
        --seeds 12 --first 1000 --requests 4 [--fault half]

One JSON line a seed, then the summary: each number's largest sound
reading (the lower reading), its smallest control reading, and with
``--fault`` the fault's smallest. The benchmark's own runs never run
this; ``test_correctness.py`` runs the control through the harness
(``run.py --control``) at the toy size.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import torch

from benchmark_torch import run as harness


def readings(cell_name, seeds, requests, fault=None, device="cuda",
             toy=False):
    """[(seed, program numbers, control numbers)] of the cell."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    entry = {w["name"]: w for w in bench["workloads"]}[cell_name]
    with open(os.path.join(harness.HERE, "workloads",
                           cell_name + ".json")) as fh:
        cell = json.load(fh)
    cfg_file = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(os.path.join(harness.ROOT, cfg_file["file"])) as fh:
        config = json.load(fh)
    driver = importlib.import_module(
        f"benchmark_torch.drivers.{cell['driver']}")
    out = []
    for seed in seeds:
        args = argparse.Namespace(seed=seed, seconds=0.0, trace=0, toy=toy,
                                  control=False)
        h = harness.Harness(args, cell, config)
        h.device = torch.device("cuda:0" if device == "cuda" else "cpu")
        os.environ["DESIRE_TORCH_CACHE_DIR"] = os.path.join(h.cache, "index")
        program, control = driver.readings(h, requests, fault)
        out.append((seed, program, control))
        print(json.dumps({"seed": seed, "fault": fault, "program": program,
                          "control": control}), flush=True)
    return out


def summary(rows, limits):
    names = rows[0][1].keys()
    return {n: {"program_min": min(r[1][n] for r in rows),
                "program_max": max(r[1][n] for r in rows),
                "control_min": min(r[2][n] for r in rows),
                "limit": limits.get(n)} for n in names}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--toy", action="store_true")
    a = ap.parse_args(argv)
    seeds = [a.first + 7919 * i for i in range(a.seeds)]
    rows = readings(a.workload, seeds, a.requests, a.fault, a.device, a.toy)
    with open(os.path.join(harness.HERE, "workloads",
                           a.workload + ".json")) as fh:
        limits = json.load(fh)["limits"]
    print(json.dumps({"workload": a.workload, "fault": a.fault,
                      "summary": summary(rows, limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
