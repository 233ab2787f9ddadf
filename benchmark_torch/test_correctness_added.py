"""The rehearsal on the CPU of the cells that ``test_correctness.py`` does
not list, by the same pattern: each runs end to end through ``run.main``
at the toy sizes of its files (float32), plain and traced, and reads
``correct`` true; the control (the reference in float8) in the program's
place, or a fault of the timed path planted underneath, reads ``correct``
false. ``flagship.train_dp4`` runs as four gloo ranks on the CPU, its
faults planted as ``train_dp.PLANTED`` says: ``half`` on every rank, the
others on rank 0 (this process). The FLOP counts that
``desire_crowd128`` records are recounted.

    python3 -m pytest benchmark_torch/test_correctness_added.py -q

No number these tests print is a measurement of the card.
"""

from __future__ import annotations

import json
import os

import pytest

from benchmark_torch import flops
from benchmark_torch import run as harness
from benchmark_torch import test_correctness as first
from benchmark_torch.drivers import serve_batch, train_dp

CELLS = {"crowd128.serve_b64": serve_batch.FAULTS,
         "flagship.train_dp4": train_dp.FAULTS}


def _run(cell, capsys, *extra, seed="2900000017"):
    rc = harness.main(["--workload", cell, "--seed", seed,
                       "--seconds", "0.5", "--device", "cpu", "--toy",
                       *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_every_cell_is_rehearsed_in_one_of_the_two_files():
    names = sorted(w["name"] for w in first._bench()["workloads"])
    assert sorted([*first.CELLS, *CELLS]) == names


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("seed", ["2900000031", "2900000033"])
def test_control_fails(cell, seed, capsys):
    line = _run(cell, capsys, "--control", seed=seed)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", ["0", "1"])
def test_sound_run_is_correct(cell, trace, capsys):
    line = _run(cell, capsys, "--trace", trace)
    assert line["correct"], line["checks"]
    if trace == "1":
        assert {"busy_s", "window_s"} <= line["device"].keys(), line
        assert "breakdown" in line, line


def _plant(monkeypatch, cell, fault):
    if cell == "flagship.train_dp4":
        monkeypatch.setattr(train_dp, "PLANTED", fault)
        return lambda: None
    return first._plant(monkeypatch, cell, fault)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELLS)
                                        for f in CELLS[c]])
def test_fault_is_caught(cell, fault, monkeypatch, capsys):
    undo = _plant(monkeypatch, cell, fault)
    try:
        line = _run(cell, capsys)
    finally:
        undo()
    assert not line["correct"], line["checks"]


def test_dp_fault_shows_in_the_rank_spread(monkeypatch, capsys):
    """A rank that updates with its own gradients leaves the ranks'
    parameters apart."""
    _plant(monkeypatch, "flagship.train_dp4", "unreduced")
    line = _run("flagship.train_dp4", capsys)
    assert line["checks"]["rank_param_spread"]["value"] > 0, line["checks"]


def _crowd():
    entry = {c["name"]: c for c in first._bench()["configs"]}[
        "desire_crowd128"]
    with open(os.path.join(harness.ROOT, entry["file"])) as fh:
        return json.load(fh)


def test_crowd_flops_recount():
    """The counts desire_crowd128 records, recounted on the meta device at
    B64.A128.K20."""
    config = _crowd()
    for kind in ("forward", "step"):
        assert list(config["flops"][kind]) == ["B64.A128.K20"]
        assert flops.count(config["model"], 64, 128, 20,
                           kind == "step") == config["flops"][kind][
                               "B64.A128.K20"], kind


def test_crowd_toy_crosses_64_agents():
    """The rehearsal's toy size runs more than 64 agents a lane."""
    config = _crowd()
    assert config["toy"]["max_num_obj"] > 64
    assert config["model"]["max_num_obj"] == 128
