"""The rehearsal on the CPU before chip time, and the proof that the
comparison deciding ``correct`` can fail: every cell of BENCHMARK.json
runs end to end through ``run.main`` at the toy sizes of its files
(float32 there, so the sound program meets the reference to rounding),
plain and traced, and reads ``correct`` true; the same run with the
control (the reference in float8) in the program's place, or with a fault
of the timed path planted underneath, reads ``correct`` false. The FLOP
counts the configurations record are recounted.

    python3 -m pytest benchmark_torch/test_correctness.py -q

On a card at a cell's own size the readings the limits are set from come
from ``python3 -m benchmark_torch.control``. No number these tests print
is a measurement of the card.
"""

from __future__ import annotations

import json
import os

import pytest

from benchmark_torch import flops, work
from benchmark_torch import run as harness
from benchmark_torch.drivers import serve_batch, train_epoch

CELLS = {"flagship.serve_b64": serve_batch.FAULTS,
         "refgeom_conv.serve_b64": serve_batch.FAULTS,
         "flagship.train_sdd": train_epoch.FAULTS}


def _bench():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _run(cell, capsys, *extra, seed="2900000017"):
    rc = harness.main(["--workload", cell, "--seed", seed,
                       "--seconds", "0.5", "--device", "cpu", "--toy",
                       *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_every_cell_is_rehearsed():
    assert sorted(CELLS) == sorted(w["name"] for w in _bench()["workloads"])


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
    if cell == "flagship.train_sdd":
        from desire_tpu_torch.train import trainer
        orig = trainer.make_train_step
        monkeypatch.setattr(trainer, "make_train_step",
                            lambda *a, **kw: train_epoch.plant(
                                fault, orig(*a, **kw)))
        return lambda: None
    if fault == "unrefined":
        return serve_batch.plant(fault, None)[1]
    from desire_tpu_torch.serve import Predictor
    orig = Predictor.predict_windows

    def broken(self, *a, **kw):
        out = orig(self, *a, **kw)
        return serve_batch.plant(fault, lambda i: out)[0](0)
    monkeypatch.setattr(Predictor, "predict_windows", broken)
    return lambda: None


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELLS)
                                        for f in CELLS[c]])
def test_fault_is_caught(cell, fault, monkeypatch, capsys):
    undo = _plant(monkeypatch, cell, fault)
    try:
        line = _run(cell, capsys)
    finally:
        undo()
    assert not line["correct"], line["checks"]


def _configs():
    out = []
    for entry in _bench()["configs"]:
        with open(os.path.join(harness.ROOT, entry["file"])) as fh:
            out.append((entry["name"], json.load(fh)))
    return out


@pytest.mark.parametrize("name,config", _configs())
def test_recorded_flops_recount(name, config):
    """Each count the configuration records, recounted on the meta
    device at its shape."""
    for kind in ("forward", "step"):
        for key, recorded in config["flops"][kind].items():
            b, a, k = (int(x[1:]) for x in key.split("."))
            assert flops.count(config["model"], b, a, k,
                               kind == "step") == recorded, (kind, key)


@pytest.mark.parametrize("name,config", _configs())
@pytest.mark.parametrize("train", [False, True])
def test_meta_count_is_the_count_of_a_real_run(name, config, train):
    """At a toy shape the meta device's count equals the count of the
    same reference run on CPU tensors."""
    toy = dict(config["model"], **config["toy"])
    a = toy["max_num_obj"]
    meta = flops.count(toy, 2, a, 3, train)
    assert meta > 0
    assert flops.count(toy, 2, a, 3, train, "cpu") == meta, \
        work.shape_key(2, a, 3)
