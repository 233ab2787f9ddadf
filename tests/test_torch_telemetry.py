"""The port's spans and counters (desire_tpu_torch/utils/telemetry.py): self
time on a fixed clock, set-up charged to set-up, no profiler range without
a profiler, the ranges' nesting and ids under one, the serving and
training counters, idle time by span, the exporters, and the benchmark's
metrics that read them, on toy shapes on the CPU."""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark_torch import program_spans
from benchmark_torch import run as harness
from desire_tpu_torch import ops
from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.data.loader import SDDLoader
from desire_tpu_torch.params import init_desire
from desire_tpu_torch.serve import Predictor, StreamServer
from desire_tpu_torch.train import run, trainer
from desire_tpu_torch.train.state import create_train_state
from desire_tpu_torch.utils import telemetry

_TOY = dict(batch_size=4, max_num_obj=8, obs_len=4, pred_len=4,
            subsample=2, window_hop=2, num_samples=3, d_dim=16,
            latent_size=8, embedding_size=8, channel_multiplier=10,
            scene_grid=8, scene_channels=4, num_refine=2,
            compute_dtype="float32", seed=0, save_every=10_000)
SERVING = ("serve.assemble", "serve.copy_in", "serve.forward",
           "serve.copy_back", "serve.answers")
STAGES = ("model.sgm", "model.scf", "model.ioc")


@pytest.fixture(autouse=True)
def fresh():
    telemetry.reset()
    yield
    telemetry.reset()


class FakeClock:
    """perf_counter_ns that moves only when told."""

    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


def _spans():
    return telemetry.snapshot()["spans"]


def test_self_time_is_inclusive_minus_children(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(telemetry, "_clock", clock)
    with telemetry.span("outer", 5) as outer:
        clock.now += 10
        with telemetry.span("inner") as inner:
            clock.now += 30
            with telemetry.span("leaf"):
                clock.now += 7
        clock.now += 2
        with telemetry.span("inner"):
            clock.now += 1
    assert inner.id == outer.id == 5
    got = _spans()
    assert got["outer"] == {"calls": 1, "total_s": 50e-9, "self_s": 12e-9}
    assert got["inner"] == {"calls": 2, "total_s": 38e-9, "self_s": 31e-9}
    assert got["leaf"] == {"calls": 1, "total_s": 7e-9, "self_s": 7e-9}


def test_setup_is_charged_to_setup_only(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(telemetry, "_clock", clock)
    with telemetry.span("serve.request"):
        clock.now += 4
        with telemetry.span("serve.forward"):
            clock.now += 3
            with telemetry.span("setup.kernels"):
                clock.now += 1000
                with telemetry.span("setup.inner"):
                    clock.now += 500
            clock.now += 2
    got = _spans()
    assert got["serve.request"]["total_s"] == pytest.approx(9e-9)
    assert got["serve.request"]["self_s"] == pytest.approx(4e-9)
    assert got["serve.forward"]["total_s"] == pytest.approx(5e-9)
    assert got["serve.forward"]["self_s"] == pytest.approx(5e-9)
    # the setup spans add up once: the outer one without the inner
    assert got["setup.kernels"]["total_s"] == pytest.approx(1000e-9)
    assert got["setup.inner"]["total_s"] == pytest.approx(500e-9)
    assert program_spans.setup_s() == pytest.approx(1500e-9)


def test_discarded_span_leaves_no_total():
    with telemetry.span("kept"):
        with telemetry.span("dropped") as sp:
            sp.discard = True
    assert set(_spans()) == {"kept"}


class CountingRange:
    entered = 0

    def __init__(self, name, args, kwargs):
        pass

    def __enter__(self):
        CountingRange.entered += 1

    def __exit__(self, *exc):
        return False


def test_no_profiler_range_without_a_profiler(monkeypatch):
    monkeypatch.setattr(telemetry, "_Range", CountingRange)
    CountingRange.entered = 0
    for _ in range(3):
        with telemetry.span("a", 1):
            with telemetry.span("b"):
                pass
    assert CountingRange.entered == 0
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("a", 1):
            pass
    assert CountingRange.entered == 1


def _predictor(**kw):
    cfg = DesireConfig(**_TOY)
    params = init_desire(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, Predictor(params, cfg, device="cpu", max_windows=3, **kw)


def _windows(cfg, n, rng):
    """n windows of 5-8 agents; agent 2 of each is gone at the last
    observed step, and one slot is empty."""
    out = []
    for i in range(n):
        a = 5 + i
        xy = rng.uniform(100, 900, (a, cfg.obs_len, 2)).astype(np.float32)
        mask = np.ones((a, cfg.obs_len), np.float32)
        mask[2, -1] = 0.0
        ids = np.arange(1, a + 1, dtype=np.int64)
        ids[-1] = 0
        out.append((xy, mask, ids))
    return out


def _ranges(prof):
    got = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(telemetry.PREFIX):
            got.append((e.name()[len(telemetry.PREFIX):], e.start_ns(),
                        e.start_ns() + e.duration_ns(),
                        e.kwinputs().get("id")))
    return got


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_profiled_request_nests_its_spans_with_its_id():
    cfg, pred = _predictor()
    windows = _windows(cfg, 2, np.random.default_rng(0))
    pred.predict_windows(windows, scales=100.0)        # request 0
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        pred.predict_windows(windows, scales=100.0)    # request 1
    ranges = _ranges(prof)
    (request,) = [r for r in ranges if r[0] == "serve.request"]
    assert request[3] == 1
    by_name = {r[0]: r for r in ranges}
    assert set(by_name) == {"serve.request", *SERVING, *STAGES}
    assert all(r[3] == 1 for r in ranges)
    for name in SERVING:
        assert _inside(by_name[name], request), name
    for name in STAGES:
        assert _inside(by_name[name], by_name["serve.forward"]), name
    # the idle time of a trace with no device activity: the whole window,
    # each part under the innermost span open
    busy, spans, window = telemetry.profile_intervals(prof)
    idle = telemetry.idle_by_span(busy, spans, window)
    assert not busy and set(idle) <= {"serve.request", *SERVING, *STAGES}
    assert sum(idle.values()) == pytest.approx((window[1] - window[0]) / 1e9)


def test_serving_counters_stats_and_launch_group():
    cfg, pred = _predictor()
    rng = np.random.default_rng(1)
    pred.warmup()
    telemetry.reset()
    sizes = (3, 1)
    for n in sizes:
        pred.predict_windows(_windows(cfg, n, rng), scales=50.0)
    counters = telemetry.snapshot()["counters"]
    assert counters["serve.slots"] == len(sizes) * 3 * cfg.max_num_obj
    # each window: 5 + i agents, one empty slot, one gone at the end
    live = sum(5 + i - 2 for n in sizes for i in range(n))
    assert counters["serve.live_slots"] == live
    assert program_spans.share_pct("serve.live_slots", "serve.slots") == (
        pytest.approx(100.0 * live / (len(sizes) * 3 * cfg.max_num_obj)))
    # the launch counts are the registry's launch group, as before
    assert ops.LAUNCHES is telemetry.LAUNCHES
    assert {f"launch.{k}" for k in ops.LAUNCHES} <= set(counters)
    ops.LAUNCHES["sgm_sample"] += 2
    assert telemetry.snapshot()["counters"]["launch.sgm_sample"] == 2
    ops.reset_launch_counts()
    assert not any(ops.LAUNCHES.values())
    st = pred.stats()
    assert st["calls"] == len(sizes)
    assert st["windows_per_sec"] == pytest.approx(
        1e3 * sum(sizes) / (st["latency_ms_mean"] * len(sizes)))
    assert set(st["span_ms"]) == {"serve.request", *SERVING, *STAGES}
    # the latency holds the whole request: assembly and answers too
    spans = _spans()
    assert st["latency_ms_mean"] == pytest.approx(
        1e3 * spans["serve.request"]["total_s"] / len(sizes), rel=1e-6)
    assert spans["serve.request"]["calls"] == len(sizes)


def test_stream_history_span():
    cfg, pred = _predictor()
    server = StreamServer(pred, scale=100.0)
    outs = [server.observe(f, [(1, 10.0 + f, 20.0), (2, 30.0, 5.0 + f)])
            for f in range(0, 2 * cfg.obs_len + 2, cfg.subsample)]
    due = [o for o in outs if o is not None]
    assert due and _spans()["stream.history"]["calls"] == len(due)
    assert pred.stats()["span_ms"]["stream.history"] > 0


def _video(path, seed, frames=60):
    rng = np.random.RandomState(seed)
    recs = []
    for aid in range(1, 6):
        v, p0 = rng.uniform(-1.5, 1.5, 2), rng.uniform(20, 80, 2)
        recs += [(f, aid, *(p0 + v * f)) for f in range(frames)]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for row in np.asarray(recs, np.float64).T:
            f.write(",".join(f"{x:g}" for x in row) + "\n")


@pytest.fixture
def tree(tmp_path, monkeypatch):
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    root = tmp_path / "data"
    for i in range(2):
        _video(str(root / f"scene/video{i}/annotations_processed.csv"), i)
    return str(root)


def test_run_epoch_spans_and_counters(tree):
    cfg = DesireConfig(**dict(_TOY, data_dir=tree, holdout="none"))
    loader = SDDLoader(cfg)
    assert _spans()["setup.loader_index"]["calls"] == 2
    params = init_desire(cfg, torch.Generator().manual_seed(0), "cpu")
    state = create_train_state(cfg, params, seed=0)
    step_fn = trainer.make_train_step(cfg, loader.num_batches)
    records = []
    telemetry.reset()
    state, _ = trainer.run_epoch(state, loader, 0, step_fn,
                                 log_fn=lambda m, s: records.append(m),
                                 log_every=2, max_batches=3)
    spans, counters = _spans(), telemetry.snapshot()["counters"]
    assert spans["train.step"]["calls"] == 3
    for name in ("train.loader", "train.copy", "train.forward",
                 "train.backward", "train.optimizer", *STAGES):
        assert spans[name]["calls"] == 3, name
    assert spans["train.sync"]["calls"] == 2          # batches 0 and 2
    assert counters["train.slots"] == 3 * cfg.batch_size * cfg.max_num_obj
    live = sum(int(np.count_nonzero(b.ids)) for b in
               list(loader.epoch_batches(0))[:3])
    assert counters["train.live_slots"] == live
    # each record: every span's mean ms since the previous one
    assert [r["batch"] for r in records] == [0, 2]
    assert records[0]["span_ms"]["train.loader"] > 0
    assert "train.step" not in records[0]["span_ms"]   # still open then
    assert records[1]["span_ms"]["train.step"] > 0
    # a whole epoch: the last, empty wait for a batch is no step
    telemetry.reset()
    trainer.run_epoch(state, loader, 1, step_fn, log_every=100)
    spans = _spans()
    assert spans["train.step"]["calls"] == loader.num_batches
    assert spans["train.loader"]["calls"] == loader.num_batches
    assert spans["loader.assemble"]["calls"] == loader.num_batches
    step = spans["train.step"]
    assert 0 <= step["self_s"] < step["total_s"]


def test_profile_event_carries_idle_by_span(tree, tmp_path):
    cfg = DesireConfig(**dict(_TOY, data_dir=tree, holdout="none",
                              num_epochs=1, save_dir=str(tmp_path / "ckpt")))
    run.train(cfg, eval_every=0, max_train_batches=2, device="cpu",
              profile_dir=str(tmp_path / "prof"))
    with open(os.path.join(cfg.save_dir, "metrics.jsonl")) as f:
        (event,) = [e for e in map(json.loads, f)
                    if e["event"] == "profile"]
    idle = event["idle_by_span"]
    assert idle and {"train.loader", "train.forward"} <= set(idle)
    assert all(v >= 0 for v in idle.values())
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ids = {name: sorted(e["args"]["id"] for e in events
                        if e.get("name") == "desire::train." + name)
           for name in ("step", "loader", "copy")}
    # the last wait finds no batch: a range in the trace, no step in the
    # totals
    assert ids == {"step": [0, 1, 2], "loader": [0, 1, 2], "copy": [0, 1]}


def test_idle_by_span_splits_gaps_by_time():
    # ns: window 0-100; the device busy 10-20 and 60-70
    busy = [(10, 20), (60, 70)]
    spans = [("request", 0, 90), ("assemble", 5, 40), ("copy_back", 40, 65),
             ("answers", 65, 80)]
    got = telemetry.idle_by_span(busy, spans, (0, 100))
    # the gap 20-60 starts under assemble and ends under copy_back
    assert got == pytest.approx({"request": 15e-9, "assemble": 25e-9,
                                 "copy_back": 20e-9, "answers": 10e-9,
                                 "outside": 10e-9})
    assert telemetry.idle_by_span([(0, 100)], spans, (0, 100)) == {}
    # overlapping device work and a window cut inside it
    assert telemetry.idle_by_span([(0, 30), (20, 50)], [], (10, 60)) == (
        pytest.approx({"outside": 10e-9}))


def test_snapshot_delta_and_mean_ms(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(telemetry, "_clock", clock)
    with telemetry.span("a"):
        clock.now += 2_000_000
    before = telemetry.snapshot()
    for _ in range(2):
        with telemetry.span("a"):
            clock.now += 1_000_000
    with telemetry.span("b"):
        clock.now += 3_000_000
    d = telemetry.delta(before, telemetry.snapshot())
    assert telemetry.mean_ms(d) == pytest.approx({"a": 1.0, "b": 3.0})
    assert telemetry.mean_ms(d, ("b",)) == pytest.approx({"b": 3.0})
    telemetry.count("c", 4)
    telemetry.reset()
    snap = telemetry.snapshot()
    assert snap["spans"] == {} and "c" not in snap["counters"]


NEW_METRICS = ("assemble_ms.serve", "copy_in_ms.serve",
               "forward_host_ms.serve", "copy_back_ms.serve",
               "answers_ms.serve", "slot_fill.serve", "loader_wait_ms.train",
               "forward_host_ms.train", "backward_host_ms.train",
               "optimizer_ms.train", "slot_fill.train", "program_setup_s")


@pytest.fixture
def harness_env(monkeypatch):
    """run.main sets the loader's cache directory and the thread count:
    both are put back after the test."""
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", "")
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", ["flagship.serve_b64", "flagship.train_sdd"])
def test_benchmark_reads_the_program_metrics(cell, capsys, harness_env):
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        per_layer = json.load(fh)["per_layer"]
    want = [m["name"] for m in per_layer
            if m["name"] in NEW_METRICS and cell in m["workloads"]]
    assert len(want) == (6 if "serve" in cell else 5) + 1
    rc = harness.main(["--workload", cell, "--seed", "2900000023",
                       "--seconds", "0.3", "--device", "cpu", "--toy",
                       "--trace", "1"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    for name in want:
        assert math.isfinite(line["metrics"][name]["value"]), name


def test_metrics_read_nothing_without_the_registry(monkeypatch):
    """Over a program that has no telemetry module, every reader returns
    None and raises nothing."""
    import desire_tpu_torch.utils
    monkeypatch.setitem(sys.modules, "desire_tpu_torch.utils.telemetry",
                        None)
    monkeypatch.delattr(desire_tpu_torch.utils, "telemetry")
    assert program_spans.span_ms("serve.assemble") is None
    assert program_spans.share_pct("serve.live_slots", "serve.slots") is None
    assert program_spans.setup_s() is None


def test_deferred_share_reads_the_launch_counts(monkeypatch):
    """``ioc_bwd_deferred_share``: the weight-gradient product's launches
    over the IOC backward's, in %; nothing where the program counts no
    such kernel (a program before it) or ran no backward."""
    reader = harness._load(
        os.path.join(harness.HERE, "metrics", "ioc_bwd_deferred_share.py"),
        "benchmark_metric_ioc_bwd_deferred_share")
    telemetry.reset()
    assert reader.read({}) is None        # no backward call yet
    ops.LAUNCHES["ioc_refine_bwd"] += 4
    ops.LAUNCHES["ioc_bwd_wgrad"] += 3
    assert reader.read({}) == pytest.approx(75.0)
    monkeypatch.delitem(telemetry.LAUNCHES, "ioc_bwd_wgrad")
    assert reader.read({}) is None        # a program without the kernel
    monkeypatch.undo()
    telemetry.reset()
    assert ops.LAUNCHES["ioc_bwd_wgrad"] == 0
