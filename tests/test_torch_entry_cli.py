"""The port's evaluation and forecasting entry points on the CPU
(``--device cpu``) over a toy tree, with a checkpoint of the port's own
training entry point (an imagery model: its raster reaches every path):
``python -m desire_tpu_torch.evaluate`` (random params, with the JAX
``evaluate.main``'s result keys, and from the checkpoint with a dump and
the calibration fit), ``python -m desire_tpu_torch.predict`` in file and
stream mode (tests/test_serve.py's CLI tests, mirrored),
``python -m desire_tpu_torch.bench_serve``, and no fallback to the CPU
without a card (``python -m desire_tpu_torch.bench`` too)."""

import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desire_tpu_torch import bench, bench_serve, evaluate, predict
from desire_tpu_torch.params import init_desire, to_numpy
from desire_tpu_torch.train import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_torch_train_entry.py's toy model, with a one-channel scene
# raster (the occupancy prior of each video)
_TOY = dict(batch_size=4, max_num_obj=8, obs_len=4, pred_len=4,
            subsample=2, window_hop=2, num_samples=3, d_dim=16,
            latent_size=8, embedding_size=8, channel_multiplier=10,
            scene_grid=8, scene_channels=4, num_refine=2,
            compute_dtype="float32", scene_image_channels=1, seed=0,
            eval_hop=8)
_FLAGS = [a for k, v in _TOY.items() for a in (f"--{k}", str(v))]
# horizons in seconds: 30 fps / subsample 2 = 15 steps a second, 4 steps
_EVAL = ["--calibration", "1", "--calib_fit_batches", "1",
         "--calib_two_param", "0", "--horizons",
         "0.1,0.2", "--per_scene", "1", "--speed_bins", "1,3",
         "--rank_blend", "0.3", "--z_temp_fast", "1.5"]


def _video(path, seed, frames=90):
    """One video of agents on straight lines (tests/test_train.py)."""
    rng = np.random.RandomState(seed)
    recs = []
    for aid in range(1, 7):
        v, p0 = rng.uniform(-1.5, 1.5, 2), rng.uniform(20, 80, 2)
        recs += [(f, aid, *(p0 + v * f)) for f in range(frames)]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for row in np.asarray(recs, np.float64).T:
            f.write(",".join(f"{x:g}" for x in row) + "\n")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A toy tree (one scene of two videos; holdout='video' holds the
    second out) and a run of `python -m desire_tpu_torch.train --device
    cpu` on it: one epoch of two batches, the held-out eval, best/."""
    root = tmp_path_factory.mktemp("entry_cli")
    csvs = [str(root / f"data/scene/video{i}/annotations_processed.csv")
            for i in range(2)]
    for i, path in enumerate(csvs):
        _video(path, i)
    save = str(root / "run")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DESIRE_TORCH_CACHE_DIR", str(root / "cache"))
        assert run.main(["--device", "cpu", "--data_dir", str(root / "data"),
                         "--save_dir", save, "--num_epochs", "1",
                         "--max_train_batches", "2", "--max_eval_batches",
                         "1", "--final_select_top", "0"] + _FLAGS) == 0
    assert os.path.isdir(os.path.join(save, "best"))
    return {"data": str(root / "data"), "save": save, "csvs": csvs,
            "cache": str(root / "cache")}


@pytest.fixture
def caches(trained, tmp_path, monkeypatch):
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", trained["cache"])
    monkeypatch.setenv("DESIRE_CACHE_DIR", str(tmp_path / "jax_cache"))


def _lines(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def _structure(x):
    """The keys of nested dicts and the lengths of lists."""
    if isinstance(x, dict):
        return {k: _structure(v) for k, v in x.items()}
    if isinstance(x, list):
        return [len(x)]
    return None


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    return bool(np.isfinite(x))


def _fast_jax_init(key, cfg):
    """The port's init, converted: the JAX init runs op by op, ~10 s on the
    CPU at the toy size."""
    tree = to_numpy(init_desire(cfg, torch.Generator().manual_seed(0),
                                "cpu"))
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_evaluate_random_params_has_the_jax_keys(trained, caches, capsys,
                                                  tmp_path, monkeypatch):
    """--random_params with every breakdown on: the result line has the
    JAX evaluate.main's keys, nested, and finite values."""
    argv = (["--data_dir", trained["data"], "--random_params", "1",
             "--dump", str(tmp_path / "t.npz"), "--dump_batches", "1"]
            + _FLAGS + _EVAL)
    got = evaluate.main(argv + ["--device", "cpu"])
    port_lines = _lines(capsys)
    sys.path.insert(0, ROOT)
    prev = (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        import evaluate as jax_evaluate
        monkeypatch.setattr(jax_evaluate, "init_desire", _fast_jax_init)
        ref = jax_evaluate.main([a.replace("t.npz", "j.npz") for a in argv])
    finally:
        # the JAX script points the compile cache at $DESIRE_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", prev[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          prev[1])
        sys.path.remove(ROOT)
    jax_lines = _lines(capsys)
    assert _structure(got) == _structure(ref)
    assert {"calibration", "horizons", "per_scene", "speed_classes",
            "rank_blend", "z_temp"} <= set(got)
    assert "sigma_fit" in got["calibration"]
    assert _finite(got)
    # the header and dump lines, and the result line last, as in JAX's
    assert [set(x) for x in port_lines] == [set(x) for x in jax_lines]
    assert port_lines[0] == jax_lines[0]
    assert port_lines[-1] == json.loads(json.dumps(got, sort_keys=True))
    t, j = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert list(t.files) == list(j.files)
    assert all(t[k].shape == j[k].shape for k in j.files)


def test_evaluate_from_the_checkpoint(trained, caches, capsys, tmp_path):
    """best/ with the geometry from its config (the raster included), a
    dump and the calibration fit on the train split."""
    dump = str(tmp_path / "dump.npz")
    got = evaluate.main(["--device", "cpu", "--save_dir", trained["save"],
                         "--data_dir", trained["data"], "--best", "1",
                         "--batch_size", "4", "--eval_hop", "8",
                         "--num_samples", "3",
                         "--calibration", "1", "--calib_fit_batches", "1",
                         "--horizons", "0.1,0.2", "--dump", dump])
    lines = _lines(capsys)
    assert lines[0]["split"] == "heldout"
    assert lines[0]["videos"] == ["scene/video1"]
    assert lines[0]["window_hop"] == 8
    assert lines[1] == {"dumped": dump, "windows": lines[0]["windows"]}
    assert lines[-1]["K"] == _TOY["num_samples"] and _finite(got)
    assert got["num_agents"] > 0
    assert set(got["calibration"]) >= {"sigma_temp", "coverage_50_cal",
                                       "sigma_fit"}
    z = np.load(dump)
    n, a, k = lines[0]["windows"], _TOY["max_num_obj"], _TOY["num_samples"]
    tf = _TOY["pred_len"]
    assert z["traj"].shape == (n, a, k, tf, 2) and z["traj"].dtype == \
        np.float32
    assert z["scores"].shape == (n, a, k) and z["best"].shape == (n, a, tf,
                                                                  2)


def test_visualize_renders_the_ports_dump(trained, caches, capsys, tmp_path):
    """The repository's visualize.py (it imports neither JAX nor
    desire_tpu) on the dump of ``python -m desire_tpu_torch.evaluate
    --dump``: the dump holds every key it reads, and it writes one figure
    for each window asked for, here all of them."""
    pytest.importorskip("matplotlib")
    dump = str(tmp_path / "dump.npz")
    evaluate.main(["--device", "cpu", "--save_dir", trained["save"],
                   "--data_dir", trained["data"], "--batch_size", "4",
                   "--eval_hop", "8", "--num_samples", "3", "--dump", dump])
    n = _lines(capsys)[0]["windows"]
    z = np.load(dump)
    assert {"obs_xy", "obs_mask", "fut_xy", "fut_mask", "traj", "scores",
            "best", "live", "video", "scale"} <= set(z.files)
    out = str(tmp_path / "figs")
    env = dict(os.environ, MPLBACKEND="Agg")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "visualize.py"),
                        dump, "--out", out, "--windows", str(n), "--dpi",
                        "40"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert len(pngs) == n > 0
    assert r.stdout.split() == [os.path.join(out, f) for f in pngs]


def test_predict_stream_mode(trained, capsys, monkeypatch):
    """tests/test_serve.py::test_predict_cli_stream_mode, mirrored."""
    sub, to = _TOY["subsample"], _TOY["obs_len"]
    lines = [json.dumps({"frame": f,
                         "agents": [[2, 30 + 1.1 * f, 40 - 0.4 * f],
                                    [6, 70 - 0.8 * f, 25 + 0.9 * f]]})
             for f in range(0, (to + 1) * sub)]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    predict.main(["--device", "cpu", "--save_dir", trained["save"],
                  "--stream", "--scale", "120", "--top_k", "1"])
    cap = capsys.readouterr()
    out = [json.loads(line) for line in cap.out.splitlines()]
    assert out[0]["ready"] and out[0]["subsample"] == sub
    forecasts = [r for r in out if "agents" in r]
    assert len(forecasts) == 2           # steps to - 1 and to
    assert {a["id"] for a in forecasts[0]["agents"]} == {2, 6}
    assert len(forecasts[0]["agents"][0]["top1"]) == _TOY["pred_len"]
    assert json.loads(cap.err.strip().splitlines()[-1])["calls"] == 2


def test_predict_file_mode(trained, capsys):
    """tests/test_serve.py::test_predict_cli_file_mode, mirrored, over both
    videos of the tree, each with its occupancy raster."""
    predict.main(["--device", "cpu", "--save_dir", trained["save"],
                  "--best", "1", "--csv", *trained["csvs"], "--top_k", "2"])
    recs = _lines(capsys)
    assert [r["video"] for r in recs] == trained["csvs"]
    for rec in recs:
        assert rec["agents"] and len(rec["agents"][0]["hypotheses"]) == 2
        # forecasts in raw pixels on the video's extent
        assert np.abs(np.asarray(rec["agents"][0]["top1"])).max() > 2.0


def test_bench_serve_prints_the_jax_scripts_keys():
    """python -m desire_tpu_torch.bench_serve, tiny, on the CPU: one JSON
    line with scripts/bench_serve.py's keys."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-m", "desire_tpu_torch.bench_serve", "--device",
         "cpu", "--random_params", "1", "--max_windows", "2", "--iters",
         "2", "--agents", "5", "--num_samples", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(rec) == {"calls", "latency_ms_p50", "latency_ms_p95",
                        "latency_ms_mean", "windows_per_sec", "metric",
                        "unit", "windows_per_dispatch", "agents", "k",
                        "agent_forecasts_per_sec"}
    assert rec["metric"] == "serve_latency" and rec["calls"] == 2
    assert rec["agents"] == 5 and rec["k"] == 3


def test_entry_points_without_a_card_raise(trained, caches, monkeypatch):
    """The default device is the card: without one each entry point raises
    and never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--data_dir", trained["data"], "--random_params",
                       "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        predict.main(["--save_dir", trained["save"], "--csv",
                      trained["csvs"][0]])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_serve.main(["--random_params", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
