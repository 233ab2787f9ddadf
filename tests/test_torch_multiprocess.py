"""Training on a mesh through the port's entry point on the CPU: two
processes of ``python -m desire_tpu_torch.train --device cpu --mesh_data 2
--coordinator localhost:PORT --num_processes 2 --process_id r`` (gloo;
data-parallel) and two of ``--mesh_data 1 --mesh_k 2`` (lane-parallel)
train 3 batches of a toy tree, evaluate on its held-out video and
checkpoint; they are held against the single-process entry point on the
same flags, and a run resumed in two processes from rank 0's checkpoint
against the uninterrupted one, bit for bit.

The entry point draws its params and noise from the port's own seeded
generators, so its losses are held against the port's single-process run;
tests/test_torch_parallel.py holds the data-parallel epoch against JAX's
with JAX's draws pinned.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.params import init_desire
from desire_tpu_torch.train import checkpoint as ckpt
from desire_tpu_torch.train import run
from desire_tpu_torch.train.state import create_train_state, tree_leaves
from test_torch_parallel import _PG_TIMEOUT, _free_port, spawn

_TOY = dict(batch_size=4, max_num_obj=6, obs_len=4, pred_len=4,
            subsample=2, window_hop=2, num_samples=3, d_dim=16,
            latent_size=8, embedding_size=8, channel_multiplier=10,
            scene_grid=8, scene_channels=4, num_refine=2,
            compute_dtype="float32", learning_rate=3e-3, kld_warmup=0,
            seed=0, save_every=4, num_epochs=1, holdout="video",
            eval_hop=8)
_STEPS = 3


def _video(path, seed, frames):
    rng = np.random.RandomState(seed)
    recs = []
    for aid in range(1, 6):
        v, p0 = rng.uniform(-1.5, 1.5, 2), rng.uniform(20, 80, 2)
        recs += [(f, aid, *(p0 + v * f)) for f in range(frames)]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for row in np.asarray(recs, np.float64).T:
            f.write(",".join(f"{x:g}" for x in row) + "\n")


def _argv(data_dir, save_dir, **extra):
    flags = dict(_TOY, data_dir=data_dir, save_dir=save_dir, device="cpu",
                 log_every=1, eval_every=1, max_eval_batches=1,
                 final_select_top=0, **extra)
    return [a for k, v in flags.items() for a in (f"--{k}", str(v))]


def _mesh_argv(port, rank, data_dir, save_dir, **extra):
    extra.setdefault("mesh_data", 2)
    return _argv(data_dir, save_dir, coordinator=f"localhost:{port}",
                 num_processes=2, process_id=rank, dist_timeout=_PG_TIMEOUT,
                 **extra)


def _events(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _payload(save_dir, step):
    return torch.load(os.path.join(save_dir, str(step), "state.pt"),
                      weights_only=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """S: the single-process entry point (in this process); M: the same
    flags in two processes, rank 1 with a save_dir of its own; R: M's run
    stopped after its step-2 checkpoint and resumed in two processes by
    ``python -m desire_tpu_torch.train --resume 1``."""
    tmp = tmp_path_factory.mktemp("dp")
    data = str(tmp / "data")
    for i in range(2):
        # 14 training windows (3 batches), 4 held out
        _video(os.path.join(data, f"scene/video{i}/annotations_processed"
                                  ".csv"), i, frames=70)
    env = dict(os.environ, DESIRE_TORCH_CACHE_DIR=str(tmp / "cache"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DESIRE_TORCH_CACHE_DIR", env["DESIRE_TORCH_CACHE_DIR"])
        single = run.train(_cfg(data, str(tmp / "S")), eval_every=1,
                           max_eval_batches=1, final_select_top=0,
                           device="cpu", log_every=1)
    save = [str(tmp / "M"), str(tmp / "M_rank1")]
    port = _free_port()
    spawn(__file__, lambda r: [str(tmp / f"M_params{r}.npz"), "--",
                               *_mesh_argv(port, r, data, save[r])], 2,
          env=env)
    resumed = str(tmp / "R")
    shutil.copytree(save[0], resumed)
    shutil.rmtree(os.path.join(resumed, str(_STEPS)))
    port = _free_port()
    spawn("-m", lambda r: ["desire_tpu_torch.train", *_mesh_argv(
        port, r, data, resumed, resume=1)], 2, env=env)
    return dict(single=single, single_dir=str(tmp / "S"), save=save,
                resumed=resumed,
                ranks=[np.load(tmp / f"M_params{r}.npz")["params"]
                       for r in range(2)])


def _cfg(data, save_dir, **kw):
    return DesireConfig(**dict(_TOY, data_dir=data, save_dir=save_dir, **kw))


# lane-parallel: K = 4 lanes, two a rank
_LANES = dict(mesh_data=1, mesh_k=2, num_samples=4)


@pytest.fixture(scope="module")
def lane_runs(tmp_path_factory):
    """As ``runs``, with --mesh_data 1 --mesh_k 2 and 4 lanes: S the single
    process on the same 4 lanes, M two processes, R M's run resumed after
    its step-2 checkpoint in two processes."""
    tmp = tmp_path_factory.mktemp("lanes")
    data = str(tmp / "data")
    for i in range(2):
        _video(os.path.join(data, f"scene/video{i}/annotations_processed"
                                  ".csv"), i, frames=70)
    env = dict(os.environ, DESIRE_TORCH_CACHE_DIR=str(tmp / "cache"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DESIRE_TORCH_CACHE_DIR", env["DESIRE_TORCH_CACHE_DIR"])
        single = run.train(_cfg(data, str(tmp / "S"), num_samples=4),
                           eval_every=1, max_eval_batches=1,
                           final_select_top=0, device="cpu", log_every=1)
    save = [str(tmp / "M"), str(tmp / "M_rank1")]
    port = _free_port()
    spawn(__file__, lambda r: [str(tmp / f"M_params{r}.npz"), "--",
                               *_mesh_argv(port, r, data, save[r],
                                           **_LANES)], 2, env=env)
    resumed = str(tmp / "R")
    shutil.copytree(save[0], resumed)
    shutil.rmtree(os.path.join(resumed, str(_STEPS)))
    port = _free_port()
    spawn("-m", lambda r: ["desire_tpu_torch.train", *_mesh_argv(
        port, r, data, resumed, resume=1, **_LANES)], 2, env=env)
    return dict(single=single, single_dir=str(tmp / "S"), save=save,
                resumed=resumed,
                ranks=[np.load(tmp / f"M_params{r}.npz")["params"]
                       for r in range(2)])


def test_two_ranks_train_as_one_process(runs):
    """Rank 0 logs 3 steps whose losses and gradient norms are the
    single-process run's (rtol 1e-5: the loss summed over two halves of
    each batch), and an evaluation on the held-out video."""
    ev = _events(runs["save"][0])
    ref = _events(runs["single_dir"])
    train = [e for e in ev if e["event"] == "train"]
    want = [e for e in ref if e["event"] == "train"]
    assert len(train) == len(want) == _STEPS
    for key in ("loss", "grad_norm", "nll", "kld", "ioc_ce"):
        np.testing.assert_allclose([e[key] for e in train],
                                   [e[key] for e in want], rtol=1e-5,
                                   err_msg=key)
    evals = [e for e in ev if e["event"] == "eval"]
    assert len(evals) == 1 and evals[0]["held_out"]
    np.testing.assert_allclose(
        evals[0]["minADE_px"],
        [e for e in ref if e["event"] == "eval"][0]["minADE_px"], rtol=1e-4)


def test_ranks_hold_the_same_params(runs):
    """Both ranks end with the same params, bit for bit, and with the
    single-process run's up to float32 noise: an element whose gradient is
    within noise of 0 may take Adam's lr-sized step the other way, by at
    most 2 lr a step, and only a few do (chip_smoke.py's card-vs-CPU
    rule)."""
    np.testing.assert_array_equal(runs["ranks"][0], runs["ranks"][1])
    ref = np.concatenate([x.numpy().ravel() for x in
                          tree_leaves(runs["single"].params)])
    diff = np.abs(runs["ranks"][0] - ref)
    lr = _TOY["learning_rate"]
    assert diff.max() <= 2 * lr * _STEPS + 1e-5
    assert (diff > 1e-4).mean() <= 1e-3


def test_only_rank0_writes(runs):
    """Rank 1, given a save_dir of its own, writes no metrics, checkpoint
    or best/ there; rank 0 writes each event once."""
    rank1 = runs["save"][1]
    assert not os.path.exists(os.path.join(rank1, "metrics.jsonl"))
    assert ckpt.CheckpointManager(rank1).latest_step() is None
    assert not os.path.exists(os.path.join(rank1, "best"))
    ev = _events(runs["save"][0])
    assert [e["event"] for e in ev].count("epoch") == 1
    assert ckpt.CheckpointManager(runs["save"][0]).all_steps() == [2, 3]
    best = ckpt.CheckpointManager(os.path.join(runs["save"][0], "best"))
    assert best.latest_step() == _STEPS


def test_meshed_runs_checkpoint_serves_unsharded(runs):
    """Predictor.from_checkpoint of the two-rank run, on a config that says
    mesh_data 2 as the run's does, forecasts in this process with no
    process group: the mesh is explicit, never read from the config."""
    from desire_tpu_torch.serve import Predictor
    assert ckpt.load_config(runs["save"][0]).mesh_data == 2
    pred = Predictor.from_checkpoint(runs["save"][0], best=True,
                                     device="cpu", max_windows=2,
                                     cfg=DesireConfig(mesh_data=2))
    assert pred.mesh is None and pred.cfg.mesh_data == 2
    t = np.arange(_TOY["obs_len"], dtype=np.float32)
    obs = np.stack([20.0 + 2.0 * t, 30.0 + t], -1)[None].repeat(3, 0)
    out = pred.predict(obs, np.ones((3, _TOY["obs_len"]), np.float32),
                       np.arange(1, 4), scale=100.0)
    assert out["traj"].shape == (3, pred.k, _TOY["pred_len"], 2)
    assert np.isfinite(out["traj"]).all()


def test_resume_in_two_processes_is_bit_for_bit(runs):
    """Both ranks restore rank 0's step-2 checkpoint and take step 3: its
    checkpoint equals the uninterrupted run's, params, Adam's moments, the
    generator and the loader's position alike."""
    ev = _events(runs["resumed"])
    res = [e for e in ev if e["event"] == "resume"]
    assert len(res) == 1 and (res[0]["step"], res[0]["batch"]) == (2, 2)
    got = _payload(runs["resumed"], _STEPS)
    want = _payload(runs["save"][0], _STEPS)
    assert got.keys() == want.keys()
    for key in ("params", "mu", "nu"):
        for a, b in zip(tree_leaves(got[key]), tree_leaves(want[key])):
            assert torch.equal(a, b), key
    assert torch.equal(got["generator"], want["generator"])
    for key in ("count", "step", "loader_epoch", "loader_batch"):
        assert got[key] == want[key], key
    tmpl = create_train_state(_cfg("", ""), init_desire(
        _cfg("", ""), torch.Generator().manual_seed(0), "cpu"))
    assert ckpt.CheckpointManager(runs["resumed"]).restore(tmpl)[0].step \
        == _STEPS


def test_lane_ranks_train_as_one_process(lane_runs):
    """--mesh_k 2: rank 0 logs 3 steps whose losses, gradient norms and
    metrics are the single-process run's (rtol 1e-5: each rank refines 2
    of the 4 lanes, the gradients averaged over the two), and the
    held-out evaluation."""
    ev = _events(lane_runs["save"][0])
    ref = _events(lane_runs["single_dir"])
    train = [e for e in ev if e["event"] == "train"]
    want = [e for e in ref if e["event"] == "train"]
    assert len(train) == len(want) == _STEPS
    for key in ("loss", "grad_norm", "nll", "kld", "ioc_ce", "refine_reg"):
        np.testing.assert_allclose([e[key] for e in train],
                                   [e[key] for e in want], rtol=1e-5,
                                   err_msg=key)
    evals = [e for e in ev if e["event"] == "eval"]
    assert len(evals) == 1
    np.testing.assert_allclose(
        evals[0]["minADE_px"],
        [e for e in ref if e["event"] == "eval"][0]["minADE_px"], rtol=1e-4)


def test_lane_ranks_hold_the_same_params(lane_runs):
    """Both lane ranks end with the same params, bit for bit, and with the
    single-process run's up to Adam's sign flips of noise-level
    gradients (test_ranks_hold_the_same_params's rule)."""
    np.testing.assert_array_equal(lane_runs["ranks"][0],
                                  lane_runs["ranks"][1])
    ref = np.concatenate([x.numpy().ravel() for x in
                          tree_leaves(lane_runs["single"].params)])
    diff = np.abs(lane_runs["ranks"][0] - ref)
    assert diff.max() <= 2 * _TOY["learning_rate"] * _STEPS + 1e-5
    assert (diff > 1e-4).mean() <= 1e-3


def test_lane_rank1_writes_nothing(lane_runs):
    """Lane rank 1 writes no metrics, checkpoint or best/; rank 0 its
    checkpoints and best/."""
    rank1 = lane_runs["save"][1]
    assert not os.path.exists(os.path.join(rank1, "metrics.jsonl"))
    assert ckpt.CheckpointManager(rank1).latest_step() is None
    assert not os.path.exists(os.path.join(rank1, "best"))
    assert ckpt.CheckpointManager(lane_runs["save"][0]).all_steps() == [2, 3]
    assert ckpt.load_config(lane_runs["save"][0]).mesh_k == 2


def test_lane_resume_in_two_processes_is_bit_for_bit(lane_runs):
    """The --mesh_k 2 run resumed from rank 0's step-2 checkpoint: its
    step-3 checkpoint equals the uninterrupted run's bit for bit."""
    res = [e for e in _events(lane_runs["resumed"]) if e["event"] ==
           "resume"]
    assert len(res) == 1 and (res[0]["step"], res[0]["batch"]) == (2, 2)
    got = _payload(lane_runs["resumed"], _STEPS)
    want = _payload(lane_runs["save"][0], _STEPS)
    for key in ("params", "mu", "nu"):
        for a, b in zip(tree_leaves(got[key]), tree_leaves(want[key])):
            assert torch.equal(a, b), key
    assert torch.equal(got["generator"], want["generator"])
    for key in ("count", "step", "loader_epoch", "loader_batch"):
        assert got[key] == want[key], key


if __name__ == "__main__":
    # a rank of the two-process run: the entry point's main() on the flags
    # after "--", then this rank's final params into the file first named
    states = []
    train = run.train
    run.train = lambda *a, **kw: states.append(train(*a, **kw))
    run.main(sys.argv[3:])
    np.savez(sys.argv[1], params=np.concatenate(
        [x.numpy().ravel() for x in tree_leaves(states[0].params)]))
