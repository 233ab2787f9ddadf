"""The port's training entry point (``python -m desire_tpu_torch.train``,
desire_tpu_torch/train/run.py) on the CPU over a toy tree: a run through
the command line, the end-of-training best selection, recovery from
non-finite losses, the refusal to train over another run's checkpoints,
and no fallback from the card to the CPU."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.data.loader import SDDLoader
from desire_tpu_torch.train import checkpoint as ckpt
from desire_tpu_torch.train import run
from desire_tpu_torch.train.state import create_train_state, tree_leaves
from desire_tpu_torch.params import init_desire

_TOY = dict(batch_size=4, max_num_obj=8, obs_len=4, pred_len=4,
            subsample=2, window_hop=2, num_samples=3, d_dim=16,
            latent_size=8, embedding_size=8, channel_multiplier=10,
            scene_grid=8, scene_channels=4, num_refine=2,
            compute_dtype="float32", learning_rate=3e-3, kld_warmup=50,
            seed=0, save_every=10_000)


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


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """One scene of two videos: holdout='video' holds the second out."""
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    root = tmp_path / "data"
    for i in range(2):
        _video(str(root / f"scene/video{i}/annotations_processed.csv"), i)
    return str(root)


def _cfg(tree, tmp_path, **kw):
    return DesireConfig(**dict(_TOY, data_dir=tree,
                               save_dir=str(tmp_path / "ckpt"), **kw))


def _events(cfg):
    with open(os.path.join(cfg.save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_command_line_trains_on_the_cpu(tree, tmp_path):
    """python -m desire_tpu_torch.train --device cpu: trains, evaluates on
    the held-out video, checkpoints, keeps best/ and resumes."""
    save = str(tmp_path / "cli")
    argv = ["--device", "cpu", "--data_dir", tree, "--save_dir", save,
            "--num_epochs", "2", "--max_train_batches", "2",
            "--max_eval_batches", "1", "--final_select_top", "0",
            "--eval_hop", "8"] + [
        a for k, v in _TOY.items() if k not in ("save_every",)
        for a in (f"--{k}", str(v))]
    assert run.main(argv) == 0
    ev = [json.loads(line) for line in open(os.path.join(save,
                                                         "metrics.jsonl"))]
    kinds = [e["event"] for e in ev]
    assert kinds.count("epoch") == 2 and kinds.count("eval") == 2
    data = ev[kinds.index("data")]
    assert data["split"] == "train" and data["videos"] == 1
    assert ev[kinds.index("eval_data")]["videos"] == ["scene/video1"]
    assert all(np.isfinite(e["minADE_px"]) for e in ev
               if e["event"] == "eval")
    assert ckpt.CheckpointManager(save).latest_step() == 4
    assert ckpt.CheckpointManager(os.path.join(save, "best")).latest_step()
    # resumed with a third epoch: epoch 1 goes on from the loader's saved
    # position (the 2 of its 4 batches that max_train_batches left), then
    # epoch 2 takes 2 batches
    assert run.main(argv[:6] + ["--num_epochs", "3", "--resume", "1"]
                    + argv[8:]) == 0
    ev = [json.loads(line) for line in open(os.path.join(save,
                                                         "metrics.jsonl"))]
    res = [e for e in ev if e["event"] == "resume"]
    assert res and (res[0]["step"], res[0]["epoch"], res[0]["batch"]) \
        == (4, 1, 2)
    assert ckpt.CheckpointManager(save).latest_step() == 8


def test_final_best_selection_full_split(tree, tmp_path):
    """--final_select_top (tests/test_train.py): a pool of the best 2
    epochs by the subset eval, re-evaluated on the whole held-out split;
    best/ holds the winner, with the rank blend fitted on a train slice."""
    cfg = _cfg(tree, tmp_path, num_epochs=3, holdout="video")
    run.train(cfg, eval_every=1, max_eval_batches=1, final_select_top=2,
              device="cpu")
    events = _events(cfg)
    cands = [e for e in events if e["event"] == "final_select_candidate"]
    final = [e for e in events if e["event"] == "final_select"]
    assert len(cands) == 2 and len(final) == 1
    assert all(np.isfinite(c["minADE_px"]) for c in cands)
    winner = min(cands, key=lambda c: c["minADE_px"])
    assert final[0]["step"] == winner["step"]
    best = ckpt.CheckpointManager(os.path.join(cfg.save_dir, "best"))
    tmpl = create_train_state(cfg, init_desire(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    got = best.restore(tmpl)
    assert got is not None and got[0].step == winner["step"]
    fit = [e for e in events if e["event"] == "rank_blend_fit"]
    assert len(fit) == 1 and "error" not in fit[0], fit
    best_cfg = ckpt.load_config(os.path.join(cfg.save_dir, "best"))
    assert best_cfg.rank_blend_fit == fit[0]["blend"] >= 0.0
    assert fit[0]["blends"][int(np.argmin(fit[0]["top1ADE_px"]))] \
        == fit[0]["blend"]


class _TransientFaultLoader:
    """A loader whose batches of one epoch are NaN, once."""

    def __init__(self, inner, poison_epoch):
        self._inner = inner
        self._poison_epoch = poison_epoch
        self._armed = True

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def epoch_batches(self, epoch, start_batch=0):
        for b in self._inner.epoch_batches(epoch, start_batch):
            if self._armed and epoch == self._poison_epoch:
                b.xy = np.full_like(b.xy, np.nan)
            yield b
        if epoch == self._poison_epoch:
            self._armed = False


def test_nonfinite_loss_recovers_from_the_last_checkpoint(tree, tmp_path,
                                                          monkeypatch):
    """A transient NaN epoch is detected, never checkpointed, and healed
    by rolling back to the last good checkpoint (tests/test_train.py)."""
    cfg = _cfg(tree, tmp_path, num_epochs=3, holdout="none")
    faulty = _TransientFaultLoader(SDDLoader(cfg), poison_epoch=1)
    monkeypatch.setattr(run, "SDDLoader", lambda c, **kw: faulty)
    run.train(cfg, eval_every=0, max_recoveries=2, device="cpu")
    events = _events(cfg)
    recov = [e for e in events if e["event"] == "recover"]
    assert len(recov) == 1 and "non-finite" in recov[0]["error"]
    epochs = [e for e in events if e["event"] == "epoch"]
    assert sorted(e["epoch"] for e in epochs) == [0, 1, 2]
    assert all(np.isfinite(e["mean_loss"]) for e in epochs)
    tmpl = create_train_state(cfg, init_desire(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    got = ckpt.CheckpointManager(cfg.save_dir).restore(tmpl)
    assert all(torch.isfinite(x).all() for x in tree_leaves(got[0].params))


def test_profile_dir_writes_a_chrome_trace(tree, tmp_path):
    """--profile_dir: a torch.profiler trace of the first batches, which
    count as training steps."""
    cfg = _cfg(tree, tmp_path, num_epochs=1, holdout="none")
    st = run.train(cfg, eval_every=0, max_train_batches=3, device="cpu",
                   profile_dir=str(tmp_path / "prof"))
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert st.step == 3 + 3
    assert any(e["event"] == "profile" for e in _events(cfg))


def test_refuses_another_runs_checkpoints(tree, tmp_path):
    cfg = _cfg(tree, tmp_path, num_epochs=1, holdout="none")
    run.train(cfg, eval_every=0, max_train_batches=1, device="cpu")
    with pytest.raises(SystemExit):
        run.train(cfg.replace(d_dim=8), eval_every=0, max_train_batches=1,
                  device="cpu")
    # the same config trains on; another one into a fresh directory too
    run.train(cfg, eval_every=0, max_train_batches=1, device="cpu")
    shutil.rmtree(cfg.save_dir)
    run.train(cfg.replace(d_dim=8), eval_every=0, max_train_batches=1,
              device="cpu")


def test_cuda_device_without_a_card_raises(tree, tmp_path, monkeypatch):
    """The default device is the card; without one training raises and
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run.train(_cfg(tree, tmp_path, holdout="none"))
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["--data_dir", tree, "--save_dir", ""])
