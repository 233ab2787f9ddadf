"""The port's checkpoints (desire_tpu_torch/train/checkpoint.py) on the
CPU: the save/restore round trip, retention by age and by metric, the
saved config and its geometry overlay, resume bit for bit, and
``serve.Predictor.from_checkpoint``."""

import json
import os

import numpy as np
import pytest
import torch

from desire_tpu.config import DesireConfig as JConfig
from desire_tpu.train import checkpoint as jckpt
from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.data.loader import LoaderState, SDDLoader
from desire_tpu_torch.params import init_desire
from desire_tpu_torch.serve import Predictor
from desire_tpu_torch.train import checkpoint as ckpt
from desire_tpu_torch.train import trainer
from desire_tpu_torch.train.state import (TrainState, create_train_state,
                                          tree_leaves)


def _cfg(**kw):
    base = dict(batch_size=3, max_num_obj=4, obs_len=4, pred_len=3,
                subsample=2, window_hop=2, num_samples=3, d_dim=16,
                latent_size=8, embedding_size=8, channel_multiplier=10,
                scene_grid=8, scene_channels=4, num_refine=2,
                compute_dtype="float32", rnn_size=128, save_dir="")
    base.update(kw)
    return DesireConfig(**base)


def _state(cfg, seed=0):
    return create_train_state(cfg, init_desire(
        cfg, torch.Generator().manual_seed(seed), "cpu"))


def _micro_dataset(root, frames=60):
    """One video of agents on straight lines (tests/test_train.py)."""
    rng = np.random.RandomState(0)
    path = os.path.join(str(root), "scene/video0/annotations_processed.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    recs = []
    for aid in range(1, 7):
        v, p0 = rng.uniform(-1.5, 1.5, 2), rng.uniform(20, 80, 2)
        recs += [(f, aid, *(p0 + v * f)) for f in range(frames)]
    with open(path, "w") as f:
        for row in np.asarray(recs, np.float64).T:
            f.write(",".join(f"{x:g}" for x in row) + "\n")
    return str(root)


@pytest.fixture
def loader(tmp_path, monkeypatch):
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    cfg = _cfg(data_dir=_micro_dataset(tmp_path / "data"), holdout="none")
    ld = SDDLoader(cfg, use_native=False)
    assert ld.num_batches >= 4
    return ld


def _assert_same_state(a, b):
    for name in ("params", "mu", "nu"):
        for x, y in zip(tree_leaves(getattr(a, name)),
                        tree_leaves(getattr(b, name))):
            assert torch.equal(x, y), name
    assert (a.step, a.count) == (b.step, b.count)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_save_restore_roundtrip(loader, tmp_path):
    """Params, Adam's moments, count, step, the generator's state and the
    loader's position come back bit for bit into a template of another
    seed; the generator then draws what the saved one would have."""
    cfg = loader.cfg
    step_fn = trainer.make_train_step(cfg, loader.num_batches)
    state, _ = trainer.run_epoch(_state(cfg), loader, 0, step_fn,
                                 max_batches=2)
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(state, loader.state, cfg)
    got, lst = mgr.restore(_state(cfg, seed=42))
    _assert_same_state(got, state)
    assert (lst.epoch, lst.batch_index) == (0, 2)
    assert torch.equal(torch.rand(4, generator=got.generator),
                       torch.rand(4, generator=state.generator))
    assert mgr.restore_step(2, _state(cfg)) is not None
    assert mgr.restore_step(5, _state(cfg)) is None
    # a template of another tree is refused
    with pytest.raises(ValueError):
        mgr.restore(_state(_cfg(d_dim=8)))


def _fake_state(cfg, step):
    st = _state(cfg)
    return TrainState(step=step, params=st.params, mu=st.mu, nu=st.nu,
                      count=step, generator=st.generator)


def test_keep_newest_and_skip_older_steps(tmp_path):
    cfg = _cfg()
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), keep=2)
    assert mgr.latest_step() is None and mgr.restore(_state(cfg)) is None
    for s in (1, 2, 3, 5):
        assert mgr.save(_fake_state(cfg, s), LoaderState(), cfg)
    assert mgr.all_steps() == [3, 5] and mgr.latest_step() == 5
    # a step no newer than the latest is skipped, as the JAX manager does
    assert not mgr.save(_fake_state(cfg, 4), LoaderState(), cfg)
    assert mgr.all_steps() == [3, 5]
    assert not any(n.startswith(".tmp") for n in os.listdir(mgr.directory))


def test_keep_best_by_metric(tmp_path):
    cfg = _cfg()
    mgr = ckpt.CheckpointManager(str(tmp_path / "pool"), keep=2,
                                 keep_best_metric="minADE_px")
    for s, m in ((1, 5.0), (2, 3.0), (3, 4.0), (4, 1.0), (5, 6.0)):
        mgr.save(_fake_state(cfg, s), LoaderState(), cfg,
                 metrics={"minADE_px": m})
    assert mgr.all_steps() == [2, 4]
    with open(os.path.join(mgr.directory, "4", "metrics.json")) as f:
        assert json.load(f) == {"minADE_px": 1.0}


def test_config_and_geometry_overlay_match_jax(tmp_path):
    """config.json round trips; GEOMETRY_FIELDS and overlay_geometry are
    the JAX package's."""
    saved = _cfg(d_dim=8, rank_blend_fit=0.4, num_samples=7)
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(_fake_state(_cfg(d_dim=8), 1), LoaderState(), saved)
    assert ckpt.load_config(str(tmp_path / "ck")) == saved
    assert ckpt.load_config(str(tmp_path / "none")) is None
    assert ckpt.GEOMETRY_FIELDS == jckpt.GEOMETRY_FIELDS
    caller = _cfg(num_refine=0, seed=5)
    for skip in ((), ("num_refine",)):
        got = ckpt.overlay_geometry(caller, saved, skip=skip)
        want = jckpt.overlay_geometry(JConfig.from_json(caller.to_json()),
                                      JConfig.from_json(saved.to_json()),
                                      skip=skip)
        assert got.to_json() == want.to_json()
    assert ckpt.overlay_geometry(caller, saved).d_dim == 8
    assert ckpt.overlay_geometry(caller, saved).seed == 5


def test_resume_is_bit_identical(loader, tmp_path):
    """2 steps, a save, a restore into a fresh template, 2 more steps from
    the loader's saved position: bit for bit the 4 uninterrupted steps
    (tests/test_train.py's resume round trip, held to equal bits)."""
    cfg = loader.cfg
    step_fn = trainer.make_train_step(cfg, loader.num_batches)
    whole, _ = trainer.run_epoch(_state(cfg), loader, 0, step_fn,
                                 max_batches=4)
    part, _ = trainer.run_epoch(_state(cfg), loader, 0, step_fn,
                                max_batches=2)
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(part, loader.state, cfg)
    restored, lst = mgr.restore(_state(cfg, seed=9))
    resumed, _ = trainer.run_epoch(restored, loader, lst.epoch, step_fn,
                                   start_batch=lst.batch_index,
                                   max_batches=2)
    assert resumed.step == 4
    _assert_same_state(resumed, whole)


def test_predictor_from_checkpoint(tmp_path):
    """Predictor.from_checkpoint on the CPU: the saved params and geometry
    (best/ with its fitted blend), forecasts equal to a Predictor given
    the same params."""
    save_dir = str(tmp_path / "run")
    cfg = _cfg(d_dim=8, save_dir=save_dir)
    st = _fake_state(cfg, 3)
    ckpt.CheckpointManager(save_dir).save(st, LoaderState(), cfg)
    best = cfg.replace(rank_blend_fit=0.5)
    ckpt.CheckpointManager(os.path.join(save_dir, "best"), keep=1).save(
        st, LoaderState(), best)
    caller = _cfg(num_samples=3)       # d_dim and the blend come from disk
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(str(tmp_path / "none"), device="cpu")
    p_last = Predictor.from_checkpoint(save_dir, device="cpu", cfg=caller)
    p_best = Predictor.from_checkpoint(save_dir, best=True, device="cpu",
                                       cfg=caller, max_windows=2, seed=1)
    assert p_last.cfg.d_dim == 8 and p_last.cfg.rank_blend_fit == -1.0
    assert p_best.cfg.rank_blend_fit == 0.5
    for x, y in zip(tree_leaves(p_best.params), tree_leaves(st.params)):
        assert torch.equal(x, y)
    ref = Predictor(st.params, p_best.cfg, device="cpu", max_windows=2,
                    seed=1)
    rng = np.random.default_rng(0)
    oxy = rng.uniform(20, 60, (3, cfg.obs_len, 2)).astype(np.float32)
    win = (oxy, np.ones((3, cfg.obs_len), np.float32), np.arange(1, 4))
    got, want = p_best.predict(*win), ref.predict(*win)
    for key in ("traj", "scores", "best"):
        np.testing.assert_array_equal(got[key], want[key])
