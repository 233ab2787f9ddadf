"""Checkpoints with bit-identical resume (PyTorch port of
``desire_tpu/train/checkpoint.py``).

A checkpoint directory holds one subdirectory a step, ``<step>/state.pt``
(``torch.save``; with ``metrics.json`` where a metric was given), and
``config.json``, the run's configuration. The payload is the whole
training state: params, Adam's ``mu`` and ``nu``, ``count`` and ``step``,
the training generator's state, and the loader's epoch and batch. A
step's directory is written under a temporary name and renamed into
place, so a crash never leaves a half-written checkpoint.

Retention keeps the ``keep`` newest checkpoints or, with
``keep_best_metric``, the ``keep`` best by that (minimised) metric. As in
the JAX package, a save of a step no newer than the latest is skipped.
Saves are synchronous, so ``wait`` returns at once. In a multi-process
run only rank 0 writes (the ranks' training states are equal); every
rank can restore.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.data.loader import LoaderState
from desire_tpu_torch.parallel.mesh import process_index
from desire_tpu_torch.params import init_desire, to_device
from desire_tpu_torch.train.state import (TrainState, create_train_state,
                                          tree_leaves)

_STATE = "state.pt"
_METRICS = "metrics.json"


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree.detach()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 keep_best_metric: str | None = None):
        """keep_best_metric: retention keeps the ``keep`` best checkpoints
        by this (minimised) metric of ``save(metrics=...)`` rather than the
        ``keep`` newest (the candidate pool of the end-of-training
        selection)."""
        self.directory = os.path.abspath(directory)
        self.keep = int(keep)
        self.keep_best_metric = keep_best_metric
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.exists(os.path.join(self.directory, n,
                                                      _STATE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, loader_state: LoaderState,
             cfg: DesireConfig, metrics: dict | None = None) -> bool:
        """Write the state at ``state.step`` and the config. Returns False
        (and writes nothing) when that step is no newer than the latest, or
        on a rank other than 0."""
        if process_index() != 0:
            return False
        step = int(state.step)
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        payload = {
            "params": _detached(state.params),
            "mu": _detached(state.mu),
            "nu": _detached(state.nu),
            "count": int(state.count),
            "step": step,
            "generator": state.generator.get_state(),
            "generator_device": state.generator.device.type,
            "loader_epoch": int(loader_state.epoch),
            "loader_batch": int(loader_state.batch_index),
        }
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _STATE))
        if metrics is not None:
            with open(os.path.join(tmp, _METRICS), "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f)
        # a step directory without its state (a crash while deleting it)
        shutil.rmtree(self._step_dir(step), ignore_errors=True)
        os.replace(tmp, self._step_dir(step))
        cfg_tmp = os.path.join(self.directory, f".config.json.{os.getpid()}")
        with open(cfg_tmp, "w") as f:
            f.write(cfg.to_json())
        os.replace(cfg_tmp, os.path.join(self.directory, "config.json"))
        self._retain()
        return True

    def _metric(self, step: int) -> float:
        path = os.path.join(self._step_dir(step), _METRICS)
        if not os.path.exists(path):
            return float("inf")
        with open(path) as f:
            return float(json.load(f)[self.keep_best_metric])

    def _retain(self):
        steps = self.all_steps()
        if self.keep_best_metric is None:
            drop = steps[:max(len(steps) - self.keep, 0)]
        else:
            ranked = sorted(steps, key=lambda s: (self._metric(s), -s))
            drop = ranked[self.keep:]
        for s in drop:
            shutil.rmtree(self._step_dir(s))

    def restore(self, template_state: TrainState
                ) -> tuple[TrainState, LoaderState] | None:
        """The latest checkpoint as (state, loader state), or None."""
        return self._restore_at(self.latest_step(), template_state)

    def restore_step(self, step: int, template_state: TrainState
                     ) -> tuple[TrainState, LoaderState] | None:
        return self._restore_at(step, template_state)

    def _restore_at(self, step, template_state):
        if step is None:
            return None
        path = os.path.join(self._step_dir(step), _STATE)
        if not os.path.exists(path):
            return None
        got = torch.load(path, map_location="cpu", weights_only=True)
        dev = tree_leaves(template_state.params)[0].device
        for name in ("params", "mu", "nu"):
            want = [tuple(x.shape) for x in tree_leaves(
                getattr(template_state, name))]
            have = [tuple(x.shape) for x in tree_leaves(got[name])]
            if want != have:
                raise ValueError(f"{path}: {name} do not match the template "
                                 f"state's tree")
        if got["generator_device"] != dev.type:
            raise ValueError(
                f"{path}: a {got['generator_device']} generator's state "
                f"cannot resume on {dev.type}")
        gen = torch.Generator(device=dev)
        gen.set_state(got["generator"])
        state = TrainState(step=int(got["step"]),
                           params=to_device(got["params"], dev),
                           mu=to_device(got["mu"], dev),
                           nu=to_device(got["nu"], dev),
                           count=int(got["count"]), generator=gen)
        return state, LoaderState(epoch=int(got["loader_epoch"]),
                                  batch_index=int(got["loader_batch"]))

    def wait(self):
        """Saves are synchronous; kept for the JAX package's interface."""


def restore_params(directory: str, cfg: DesireConfig, device):
    """The params of the latest checkpoint in ``directory`` on ``device``,
    for a model of ``cfg``'s geometry; FileNotFoundError without one."""
    template = create_train_state(cfg, to_device(init_desire(
        cfg, torch.Generator().manual_seed(cfg.seed), "cpu"), device))
    got = CheckpointManager(directory).restore(template)
    if got is None:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    return got[0].params


def load_config(directory: str) -> DesireConfig | None:
    path = os.path.join(directory, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return DesireConfig.from_json(f.read())


# Model-geometry fields: the config entries that shape the forward pass or
# the parameter tree. Whatever restores a checkpoint (serve.Predictor) takes
# these from the SAVED config, not the caller's defaults: input_norm changes
# the embed width, vel_scale / speed_norm rescale every residual,
# social_freeze changes inference.
GEOMETRY_FIELDS = (
    "d_dim", "latent_size", "embedding_size", "rnn_size", "num_layers",
    "channel_multiplier", "scene_grid", "scene_channels", "use_ioc",
    "use_scf", "use_social", "num_refine", "vel_scale", "speed_norm",
    "vel_gain", "vel_floor", "cond_prior", "learn_bound", "aniso_bound",
    "vae_dec", "input_norm", "pace_range", "pace_lanes", "social_freeze",
    "scene_image_channels", "scene_image_source", "z_temp_learn",
    "rank_blend_fit",
    "obs_len", "pred_len", "subsample", "max_num_obj", "protocol")


def overlay_geometry(cfg: DesireConfig, saved_cfg: DesireConfig,
                     skip: tuple | frozenset = ()) -> DesireConfig:
    """The saved checkpoint's geometry over cfg, but for the fields in
    ``skip`` (those the caller set explicitly)."""
    return cfg.replace(**{f: getattr(saved_cfg, f) for f in GEOMETRY_FIELDS
                          if f not in skip})
