"""The reference-shaped facade (PyTorch port of ``desire_tpu/compat.py``).

Lets a user of the reference repository (tdavchev/DESIRE) switch with few
code changes: the class name, the constructor's contract (an argparse-style
``args`` namespace with the reference's flag names) and the ``sample()``
signature and layout (numpy arrays of shape (T, max_num_obj, 3), column 0
the agent id) are the reference's, while the port's training step and
rollout run underneath, through the CUDA kernels on a card.

As in the JAX package's facade:

* the constructor makes a trainable model; ``train_step(x_batch,
  y_batch)`` takes one optimizer step and returns the loss (the
  reference's ``cost`` has no counterpart and raises);
* ``sample`` runs the rollout for all agents and all K hypotheses at once
  and needs no session (pass None).

Randomness comes from explicit generators: the params are drawn from
``seed`` on the CPU, the training draws from the train state's generator
(cfg.seed) and the sampling draws from a generator seeded ``seed + 1`` on
the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.eval.sampler import make_rollout
from desire_tpu_torch.models.desire import init_desire
from desire_tpu_torch.params import require_device, to_device
from desire_tpu_torch.train import trainer
from desire_tpu_torch.train.state import create_train_state


def _cfg_from_args(args) -> DesireConfig:
    """The config of the args' known flags. Without a protocol the
    reference's semantics hold: seq_length windows at the native rate,
    observed whole (protocol 'compat', obs = pred = seq_length, no
    normalisation)."""
    known = {f.name for f in DesireConfig.__dataclass_fields__.values()}
    kw = {k: v for k, v in vars(args).items() if k in known}
    cfg = DesireConfig(**kw)
    if "protocol" not in kw:
        cfg = cfg.replace(protocol="compat", obs_len=cfg.seq_length,
                          pred_len=cfg.seq_length, normalize=False)
    return cfg


class DESIREModel:
    """Counterpart of the reference's ``model.DESIREModel``.

    args: the reference's flags (an argparse namespace). seed: the params'
    draw (seed) and the sampling generator's (seed + 1). device: "cuda"
    (the default; raises without a CUDA device) or "cpu"."""

    def __init__(self, args, seed: int = 0, device="cuda"):
        self.args = args
        self.cfg = _cfg_from_args(args)
        self.device = require_device(device)
        self.params = to_device(
            init_desire(self.cfg, torch.Generator().manual_seed(seed),
                        "cpu"), self.device)
        self._state = create_train_state(self.cfg, self.params)
        self._step_fn = trainer.make_train_step(self.cfg, 100)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 1)
        self._samplers = {}     # obs window -> rollout
        # The model's physical priors (velocity bounds, the IOC's delta
        # scale, the scene grid) are calibrated to [0, 1] scene units: the
        # scale locks to a power of two covering the first batch seen, and
        # every output is returned in input units.
        self._scale = None

    def _lock_scale(self, coords: np.ndarray) -> float:
        if self._scale is None:
            hi = float(np.max(coords)) if coords.size else 1.0
            self._scale = float(2.0 ** np.ceil(np.log2(max(hi, 1.0))))
        return self._scale

    # -- training -------------------------------------------------------------
    def train_step(self, x_batch: np.ndarray, y_batch: np.ndarray) -> float:
        """One optimizer step on a reference-layout sequence pair.

        x_batch, y_batch: (seq_length, max_num_obj, 3), column 0 the id;
        y is x shifted by one frame. Returns the batch loss."""
        x = np.asarray(x_batch, np.float32)
        y = np.asarray(y_batch, np.float32)
        # the (1, T + 1, A, ·) window: x's frames, then y's last
        seq = np.concatenate([x[None], y[None, -1:]], axis=1)
        present = seq[..., 0] > 0
        scale = self._lock_scale(seq[..., 1:3][present])
        # a slot's id is its id at any frame it is occupied (frame 0 alone
        # would drop an agent that appears late)
        xy, mask, ids = trainer.stage_to_device(
            [seq[..., 1:3] / scale, present, seq[0, :, :, 0].max(axis=0)[None]],
            self.device)
        self._state, metrics = self._step_fn(self._state, xy, mask, ids)
        self.params = self._state.params
        return float(metrics["loss"])

    @property
    def cost(self) -> float:
        raise AttributeError(
            "cost is returned by train_step(); the TF placeholder/session "
            "pattern has no equivalent here")

    # -- inference ------------------------------------------------------------
    def sample(self, sess, traj, grid=None, dimensions=None, true_traj=None,
               num: int = 10):
        """Reference-signature sampling.

        traj: (obs_length, max_num_obj, 3) numpy, column 0 the id, any
        obs_length. sess, grid and true_traj are accepted for the
        signature and unused; dimensions, the scene's (width, height),
        sets the scale when none is locked yet. Returns (obs_length + num,
        max_num_obj, 3): traj, then the top-ranked forecast of each slot
        with its id."""
        del sess, grid, true_traj
        traj = np.asarray(traj, np.float32)
        to, a, _ = traj.shape
        present_in = traj[:, :, 0] > 0
        if dimensions is not None:
            self._scale = self._scale or float(max(*dimensions, 1.0))
        scale = self._lock_scale(traj[..., 1:3][present_in])
        traj = traj.copy()
        traj[..., 1:3] /= scale
        # the temporal-conv filter spans a fixed observation window: any
        # obs length is left-padded (mask 0) or trimmed to seq_length
        t_obs = self.cfg.seq_length
        cfg = self.cfg.replace(protocol="paper", obs_len=t_obs,
                               pred_len=self.cfg.seq_length, subsample=1)
        if t_obs not in self._samplers:
            self._samplers[t_obs] = make_rollout(
                cfg, k_samples=self.cfg.num_samples)
        rollout = self._samplers[t_obs]

        win = traj[-t_obs:]
        pad = t_obs - win.shape[0]
        if pad > 0:
            win = np.concatenate([np.zeros((pad, a, 3), np.float32), win], 0)
        slot_ids = traj[:, :, 0].max(axis=0)                 # (A,)
        obs_xy, obs_mask, ids = trainer.stage_to_device(
            [win[None, :, :, 1:3].swapaxes(1, 2),
             (win[None, :, :, 0] > 0).swapaxes(1, 2), slot_ids[None]],
            self.device)
        chunks = -(-num // cfg.pred_len)
        with torch.inference_mode():
            full = rollout(self.params, obs_xy, obs_mask, ids,
                           num_chunks=chunks, generator=self._gen)
        pred = full[0].transpose(0, 1).float().cpu().numpy()[t_obs:
                                                             t_obs + num]
        out = np.zeros((to + num, a, 3), np.float32)
        out[to:, :, 1:3] = pred * scale
        out[to:, :, 0] = slot_ids[None]
        out[:to] = traj
        out[:to, :, 1:3] *= scale
        return out
