"""Inference serving: forecast futures from observations only (PyTorch port
of ``desire_tpu/serve.py``).

A :class:`Predictor` holds a parameter tree on one device and turns
trailing observation histories into K IOC-ranked future trajectories. All
windows of a request go through one forward on fixed shapes (``max_windows``
windows of ``cfg.max_num_obj`` agent slots).

The future is unknown at serving time, so the future mask is 1 across the
whole horizon for every agent live at the last observed step: refinement and
scores cover all ``pred_len`` steps.

A Predictor takes an explicit ``(params, cfg, device)``, or restores a
training checkpoint (``Predictor.from_checkpoint``).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.eval import metrics as M
from desire_tpu_torch.models import desire
from desire_tpu_torch.params import init_desire, to_device
from desire_tpu_torch.train import checkpoint as ckpt_mod
from desire_tpu_torch.train.state import create_train_state


class Predictor:
    """Fixed-shape forecaster on one device.

    params: a parameter tree of tensors (``params.init_desire`` or
        ``params.from_jax``); moved to ``device``, where the CUDA kernels'
        weights are packed from it once (later changes to the tree do not
        reach them).
    k_samples: hypotheses per agent (default cfg.num_samples).
    max_windows: batch capacity; a request is padded up to it.
    device: where the forward runs. "cuda" needs a CUDA device and raises
        without one; it never falls back to the CPU.
    seed: seeds the generator of the latent noise.
    Models with cfg.scene_image_channels > 0 are served with a zero
    imagery raster.
    """

    def __init__(self, params, cfg: DesireConfig, *, device="cuda",
                 k_samples=None, max_windows: int = 8, seed: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Predictor(device='cuda') needs a CUDA device")
        self.cfg = cfg
        self.params = to_device(params, self.device)
        self.kernel_weights = desire.pack_kernel_weights(self.params, cfg,
                                                         self.device)
        self.k = int(k_samples or cfg.num_samples)
        self.max_windows = int(max_windows)
        self.obs_len = (cfg.obs_len if cfg.protocol == "paper"
                        else cfg.seq_length)
        self.pred_len = cfg.total_len - self.obs_len
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._calls = 0
        self._latencies_ms: list[float] = []

    @classmethod
    def from_checkpoint(cls, save_dir: str, *, best: bool = False,
                        device="cuda", cfg: DesireConfig | None = None,
                        k_samples=None, max_windows: int = 8,
                        seed: int = 0) -> "Predictor":
        """Restore the params of a training run's latest checkpoint in
        ``save_dir`` (``<save_dir>/best`` with best=True). The model's
        geometry comes from the saved config (``best/config.json`` first,
        which carries the fitted rank blend), laid over ``cfg`` (default
        ``DesireConfig()``)."""
        saved = None
        if best:
            saved = ckpt_mod.load_config(os.path.join(save_dir, "best"))
        if saved is None:
            saved = ckpt_mod.load_config(save_dir)
        if saved is None:
            raise FileNotFoundError(f"no config.json in {save_dir}")
        cfg = ckpt_mod.overlay_geometry(cfg or DesireConfig(), saved)
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Predictor(device='cuda') needs a CUDA device")
        template = create_train_state(cfg, to_device(init_desire(
            cfg, torch.Generator().manual_seed(cfg.seed), "cpu"), dev))
        ckpt_dir = os.path.join(save_dir, "best") if best else save_dir
        got = ckpt_mod.CheckpointManager(ckpt_dir).restore(template)
        if got is None:
            raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
        return cls(got[0].params, cfg, device=dev, k_samples=k_samples,
                   max_windows=max_windows, seed=seed)

    def _forward(self, xy, mask, ids, eps):
        out = desire.desire_forward(
            self.params, self.cfg, xy, mask, ids, eps=eps,
            generator=self._gen, k_samples=self.k,
            kernel_weights=self.kernel_weights)
        traj = out["refined_traj"]
        scores = out["scores"]
        if scores is None:
            scores = torch.zeros(traj.shape[:3], dtype=traj.dtype,
                                 device=traj.device)
        best = M.best_of_k_by_score(traj, scores,
                                    blend=max(self.cfg.rank_blend_fit, 0.0))
        return traj, scores, best

    # -- shape assembly ------------------------------------------------------

    def _assemble(self, windows):
        """windows: list of (obs_xy (A*, To, 2) normalized, obs_mask
        (A*, To), ids (A*,)) with A* <= max_num_obj -> padded numpy
        (xy (B, T, A, 2), mask (B, T, A), ids (B, A))."""
        b, a = self.max_windows, self.cfg.max_num_obj
        t, to = self.cfg.total_len, self.obs_len
        xy = np.zeros((b, t, a, 2), np.float32)
        mask = np.zeros((b, t, a), np.float32)
        ids = np.zeros((b, a), np.int64)
        for i, (oxy, omask, wids) in enumerate(windows):
            oxy = np.asarray(oxy, np.float32)
            omask = np.asarray(omask, np.float32)
            wids = np.asarray(wids, np.int64)
            na, nt = oxy.shape[0], oxy.shape[1]
            if nt != to:
                raise ValueError(f"window {i}: expected obs_len={to} steps, "
                                 f"got {nt}")
            na = min(na, a)
            xy[i, :to, :na] = np.swapaxes(oxy[:na], 0, 1)
            mask[i, :to, :na] = np.swapaxes(omask[:na], 0, 1)
            ids[i, :na] = wids[:na]
            # unknown future: refine and score the whole horizon for every
            # agent live at the last observed step
            live = (wids[:na] != 0) & (omask[:na, -1] > 0)
            mask[i, to:, :na] = live[None, :].astype(np.float32)
            ids[i, :na] *= live.astype(np.int64)
        return xy, mask, ids

    # -- public API ----------------------------------------------------------

    def predict_windows(self, windows, scales=None, eps=None):
        """Forecast a list of windows (each: obs_xy (A, To, 2) in raw
        pixels, obs_mask (A, To), ids (A,)). scales: per-window
        pixels-per-unit (scalar or list; default 1.0). eps: optional latent
        noise (max_windows * max_num_obj, K, lat) for one batch of windows;
        else drawn from the Predictor's generator.

        Returns one dict per window: ids (A,), live (A,) bool, traj
        (A, K, Tf, 2) raw pixels, scores (A, K), best (A, Tf, 2) raw pixels.
        """
        if len(windows) > self.max_windows:
            if eps is not None:
                raise ValueError("eps pins the noise of one batch of at most "
                                 f"{self.max_windows} windows")
            out = []
            for i in range(0, len(windows), self.max_windows):
                sc = (scales[i:i + self.max_windows]
                      if isinstance(scales, (list, tuple, np.ndarray))
                      else scales)
                out.extend(self.predict_windows(
                    windows[i:i + self.max_windows], sc))
            return out
        scales = np.broadcast_to(
            np.asarray(scales if scales is not None else 1.0, np.float32),
            (len(windows),))
        normed = [(np.asarray(oxy, np.float32) / scales[i], om, wids)
                  for i, (oxy, om, wids) in enumerate(windows)]
        xy, mask, ids = self._assemble(normed)
        t0 = time.perf_counter()
        dev = self.device
        traj, scores, best = self._forward(
            torch.as_tensor(xy, device=dev), torch.as_tensor(mask, device=dev),
            torch.as_tensor(ids, device=dev),
            None if eps is None else torch.as_tensor(eps, device=dev))
        # the layer-by-layer IOC scores in the compute dtype; numpy has no
        # bfloat16
        traj, scores, best = (traj.cpu().numpy(), scores.float().cpu().numpy(),
                              best.cpu().numpy())
        self._latencies_ms.append((time.perf_counter() - t0) * 1e3)
        self._calls += 1
        out = []
        for i in range(len(windows)):
            na = min(np.asarray(windows[i][2]).shape[0], self.cfg.max_num_obj)
            s = scales[i]
            out.append({
                "ids": ids[i, :na].copy(),
                "live": ids[i, :na] != 0,
                "traj": traj[i, :na] * s,
                "scores": scores[i, :na],
                "best": best[i, :na] * s,
            })
        return out

    def predict(self, obs_xy, obs_mask, ids, scale=1.0, eps=None):
        """Single-window convenience wrapper of predict_windows."""
        return self.predict_windows([(obs_xy, obs_mask, ids)], [scale],
                                    eps)[0]

    def warmup(self):
        """One dummy window before serving traffic (builds and loads the
        kernels on CUDA); not counted in stats()."""
        a = self.cfg.max_num_obj
        self.predict(np.zeros((a, self.obs_len, 2), np.float32),
                     np.zeros((a, self.obs_len), np.float32),
                     np.zeros((a,), np.int64))
        self._latencies_ms.pop()
        self._calls -= 1
        return self

    def stats(self):
        """Request count and latency percentiles (host clock, each request
        ends with its outputs copied to the host)."""
        lat = np.asarray(self._latencies_ms, np.float64)
        if not len(lat):
            return {"calls": 0}
        return {"calls": self._calls,
                "latency_ms_p50": float(np.percentile(lat, 50)),
                "latency_ms_p95": float(np.percentile(lat, 95)),
                "latency_ms_mean": float(lat.mean()),
                "windows_per_sec": 1e3 * self._calls / float(lat.sum())}


def forecast_to_json(out, top_k: int = 5) -> str:
    """One forecast dict (Predictor output) -> a compact JSON line with the
    top_k hypotheses per live agent by IOC score (0 = all)."""
    agents = []
    live = np.asarray(out["live"])
    scores = np.asarray(out["scores"])
    for i in np.flatnonzero(live):
        order = np.argsort(-scores[i])
        if top_k:
            order = order[:top_k]
        agents.append({
            "id": int(out["ids"][i]),
            "top1": np.round(out["best"][i], 2).tolist(),
            "scores": np.round(scores[i][order], 4).tolist(),
            "hypotheses": np.round(out["traj"][i][order], 2).tolist(),
        })
    rec = {k: int(out[k]) for k in ("frame", "step") if k in out}
    rec["agents"] = agents
    return json.dumps(rec)
