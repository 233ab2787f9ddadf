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
training checkpoint (``Predictor.from_checkpoint``). A
:class:`StreamServer` keeps rolling per-agent histories of a frame feed and
forecasts each frame through one.
"""

from __future__ import annotations

import collections
import json
import os

import numpy as np
import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.eval import metrics as M
from desire_tpu_torch.models import desire
from desire_tpu_torch.parallel import mesh as mesh_mod
from desire_tpu_torch.params import require_device, to_device
from desire_tpu_torch.train import checkpoint as ckpt_mod
from desire_tpu_torch.utils import telemetry

# requests whose latency stats() keeps
LATENCY_WINDOW = 10_000


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
    scene_image: the (G, G, Ci) scene raster of a model with
        cfg.scene_image_channels > 0 (a server handles one camera, so the
        raster is a constant, broadcast to every window); zeros when not
        given. ``predict_windows`` can override it per call.
    mesh: an optional ``(data, k)`` ``parallel.mesh.Mesh`` for scale-out
        serving: windows split over ``data`` and hypothesis lanes over
        ``k``; the Predictor then runs on the rank's device (``device`` is
        ignored) and ``predict_windows`` is collective (its docstring).
        max_windows must split over ``data``.
    """

    def __init__(self, params, cfg: DesireConfig, *, device="cuda",
                 k_samples=None, max_windows: int = 8, seed: int = 0,
                 scene_image=None, mesh=None):
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None and max_windows % self.mesh.shape[0]:
            raise ValueError(
                f"max_windows={max_windows} must divide over the data axis "
                f"({self.mesh.shape[0]} devices)")
        self.device = (self.mesh.device if self.mesh is not None
                       else require_device(device))
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
        # (latency ms, windows carried) of the latest requests
        self._requests: collections.deque = collections.deque(
            maxlen=LATENCY_WINDOW)
        self._default_img = (None if scene_image is None
                             else self._raster(scene_image))

    def _raster(self, scene_image):
        """A (G, G, Ci) raster as float32 numpy, its shape checked against
        the model's (Ci = cfg.scene_image_channels)."""
        g, ci = self.cfg.scene_grid, self.cfg.scene_image_channels
        img = np.asarray(scene_image, np.float32)
        if img.shape != (g, g, ci):
            raise ValueError(f"scene_image must be {(g, g, ci)}, got "
                             f"{img.shape}")
        return img

    @classmethod
    def from_checkpoint(cls, save_dir: str, *, best: bool = False,
                        device="cuda", cfg: DesireConfig | None = None,
                        k_samples=None, max_windows: int = 8,
                        seed: int = 0, scene_image=None) -> "Predictor":
        """Restore the params of a training run's latest checkpoint in
        ``save_dir`` (``<save_dir>/best`` with best=True). The model's
        geometry comes from the saved config (``best/config.json`` first,
        which carries the fitted rank blend), laid over ``cfg`` (default
        ``DesireConfig()``). scene_image: as the constructor's. The
        forward is unsharded, whatever the saved config's mesh_data and
        mesh_k."""
        saved = None
        if best:
            saved = ckpt_mod.load_config(os.path.join(save_dir, "best"))
        if saved is None:
            saved = ckpt_mod.load_config(save_dir)
        if saved is None:
            raise FileNotFoundError(f"no config.json in {save_dir}")
        cfg = ckpt_mod.overlay_geometry(cfg or DesireConfig(), saved)
        dev = require_device(device)
        ckpt_dir = os.path.join(save_dir, "best") if best else save_dir
        params = ckpt_mod.restore_params(ckpt_dir, cfg, dev)
        return cls(params, cfg, device=dev, k_samples=k_samples,
                   max_windows=max_windows, seed=seed,
                   scene_image=scene_image)

    def _forward(self, xy, mask, ids, eps, img):
        out = desire.desire_forward(
            self.params, self.cfg, xy, mask, ids, eps=eps,
            generator=self._gen, k_samples=self.k,
            kernel_weights=self.kernel_weights, scene_image=img,
            mesh=self.mesh)
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
        live_slots = 0
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
            live_slots += int(live.sum())
        # the forward's agent slots, and those that carry an agent to
        # forecast
        telemetry.count("serve.slots", b * a)
        telemetry.count("serve.live_slots", live_slots)
        return xy, mask, ids

    # -- public API ----------------------------------------------------------

    def predict_windows(self, windows, scales=None, eps=None,
                        scene_image=None):
        """Forecast a list of windows (each: obs_xy (A, To, 2) in raw
        pixels, obs_mask (A, To), ids (A,)). scales: per-window
        pixels-per-unit (scalar or list; default 1.0). eps: optional latent
        noise (max_windows * max_num_obj, K, lat) for one batch of windows;
        else drawn from the Predictor's generator. scene_image: an optional
        (G, G, Ci) raster in place of the constructor's, for this call.

        Returns one dict per window: ids (A,), live (A,) bool, traj
        (A, K, Tf, 2) raw pixels, scores (A, K), best (A, Tf, 2) raw pixels.

        Under a mesh every rank of it calls this with windows of the same
        count and shapes: rank 0's assembled batch, scales, eps and raster
        are broadcast, the latent noise is the global draw of the
        generator (the same on every rank), and every rank returns the
        forecasts of rank 0's windows.
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
                    windows[i:i + self.max_windows], sc,
                    scene_image=scene_image))
            return out
        with telemetry.span("serve.request", self._calls) as request:
            out = self._request(windows, scales, eps, scene_image)
        self._calls += 1
        self._requests.append((request.wall_ns / 1e6, len(windows)))
        return out

    def _request(self, windows, scales, eps, scene_image):
        """One batch of at most max_windows windows (predict_windows)."""
        with telemetry.span("serve.assemble"):
            scales = np.broadcast_to(
                np.asarray(scales if scales is not None else 1.0,
                           np.float32), (len(windows),))
            normed = [(np.asarray(oxy, np.float32) / scales[i], om, wids)
                      for i, (oxy, om, wids) in enumerate(windows)]
            xy, mask, ids = self._assemble(normed)
            img = (self._default_img if scene_image is None
                   else self._raster(scene_image))
        with telemetry.span("serve.copy_in"):
            dev = self.device
            batch = [torch.as_tensor(x, device=dev) for x in (xy, mask, ids)]
            extra = [None if x is None else torch.as_tensor(x, device=dev)
                     for x in (eps, img)]
            if self.mesh is not None:
                # rank 0's, into copies (a broadcast writes in place)
                batch = [mesh_mod.broadcast(self.mesh, x.clone())
                         for x in batch]
                extra = [None if x is None
                         else mesh_mod.broadcast(self.mesh, x.clone())
                         for x in extra]
                scales = mesh_mod.broadcast(self.mesh, torch.tensor(
                    scales, device=dev)).cpu().numpy()
                ids = batch[2].cpu().numpy()
            eps, img = extra
            if img is not None:
                # one raster for every window of the batch
                img = img.expand((self.max_windows,) + img.shape)
        with telemetry.span("serve.forward"):
            traj, scores, best = self._forward(*batch, eps, img)
        with telemetry.span("serve.copy_back"):
            # the layer-by-layer IOC scores in the compute dtype; numpy has
            # no bfloat16
            traj, scores, best = (x.float().cpu().numpy()
                                  for x in (traj, scores, best))
        with telemetry.span("serve.answers"):
            out = []
            for i in range(len(windows)):
                na = min(np.asarray(windows[i][2]).shape[0],
                         self.cfg.max_num_obj)
                s = scales[i]
                out.append({
                    "ids": ids[i, :na].copy(),
                    "live": ids[i, :na] != 0,
                    "traj": traj[i, :na] * s,
                    "scores": scores[i, :na],
                    "best": best[i, :na] * s,
                })
        return out

    def predict(self, obs_xy, obs_mask, ids, scale=1.0, eps=None,
                scene_image=None):
        """Single-window convenience wrapper of predict_windows."""
        return self.predict_windows([(obs_xy, obs_mask, ids)], [scale],
                                    eps, scene_image)[0]

    def warmup(self):
        """One dummy window before serving traffic (builds and loads the
        kernels on CUDA); not counted in stats()."""
        a = self.cfg.max_num_obj
        self.predict(np.zeros((a, self.obs_len, 2), np.float32),
                     np.zeros((a, self.obs_len), np.float32),
                     np.zeros((a,), np.int64))
        self._requests.pop()
        self._calls -= 1
        return self

    def stats(self):
        """The request count and, over the latest ``LATENCY_WINDOW``
        requests, latency percentiles and the windows they carried a second
        of latency. A request's latency is its span ``serve.request`` on
        the host clock, call to return: the assembly, the copies, the
        forward and the answers. ``span_ms``: the mean ms a call of each
        serving span (``serve.*``, ``model.*``, ``stream.*``) since the
        process started or ``telemetry.reset()``; the registry is
        process-wide, which is the Predictor's own where a process serves
        with one Predictor (the ``model.*`` spans are training's too)."""
        if not self._requests:
            return {"calls": 0}
        lat = np.asarray([ms for ms, _ in self._requests], np.float64)
        windows = sum(n for _, n in self._requests)
        return {"calls": self._calls,
                "latency_ms_p50": float(np.percentile(lat, 50)),
                "latency_ms_p95": float(np.percentile(lat, 95)),
                "latency_ms_mean": float(lat.mean()),
                "windows_per_sec": 1e3 * windows / float(lat.sum()),
                "span_ms": telemetry.mean_ms(
                    telemetry.snapshot()["spans"],
                    ("serve.", "model.", "stream."))}


class StreamServer:
    """Rolling-buffer frame feed -> forecasts, for live serving.

    Frames come in as (frame number, [(id, x, y), ...]) in raw pixels;
    ``scale`` is the scene's pixels a unit that the checkpoint was trained
    with. Frames off the ``subsample`` grid (cfg.subsample, anchored at
    the first frame seen) update nothing: the timeline of the training
    windows. Once ``obs_len`` sampled steps have accumulated, every frame
    on the grid yields one forecast (``Predictor.predict``'s dict plus
    frame and step).
    """

    def __init__(self, predictor: Predictor, scale: float):
        self.p = predictor
        self.scale = float(scale)
        cfg = predictor.cfg
        self.subsample = cfg.subsample if cfg.protocol == "paper" else 1
        self.obs_len = predictor.obs_len
        self.f0: int | None = None
        # each agent's history of (step, x, y), newest last
        self.hist: dict[int, collections.deque] = {}
        self.step = -1

    def observe(self, frame: int, agents):
        """Feed one frame. Returns a forecast dict when one is due, else
        None. agents: iterable of (id, x, y)."""
        if self.f0 is None:
            self.f0 = int(frame)
        if (int(frame) - self.f0) % self.subsample:
            return None
        step = (int(frame) - self.f0) // self.subsample
        self.step = step
        for aid, x, y in agents:
            aid = int(aid)
            if aid == 0:          # id 0 marks an empty slot
                continue
            self.hist.setdefault(
                aid, collections.deque(maxlen=self.obs_len)).append(
                (step, float(x), float(y)))
        # drop the agents not seen for a whole window
        gone = [aid for aid, h in self.hist.items()
                if step - h[-1][0] >= self.obs_len]
        for aid in gone:
            del self.hist[aid]
        if step + 1 < self.obs_len:
            return None
        return self._forecast(step)

    def _forecast(self, step: int):
        to = self.obs_len
        a_max = self.p.cfg.max_num_obj
        # the agents present now, in slots sorted by id (the loader's
        # materialize_window order), at most max_num_obj of them
        now = sorted(aid for aid, h in self.hist.items()
                     if h[-1][0] == step)[:a_max]
        if not now:
            return None
        with telemetry.span("stream.history"):
            na = len(now)
            oxy = np.zeros((na, to, 2), np.float32)
            om = np.zeros((na, to), np.float32)
            for i, aid in enumerate(now):
                for s, x, y in self.hist[aid]:
                    t = s - (step - to + 1)
                    if 0 <= t < to:
                        oxy[i, t] = (x, y)
                        om[i, t] = 1.0
            ids = np.asarray(now, np.int64)
        out = self.p.predict(oxy, om, ids, scale=self.scale)
        out["frame"] = self.f0 + step * self.subsample
        out["step"] = step
        return out


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
