"""Vectorized trajectory windowing for SDD frame records (the port's own
copy of ``desire_tpu/data/windows.py``; numpy only).

In place of the TensorFlow reference's per-window Python loops
(``utils/data_loader.py:188-250``): instead of a frame-pointer walk with
per-step per-agent scans, each video is indexed once into a
CSR-like (frame_ptr, rec_step, rec_ids, rec_xy) structure over the *sampled*
timeline, and any window materializes with a handful of numpy gathers.

Two protocols:

* ``paper``  — 2.5 Hz subsample (``subsample`` raw frames per step), windows of
  ``obs_len + pred_len`` steps; an agent is eligible if present at every
  observed step (the DESIRE paper's protocol; absent from the reference).
* ``compat`` — native-rate windows of ``seq_length + 1`` frames; any agent
  present anywhere in the window gets a slot; the training consumer takes
  source = steps[:-1], target = steps[1:], reproducing the reference's
  one-frame-shifted targets (utils/data_loader.py:206-210).

Agent slotting: agents are ordered by id (deterministic) and truncated to
``max_num_obj`` slots; slot id 0 marks an empty slot, matching the reference's
id==0 sentinel (utils/data_loader.py:221, model/model.py:204-206).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VideoIndex:
    """One video's records, indexed by sampled-timeline step."""
    name: str
    num_steps: int            # sampled frames F
    frame_ptr: np.ndarray     # (F+1,) int64 — CSR offsets into rec_* arrays
    rec_step: np.ndarray      # (M,) int32  — sampled-step index per record
    rec_ids: np.ndarray       # (M,) int64  — agent id per record (never 0)
    rec_xy: np.ndarray        # (M, 2) float32 — normalized coordinates
    scale: float              # pixels per normalized unit (for de-normalization)


def build_video_index(name: str, frames: np.ndarray, ids: np.ndarray,
                      xy: np.ndarray, subsample: int = 1,
                      normalize: bool = True) -> VideoIndex:
    """Index one video's raw records onto the subsampled timeline.

    frames/ids: (N,), xy: (N, 2). Records not on the subsampled grid are
    dropped. Agent id 0 (if present in raw data) is dropped — 0 is the
    empty-slot sentinel.
    """
    frames = np.asarray(frames, dtype=np.int64)
    ids = np.asarray(ids, dtype=np.int64)
    xy = np.asarray(xy, dtype=np.float32)

    # raw pixel extent over the *whole* video (before any filtering) ->
    # single isotropic scale so geometry is preserved
    scale = float(max(xy.max(initial=1.0), 1.0)) if normalize else 1.0

    keep = ids != 0
    f0 = frames.min() if len(frames) else 0
    if subsample > 1:
        keep &= (frames - f0) % subsample == 0
    frames, ids, xy = frames[keep], ids[keep], xy[keep]
    xy = xy / np.float32(scale)

    step = ((frames - f0) // subsample).astype(np.int32)
    num_steps = int(step.max()) + 1 if len(step) else 0

    order = np.lexsort((ids, step))
    step, ids, xy = step[order], ids[order], xy[order]

    frame_ptr = np.zeros(num_steps + 1, dtype=np.int64)
    np.add.at(frame_ptr, step + 1, 1)
    frame_ptr = np.cumsum(frame_ptr)

    return VideoIndex(name=name, num_steps=num_steps, frame_ptr=frame_ptr,
                      rec_step=step, rec_ids=ids, rec_xy=xy, scale=scale)


def window_starts(v: VideoIndex, total_len: int, hop: int) -> np.ndarray:
    """All valid window start steps for a video."""
    if v.num_steps < total_len:
        return np.zeros((0,), dtype=np.int64)
    return np.arange(0, v.num_steps - total_len + 1, hop, dtype=np.int64)


def occupancy_prior(v: VideoIndex, grid: int) -> np.ndarray:
    """Long-term occupancy prior: bilinear splat of ALL of the video's
    records onto a (grid, grid) raster, log1p-normalized to [0, 1].

    This is the scene-layout signal the paper's camera frame carries
    (walkable paths, obstacles, entry points) derived from the data itself
    — the SDD annotation layout ships no imagery. Returned
    shape (grid, grid, 1), indexed [y][x] like scf.rasterize_occupancy's
    feature maps.
    """
    counts = np.zeros((grid, grid), dtype=np.float64)
    if len(v.rec_xy):
        xy = np.clip(v.rec_xy.astype(np.float64), 0.0, 1.0) * (grid - 1)
        x0 = np.floor(xy[:, 0]).astype(np.int64)
        y0 = np.floor(xy[:, 1]).astype(np.int64)
        fx = xy[:, 0] - x0
        fy = xy[:, 1] - y0
        x1 = np.minimum(x0 + 1, grid - 1)
        y1 = np.minimum(y0 + 1, grid - 1)
        np.add.at(counts, (y0, x0), (1 - fx) * (1 - fy))
        np.add.at(counts, (y0, x1), fx * (1 - fy))
        np.add.at(counts, (y1, x0), (1 - fx) * fy)
        np.add.at(counts, (y1, x1), fx * fy)
    r = np.log1p(counts)
    r /= max(float(r.max()), 1e-8)
    return r[..., None].astype(np.float32)


def materialize_window(v: VideoIndex, start: int, total_len: int,
                       obs_len: int, max_num_obj: int,
                       require_full_obs: bool = True):
    """Build one dense window.

    Returns (xy, mask, ids):
      xy   (total_len, max_num_obj, 2) float32 — 0 where absent
      mask (total_len, max_num_obj)    float32 — 1 where the agent is present
      ids  (max_num_obj,)              int64   — agent ids; 0 = empty slot
    """
    lo = v.frame_ptr[start]
    hi = v.frame_ptr[start + total_len]
    step = v.rec_step[lo:hi] - start          # (m,) in [0, total_len)
    rids = v.rec_ids[lo:hi]
    rxy = v.rec_xy[lo:hi]

    uids, inv = np.unique(rids, return_inverse=True)

    if require_full_obs and len(uids):
        # present at *every* observed step
        obs_count = np.zeros(len(uids), dtype=np.int32)
        np.add.at(obs_count, inv[step < obs_len], 1)
        eligible = obs_count == obs_len
        # remap to eligible-only slots
        sel = np.flatnonzero(eligible)
    else:
        sel = np.arange(len(uids))

    sel = sel[:max_num_obj]
    slot_of_uid = np.full(len(uids), -1, dtype=np.int64)
    slot_of_uid[sel] = np.arange(len(sel))

    xy = np.zeros((total_len, max_num_obj, 2), dtype=np.float32)
    mask = np.zeros((total_len, max_num_obj), dtype=np.float32)
    ids = np.zeros((max_num_obj,), dtype=np.int64)
    ids[: len(sel)] = uids[sel]

    slots = slot_of_uid[inv]
    valid = slots >= 0
    xy[step[valid], slots[valid]] = rxy[valid]
    mask[step[valid], slots[valid]] = 1.0
    return xy, mask, ids


def materialize_windows(v: VideoIndex, starts: np.ndarray, total_len: int,
                        obs_len: int, max_num_obj: int,
                        require_full_obs: bool = True):
    """Batch-materialize windows -> (B,T,A,2), (B,T,A), (B,A)."""
    n = len(starts)
    xy = np.zeros((n, total_len, max_num_obj, 2), dtype=np.float32)
    mask = np.zeros((n, total_len, max_num_obj), dtype=np.float32)
    ids = np.zeros((n, max_num_obj), dtype=np.int64)
    for i, s in enumerate(starts):
        xy[i], mask[i], ids[i] = materialize_window(
            v, int(s), total_len, obs_len, max_num_obj, require_full_obs)
    return xy, mask, ids
