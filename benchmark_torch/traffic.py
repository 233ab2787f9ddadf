"""The benchmark's traffic, every draw from ``--seed``.

* ``walk_windows``: observation windows of walking agents in raw pixels,
  straight and curved (the serving cells' requests);
* ``write_sdd_tree``: a synthetic Stanford Drone Dataset tree for the
  training loader (the dataset's transposed four-row CSV layout).
"""

from __future__ import annotations

import os

import numpy as np


def walk_tracks(rng, n, steps, speed, turn, extent):
    """n tracks of ``steps`` points: a start uniform in the middle 80 % of
    an ``extent``-pixel square, a speed uniform in ``speed`` px a step, a
    uniform heading turned by a constant rate uniform in ``turn`` rad a
    step (0: a straight walk). Returns (n, steps, 2) float64."""
    p0 = rng.uniform(0.1 * extent, 0.9 * extent, (n, 2))
    v = rng.uniform(speed[0], speed[1], n)
    head = rng.uniform(0.0, 2.0 * np.pi, n)
    rate = rng.uniform(turn[0], turn[1], n)
    ang = head[:, None] + rate[:, None] * np.arange(steps)[None]
    step = v[:, None, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    return p0[:, None] + np.cumsum(step, axis=1) - step[:, :1]


def walk_windows(rng, batches, windows, agents, obs_len, speed, turn,
                 extent):
    """``batches`` requests of ``windows`` observation windows, each of
    ``agents`` agents observed at every one of ``obs_len`` steps: a list of
    lists of (obs_xy (A, To, 2) float32 px, obs_mask (A, To), ids (A,) =
    1..A)."""
    out = []
    ids = np.arange(1, agents + 1, dtype=np.int64)
    mask = np.ones((agents, obs_len), np.float32)
    for _ in range(batches):
        out.append([(walk_tracks(rng, agents, obs_len, speed, turn,
                                 extent).astype(np.float32), mask, ids)
                     for _ in range(windows)])
    return out


def write_sdd_tree(root, rng, scenes, videos, frames, heldout_frames,
                   alive, subsample, extent=1000.0):
    """<root>/scene<i>/video<j>/annotations_processed.csv: rows frames,
    ids, xs, ys; agents walking straight lines (+ 0.3 px noise) in an
    ``extent``-pixel scene, each alive 1200-2400 frames, about ``alive``
    at a frame, a record on every ``subsample``-th frame (the loader keeps
    no other). The last video of a scene is the held-out one and gets
    ``heldout_frames`` frames."""
    for s in range(scenes):
        for v in range(videos):
            nf = heldout_frames if v == videos - 1 else frames
            n = int(alive * (nf + 1800) / 1800)
            start = rng.integers(-1800, nf, n)
            life = rng.integers(1200, 2401, n)
            p0 = rng.uniform(0.1 * extent, 0.9 * extent, (n, 2))
            vel = rng.uniform(-0.5, 0.5, (n, 2))
            recs = []
            for i in range(n):
                lo = max(start[i], 0)
                lo += -lo % subsample
                f = np.arange(lo, min(start[i] + life[i], nf), subsample)
                if len(f):
                    xy = np.clip(p0[i] + vel[i] * (f - start[i])[:, None]
                                 + rng.normal(0, 0.3, (len(f), 2)), 0, extent)
                    recs.append(np.column_stack(
                        [f, np.full(len(f), i + 1), xy]))
            rec = np.concatenate(recs)
            rec = rec[np.lexsort((rec[:, 1], rec[:, 0]))].T
            path = os.path.join(root, f"scene{s}", f"video{v}",
                                "annotations_processed.csv")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as fh:
                np.savetxt(fh, rec, fmt="%.2f", delimiter=",")
    return root

