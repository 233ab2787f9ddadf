"""Deterministic, checkpointable SDD data pipeline (the port's own copy of
``desire_tpu/data/loader.py``; numpy only, it imports nothing of the JAX
package).

* one-pass CSV ingestion (the C++ fast parser in ``data/native`` when it is
  built, else the Python reader; ``SDDLoader.reader`` names the one used)
  into per-video CSR indices (``windows.py``), memoized per video in an npz
  cache of the port's own (``~/.cache/desire_tpu_torch``, or
  ``$DESIRE_TORCH_CACHE_DIR``; ``DESIRE_TORCH_DATA_CACHE=0`` turns it off),
  so neither package reads the other's files;
* windows are enumerated up front and shuffled with a seeded numpy
  generator per epoch, so the stream is bit-reproducible and resumable at
  any batch (``LoaderState``) for checkpoint and restore;
* batches come out as host numpy arrays: dense ``(B, T, A, 2)`` float32
  positions with masks, assembled with vectorized gathers
  (``train.trainer.batch_to_device`` moves them to the card).

``CompatDataLoader`` reproduces the ``next_batch() -> (x, y, d)`` surface
of the TensorFlow reference's ``utils/data_loader.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Iterator

import numpy as np

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.data import preprocess, windows
from desire_tpu_torch.utils import telemetry


def heldout_videos(rels: list[str]) -> set[str]:
    """The deterministic held-out video set (config.py holdout='video').

    Generalizes the reference's ``leave_dataset`` train/test-separation
    intent (its train.py:77-78, utils/data_loader.py:91) from
    "skip dataset index N" to a reproducible per-scene video holdout: the
    lexicographically LAST video of every scene that has >= 2 videos. Scenes
    with a single checked-in video stay fully in training (holding them out
    would delete the scene from the train distribution).
    """
    by_scene: dict[str, list[str]] = {}
    for rel in rels:
        by_scene.setdefault(rel.split("/")[0], []).append(rel)
    return {sorted(v)[-1] for v in by_scene.values() if len(v) >= 2}


@dataclasses.dataclass
class Batch:
    """One device-ready training batch (numpy, host-side)."""
    xy: np.ndarray       # (B, T, A, 2) float32, normalized coords
    mask: np.ndarray     # (B, T, A) float32 presence mask
    ids: np.ndarray      # (B, A) int64 agent ids (0 = empty)
    video: np.ndarray    # (B,) int32 video index
    scale: np.ndarray    # (B,) float32 de-normalization scale
    image: np.ndarray | None = None  # (B, G, G, Ci) per-video scene raster
    #                                  (cfg.scene_image_channels > 0 only)

    @property
    def batch_size(self) -> int:
        return self.xy.shape[0]


@dataclasses.dataclass
class LoaderState:
    """Resume point for the deterministic stream."""
    epoch: int = 0
    batch_index: int = 0


class SDDLoader:
    """Windowed multi-agent SDD stream.

    protocol='paper': T = obs_len + pred_len at 2.5 Hz; agents need a full
    observation history. protocol='compat': T = seq_length + 1 at native rate
    (consumer splits source/target by one step).
    """

    def __init__(self, cfg: DesireConfig, data_dir: str | None = None,
                 max_videos: int | None = None, use_native: bool = True,
                 drop_remainder: bool = True, split: str | None = None):
        """split: None = all videos (pre-round-3 behavior); 'train' /
        'heldout' = the two sides of the holdout partition (heldout_videos;
        requires cfg.holdout != 'none')."""
        self.cfg = cfg
        self.data_dir = data_dir or cfg.data_dir
        scene_filter = {s for s in cfg.scenes.split(",") if s} or None

        subsample = cfg.subsample if cfg.protocol == "paper" else 1
        self.total_len = cfg.total_len
        self.obs_len = cfg.obs_len if cfg.protocol == "paper" else cfg.seq_length
        self.require_full_obs = cfg.protocol == "paper"
        self.drop_remainder = drop_remainder
        self.split = split

        listing = [(rel, path) for rel, path
                   in preprocess.iter_video_csvs(self.data_dir, max_videos)
                   if not scene_filter or rel.split("/")[0] in scene_filter]
        if split is not None:
            if split not in ("train", "heldout"):
                raise ValueError(f"split must be 'train'|'heldout' (got {split!r})")
            if cfg.holdout == "none":
                raise ValueError("split requested but cfg.holdout == 'none'")
            held = heldout_videos([rel for rel, _ in listing])
            if not held:
                raise FileNotFoundError(
                    "holdout='video' needs at least one scene with >= 2 "
                    f"videos under {self.data_dir}")
            keep = (lambda rel: rel in held) if split == "heldout" \
                else (lambda rel: rel not in held)
            listing = [(rel, path) for rel, path in listing if keep(rel)]

        reader = _native_or_python_reader(use_native)
        # which parser read the CSVs (those not served from the cache)
        self.reader = f"{reader.__module__}.{reader.__name__}"
        self.videos: list[windows.VideoIndex] = []
        for rel, path in listing:
            vi = _load_or_build_index(rel, path, reader,
                                      subsample, cfg.normalize)
            if vi.num_steps >= self.total_len:
                self.videos.append(vi)
        if not self.videos:
            raise FileNotFoundError(
                f"no usable annotations_processed.csv under {self.data_dir}")

        # per-video scene raster table (the paper's scene-CNN imagery input):
        # (V, G, G, Ci), gathered per window in _assemble
        self.scene_rasters: np.ndarray | None = None
        if cfg.scene_image_channels > 0:
            self.scene_rasters = np.stack([
                _video_raster(v, cfg.scene_grid, cfg.scene_image_channels,
                              cfg.scene_image_source)
                for v in self.videos])

        # Global (video, start) enumeration.
        pairs = []
        for vidx, v in enumerate(self.videos):
            for s in windows.window_starts(v, self.total_len, cfg.window_hop):
                pairs.append((vidx, s))
        self._pairs = np.asarray(pairs, dtype=np.int64)  # (N, 2)
        self.num_windows = len(self._pairs)
        self.num_batches = self.num_windows // cfg.batch_size
        if not drop_remainder and self.num_windows % cfg.batch_size:
            self.num_batches += 1
        self.state = LoaderState()

    # -- deterministic epoch permutation ------------------------------------
    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, epoch))
        return rng.permutation(self.num_windows)

    @telemetry.span("loader.assemble")
    def _assemble(self, pair_rows: np.ndarray) -> Batch:
        b = len(pair_rows)
        A, T = self.cfg.max_num_obj, self.total_len
        xy = np.zeros((b, T, A, 2), dtype=np.float32)
        mask = np.zeros((b, T, A), dtype=np.float32)
        ids = np.zeros((b, A), dtype=np.int64)
        video = np.zeros((b,), dtype=np.int32)
        scale = np.zeros((b,), dtype=np.float32)
        for i, (vidx, start) in enumerate(pair_rows):
            v = self.videos[vidx]
            xy[i], mask[i], ids[i] = windows.materialize_window(
                v, int(start), T, self.obs_len, A, self.require_full_obs)
            video[i] = vidx
            scale[i] = v.scale
        image = (None if self.scene_rasters is None
                 else self.scene_rasters[video])
        return Batch(xy=xy, mask=mask, ids=ids, video=video, scale=scale,
                     image=image)

    def epoch_batches(self, epoch: int, start_batch: int = 0,
                      rows: np.ndarray | None = None) -> Iterator[Batch]:
        """Yield the batches of one epoch, resumable at any batch index
        (``state`` is the position after the batch last yielded).

        rows: optional indices within each global batch to assemble, the
        data-parallel hook: every rank walks the same seeded permutation
        and assembles only its rows (``parallel.mesh.local_batch_rows``)."""
        perm = self._perm(epoch)
        bs = self.cfg.batch_size
        for bi in range(start_batch, self.num_batches):
            idx = perm[bi * bs:(bi + 1) * bs]
            if rows is not None:
                idx = idx[rows[rows < len(idx)]]
            self.state = LoaderState(epoch=epoch, batch_index=bi + 1)
            yield self._assemble(self._pairs[idx])

    def resume_iter(self, state: LoaderState) -> Iterator[Batch]:
        return self.epoch_batches(state.epoch, state.batch_index)

    def materialize(self, limit: int | None = None) -> Batch:
        """Fully materialize up to `limit` windows (tests / tiny datasets /
        HBM-resident training)."""
        n = self.num_windows if limit is None else min(limit, self.num_windows)
        return self._assemble(self._pairs[:n])


def _video_raster(v: windows.VideoIndex, grid: int, channels: int,
                  source: str) -> np.ndarray:
    """One video's (G, G, Ci) scene raster (cfg.scene_image_source)."""
    if source == "occupancy":
        if channels != 1:
            raise ValueError("scene_image_source='occupancy' is 1-channel "
                             f"(got scene_image_channels={channels})")
        return windows.occupancy_prior(v, grid)
    # a directory of camera frames: <source>/<scene>/<video>/reference.*
    base = os.path.join(source, v.name)
    for ext in ("npy", "jpg", "jpeg", "png"):
        path = os.path.join(base, f"reference.{ext}")
        if os.path.exists(path):
            break
    else:
        raise FileNotFoundError(
            f"no reference.(npy|jpg|jpeg|png) under {base} "
            f"(scene_image_source={source!r})")
    if path.endswith(".npy"):
        img = np.asarray(np.load(path), dtype=np.float32)
        if img.ndim == 2:
            img = img[..., None]
    else:
        from PIL import Image
        mode = "L" if channels == 1 else "RGB"
        img = np.asarray(Image.open(path).convert(mode),
                         dtype=np.float32) / 255.0
        if img.ndim == 2:
            img = img[..., None]
    if img.shape[-1] != channels:
        raise ValueError(f"{path}: {img.shape[-1]} channels, config wants "
                         f"{channels}")
    # resample onto the isotropic [0,1]^2 annotation frame: coordinates are
    # normalized by ONE scale (windows.build_video_index), so the image sits
    # in a square of side v.scale pixels; grid cell (gy, gx) samples the
    # pixel at ((gy+.5), (gx+.5)) * scale/G (nearest; out-of-frame = 0)
    out = np.zeros((grid, grid, channels), np.float32)
    h, w = img.shape[:2]
    cs = (np.arange(grid, dtype=np.float64) + 0.5) * v.scale / grid
    yi = np.round(cs - 0.5).astype(np.int64)
    xi = yi.copy()
    ym = yi < h
    xm = xi < w
    out[np.ix_(ym, xm)] = img[np.clip(yi[ym], 0, h - 1)][:,
                              np.clip(xi[xm], 0, w - 1)]
    return out


def _cache_dir() -> str:
    return (os.environ.get("DESIRE_TORCH_CACHE_DIR")
            or os.path.join(os.path.expanduser("~"), ".cache",
                            "desire_tpu_torch"))


@telemetry.span("setup.loader_index")
def _load_or_build_index(rel: str, path: str, reader, subsample: int,
                         normalize: bool) -> windows.VideoIndex:
    """Parse+index one video, memoized to an npz keyed by the CSV's
    identity (abspath, mtime, size) and the indexing parameters.

    The reference cached its parsed tree to data/trajectories.cpkl
    (its utils/data_loader.py:52-64); this is the same idea
    per-video, but keyed by content identity (a touched CSV re-parses
    automatically — the reference's pickle went stale silently) and kept
    OUTSIDE the data dir (which may be read-only). CLI sweeps that restart
    the process dozens of times skip the 3.5M-record parse+index on every
    start. Disable with DESIRE_TORCH_DATA_CACHE=0; relocate with
    DESIRE_TORCH_CACHE_DIR.
    """
    cache_on = os.environ.get("DESIRE_TORCH_DATA_CACHE", "1") == "1"
    cpath = None
    if cache_on:
        try:
            st = os.stat(path)
            key = hashlib.sha1(
                f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}|"
                f"{subsample}|{normalize}|v1".encode()).hexdigest()[:20]
            cpath = os.path.join(_cache_dir(), f"vi_{key}.npz")
            if os.path.exists(cpath):
                z = np.load(cpath, allow_pickle=False)
                return windows.VideoIndex(
                    name=rel, num_steps=int(z["num_steps"]),
                    frame_ptr=z["frame_ptr"], rec_step=z["rec_step"],
                    rec_ids=z["rec_ids"], rec_xy=z["rec_xy"],
                    scale=float(z["scale"]))
        except Exception:
            cpath = None  # unreadable/corrupt cache entry: rebuild below
    frames, ids, xs, ys = reader(path)
    vi = windows.build_video_index(rel, frames, ids, np.stack([xs, ys], -1),
                                   subsample=subsample, normalize=normalize)
    if cpath is not None:
        try:
            os.makedirs(_cache_dir(), exist_ok=True)
            tmp = f"{cpath}.tmp{os.getpid()}.npz"
            np.savez(tmp, num_steps=vi.num_steps, frame_ptr=vi.frame_ptr,
                     rec_step=vi.rec_step, rec_ids=vi.rec_ids,
                     rec_xy=vi.rec_xy, scale=vi.scale)
            os.replace(tmp, cpath)  # atomic: concurrent starts can't tear it
        except Exception:
            pass  # caching is best-effort; the parse result is already live
    return vi


def _python_reader(path: str):
    rec = preprocess.read_processed_csv(path)
    return (rec[0].astype(np.int64), rec[1].astype(np.int64),
            rec[2].astype(np.float32), rec[3].astype(np.float32))


def _native_or_python_reader(use_native: bool):
    if use_native:
        from desire_tpu_torch.data.native import fast_csv
        try:
            if fast_csv.available():
                return fast_csv.read_processed_csv
        except OSError:
            pass  # a library that does not load: the Python reader
    return _python_reader


class CompatDataLoader:
    """Reference-shaped facade: mirrors the public surface of the reference
    DataLoader (utils/data_loader.py — __init__(batch_size, seq_length,
    max_num_obj, leave_dataset), .next_batch(), .num_batches,
    .reset_batch_pointer(), .tick_batch_pointer()).

    next_batch() returns (x_batch, y_batch, d) lists of
    (seq_length, max_num_obj, 3) arrays with [:, :, 0] = agent id — the exact
    tensor layout train.py:140-173 consumed — where y is the one-frame-shifted
    source (utils/data_loader.py:206-210).
    """

    def __init__(self, batch_size=50, seq_length=5, max_num_obj=40,
                 leave_dataset=1, preprocess_flag=False, data_dir="data/",
                 seed=0):
        cfg = DesireConfig(batch_size=batch_size, seq_length=seq_length,
                           max_num_obj=max_num_obj, protocol="compat",
                           normalize=False, window_hop=seq_length, seed=seed)
        self._loader = SDDLoader(cfg, data_dir=data_dir,
                                 max_videos=leave_dataset)
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.max_num_obj = max_num_obj
        self.num_batches = self._loader.num_batches
        self._epoch = 0
        self._iter = None

    def reset_batch_pointer(self):
        self._iter = self._loader.epoch_batches(self._epoch)
        self._epoch += 1

    def tick_batch_pointer(self):  # kept for surface parity; epochs advance
        self.reset_batch_pointer()  # the permutation instead of a video ptr

    def next_batch(self, random_update=True):
        if self._iter is None:
            self.reset_batch_pointer()
        try:
            b = next(self._iter)
        except StopIteration:
            self.reset_batch_pointer()
            b = next(self._iter)
        x_batch, y_batch, dval = [], [], []
        for i in range(b.batch_size):
            full = np.concatenate(
                [np.broadcast_to(b.ids[i].astype(np.float32)[None, :, None],
                                 (b.xy.shape[1], self.max_num_obj, 1))
                 * b.mask[i][..., None],
                 b.xy[i]], axis=-1)  # (T, A, 3) with id column
            x_batch.append(full[:-1])
            y_batch.append(full[1:])
            dval.append(int(b.video[i]))
        return x_batch, y_batch, dval
