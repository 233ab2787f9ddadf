"""The port's data pipeline (desire_tpu_torch/data) against the JAX
package's, batch for batch and bit for bit, on synthetic trees: every
epoch's permutation, resume mid-epoch, the holdout partition, the scene
filter, the compat facade, the index cache and the native parser."""

import os

import numpy as np
import pytest

from desire_tpu.config import DesireConfig as JConfig
from desire_tpu.data import loader as jloader
from desire_tpu_torch.config import DesireConfig as TConfig
from desire_tpu_torch.data import loader as tloader
from desire_tpu_torch.data import preprocess, windows


def _write_micro_csv(path, records):
    """records: (frame, id, x, y) rows -> the transposed 4-row CSV."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.asarray(records, dtype=np.float64).T
    with open(path, "w") as f:
        for row in arr:
            f.write(",".join(f"{v:g}" for v in row) + "\n")


@pytest.fixture
def micro_tree(tmp_path, monkeypatch):
    """tests/test_data.py's micro_tree: two scenes, agents that enter,
    leave and skip frames. Both packages' index caches point at tmp_path."""
    monkeypatch.setenv("DESIRE_CACHE_DIR", str(tmp_path / "jcache"))
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", str(tmp_path / "tcache"))
    recs_a, recs_b = [], []
    for f in range(40):
        recs_a.append((f, 1, 10.0 + f, 20.0 + 2 * f))
        if f >= 5:
            recs_a.append((f, 2, 100.0 - f, 50.0))
        if f % 2 == 0:
            recs_a.append((f, 3, 5.0, 5.0 + f))
        if f < 3:
            recs_a.append((f, 4, 60.0, 60.0 + f))
    for f in range(25):
        recs_b.append((f, 7, 1.0 + f, 1.0))
    root = tmp_path / "data"
    _write_micro_csv(str(root / "sceneA/video0/annotations_processed.csv"),
                     recs_a)
    _write_micro_csv(str(root / "sceneB/video0/annotations_processed.csv"),
                     recs_b)
    return str(root)


@pytest.fixture
def split_tree(tmp_path, monkeypatch):
    """tests/test_data.py's split_tree: sceneA has 3 videos, sceneB 2
    (video9 sorts last), sceneC 1."""
    monkeypatch.setenv("DESIRE_CACHE_DIR", str(tmp_path / "jcache"))
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", str(tmp_path / "tcache"))

    def traj(seed, n=30):
        rng = np.random.default_rng(seed)
        return [(f, 1, 10.0 + f + rng.normal(), 20.0 + f) for f in range(n)]
    layout = {"sceneA": ["video0", "video1", "video2"],
              "sceneB": ["video10", "video9"], "sceneC": ["video0"]}
    i = 0
    for scene, vids in layout.items():
        for v in vids:
            _write_micro_csv(str(tmp_path / "data" / scene / v
                                 / "annotations_processed.csv"), traj(i))
            i += 1
    return str(tmp_path / "data")


def _both(**kw):
    return JConfig(**kw), TConfig(**kw)


def _same_batch(a, b):
    for name in ("xy", "mask", "ids", "video", "scale"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.image is None) == (b.image is None)
    if a.image is not None:
        np.testing.assert_array_equal(a.image, b.image)


def _same_stream(jl, tl, epochs=(0, 1, 2)):
    assert (tl.num_windows, tl.num_batches) == (jl.num_windows,
                                                jl.num_batches)
    assert [v.name for v in tl.videos] == [v.name for v in jl.videos]
    for e in epochs:
        jb, tb = list(jl.epoch_batches(e)), list(tl.epoch_batches(e))
        assert len(jb) == len(tb) == jl.num_batches
        for a, b in zip(jb, tb):
            _same_batch(a, b)
        assert (tl.state.epoch, tl.state.batch_index) == \
            (jl.state.epoch, jl.state.batch_index)


@pytest.mark.parametrize("kw", [
    dict(protocol="paper", obs_len=3, pred_len=2, subsample=1,
         max_num_obj=4, window_hop=1, batch_size=4, seed=7),
    dict(protocol="paper", obs_len=2, pred_len=1, subsample=2,
         max_num_obj=3, window_hop=1, batch_size=3, normalize=False),
    dict(protocol="compat", seq_length=6, max_num_obj=5, window_hop=2,
         batch_size=2),
    dict(protocol="paper", obs_len=2, pred_len=1, subsample=2,
         max_num_obj=4, window_hop=1, batch_size=2,
         scene_image_channels=1, scene_grid=8)])
def test_epochs_match_jax(micro_tree, kw):
    """Every batch of three epochs, bit for bit (permutations included),
    with and without the remainder batch, and materialize."""
    jc, tc = _both(data_dir=micro_tree, holdout="none", **kw)
    for drop in (True, False):
        jl = jloader.SDDLoader(jc, use_native=False, drop_remainder=drop)
        tl = tloader.SDDLoader(tc, use_native=False, drop_remainder=drop)
        _same_stream(jl, tl)
    _same_batch(jl.materialize(5), tl.materialize(5))


def test_resume_matches_jax(micro_tree):
    """resume_iter from a mid-epoch LoaderState gives the JAX loader's
    tail of that epoch."""
    jc, tc = _both(data_dir=micro_tree, protocol="paper", obs_len=3,
                   pred_len=2, subsample=1, max_num_obj=4, window_hop=1,
                   batch_size=4, seed=3, holdout="none")
    jl = jloader.SDDLoader(jc, use_native=False)
    tl = tloader.SDDLoader(tc, use_native=False)
    it = tl.epoch_batches(epoch=5)
    next(it)
    next(it)
    st = tl.state
    assert (st.epoch, st.batch_index) == (5, 2)
    tail = list(tloader.SDDLoader(tc, use_native=False).resume_iter(st))
    want = list(jl.resume_iter(jloader.LoaderState(5, 2)))
    assert len(tail) == len(want) == jl.num_batches - 2
    for a, b in zip(want, tail):
        _same_batch(a, b)


def test_holdout_partition_matches_jax(split_tree):
    """The train and held-out splits (and all videos) as in the JAX
    package, with the same batches."""
    assert tloader.heldout_videos(
        ["sceneA/video0", "sceneA/video1", "sceneA/video2",
         "sceneB/video10", "sceneB/video9", "sceneC/video0"]) \
        == {"sceneA/video2", "sceneB/video9"}
    jc, tc = _both(protocol="paper", obs_len=3, pred_len=2, subsample=1,
                   max_num_obj=4, window_hop=1, batch_size=2,
                   data_dir=split_tree)
    for split in (None, "train", "heldout"):
        jl = jloader.SDDLoader(jc, use_native=False, split=split,
                               drop_remainder=False)
        tl = tloader.SDDLoader(tc, use_native=False, split=split,
                               drop_remainder=False)
        _same_stream(jl, tl, epochs=(0, 1))
    with pytest.raises(ValueError):
        tloader.SDDLoader(tc.replace(holdout="none"), use_native=False,
                          split="train")


def test_scene_filter_and_missing_dir(micro_tree, tmp_path):
    jc, tc = _both(protocol="paper", obs_len=3, pred_len=2, subsample=1,
                   max_num_obj=4, window_hop=1, batch_size=2,
                   data_dir=micro_tree, scenes="sceneB", holdout="none")
    tl = tloader.SDDLoader(tc, use_native=False)
    assert [v.name for v in tl.videos] == ["sceneB/video0"]
    _same_stream(jloader.SDDLoader(jc, use_native=False), tl, epochs=(0,))
    with pytest.raises(FileNotFoundError):
        tloader.SDDLoader(tc, data_dir=str(tmp_path / "empty"),
                          use_native=False)


def test_compat_loader_matches_jax(micro_tree):
    """CompatDataLoader's (x, y, d) lists, across an epoch boundary."""
    kw = dict(batch_size=2, seq_length=8, max_num_obj=6, leave_dataset=5,
              data_dir=micro_tree)
    jl, tl = jloader.CompatDataLoader(**kw), tloader.CompatDataLoader(**kw)
    assert tl.num_batches == jl.num_batches
    for _ in range(jl.num_batches + 2):
        for a, b in zip(jl.next_batch(), tl.next_batch()):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_index_cache_roundtrip(micro_tree, tmp_path, monkeypatch):
    """The port's npz index cache: a second start serves identical indices
    without reading the CSVs, a touched CSV is parsed again, the kill
    switch turns it off, and it lives in the port's own directory."""
    cfg = TConfig(protocol="paper", obs_len=2, pred_len=1, subsample=2,
                  batch_size=2, max_num_obj=4, window_hop=1, holdout="none",
                  data_dir=micro_tree)
    l1 = tloader.SDDLoader(cfg)
    assert len(list((tmp_path / "tcache").glob("vi_*.npz"))) == 2
    assert not (tmp_path / "jcache").exists()

    calls = {"n": 0}
    real = tloader._native_or_python_reader(True)

    def counting(path):
        calls["n"] += 1
        return real(path)

    monkeypatch.setattr(tloader, "_native_or_python_reader",
                        lambda use: counting)
    l2 = tloader.SDDLoader(cfg)
    assert calls["n"] == 0
    for a, b in zip(l1.videos, l2.videos):
        assert a.name == b.name and a.scale == b.scale
        for f in ("frame_ptr", "rec_step", "rec_ids", "rec_xy"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    p = os.path.join(micro_tree, "sceneA/video0/annotations_processed.csv")
    os.utime(p, ns=(os.stat(p).st_atime_ns, os.stat(p).st_mtime_ns + 7))
    tloader.SDDLoader(cfg)
    assert calls["n"] == 1
    monkeypatch.setenv("DESIRE_TORCH_DATA_CACHE", "0")
    tloader.SDDLoader(cfg)
    assert calls["n"] == 3


def test_native_parser_matches_python(micro_tree, tmp_path):
    """The port's C++ parser, built with g++ into its package directory,
    against the Python reader; the loader names the reader it used."""
    from desire_tpu_torch.data.native import build, fast_csv
    try:
        build.build(verbose=False)
    except FileNotFoundError:
        pytest.skip("no g++ to build the native parser")
    fast_csv._lib = None
    assert fast_csv.available()
    path = os.path.join(micro_tree, "sceneA/video0/annotations_processed.csv")
    for a, b in zip(fast_csv.read_processed_csv(path),
                    tloader._python_reader(path)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    cfg = TConfig(protocol="paper", obs_len=2, pred_len=1, subsample=2,
                  batch_size=2, max_num_obj=4, holdout="none",
                  data_dir=micro_tree)
    assert tloader.SDDLoader(cfg).reader.endswith("fast_csv."
                                                  "read_processed_csv")
    assert tloader.SDDLoader(cfg, use_native=False).reader.endswith(
        "_python_reader")


def test_preprocess_and_windows_match_jax(tmp_path):
    """annotations.txt conversion and a video index, against the JAX
    modules."""
    from desire_tpu.data import preprocess as jpre
    from desire_tpu.data import windows as jwin
    txt = tmp_path / "annotations.txt"
    txt.write_text('5 10 20 30 40 100 x y z "l"\n6 0 0 10 10 101 a b c '
                   '"m"\n7 3 4 5 9 102 a b c "m"\n')
    for mod in (preprocess, jpre):
        np.testing.assert_array_equal(
            mod.read_processed_csv(mod.convert_annotation_file(str(txt))),
            jpre.read_processed_csv(str(tmp_path / "annotations_processed"
                                        ".csv")))
    rng = np.random.default_rng(0)
    frames = np.repeat(np.arange(30), 3)
    ids = np.tile([1, 2, 0], 30)
    xy = rng.uniform(0, 50, (90, 2))
    a = windows.build_video_index("v", frames, ids, xy, subsample=3)
    b = jwin.build_video_index("v", frames, ids, xy, subsample=3)
    for f in ("frame_ptr", "rec_step", "rec_ids", "rec_xy"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for got, want in zip(windows.materialize_window(a, 2, 5, 3, 4),
                         jwin.materialize_window(b, 2, 5, 3, 4)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(windows.occupancy_prior(a, 8),
                                  jwin.occupancy_prior(b, 8))
