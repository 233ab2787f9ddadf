"""The scene-imagery raster (cfg.scene_image_channels > 0) through the
port against the JAX package on the CPU, with a non-zero raster:
``desire_forward`` and ``desire_loss``, one ``make_train_step`` step on a
loader batch (the loader's occupancy rasters), ``batch_to_device``, and a
``Predictor`` with its constant raster and a per-call one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desire_tpu.models import desire as jdesire
from desire_tpu.serve import Predictor as JPredictor
from desire_tpu_torch.data.loader import SDDLoader
from desire_tpu_torch.models import desire as tdesire
from desire_tpu_torch.params import from_jax, init_desire, to_numpy
from desire_tpu_torch.serve import Predictor
from desire_tpu_torch.train.trainer import batch_to_device
from test_torch_train import (TOL, _batch, _cfg, _check_train_step,
                              _loss_noise, _micro_dataset, _torch)

# a whole forward at float32 (tests/test_torch_eval.py's z_temp forward)
FWD_TOL = dict(rtol=2e-4, atol=2e-4)


def _img_cfg(**kw):
    return _cfg(scene_image_channels=1, **kw)


@pytest.fixture(scope="module")
def jax_params():
    """The imagery model's tree (the scene CNN's first layer takes the
    raster as a third channel), by the port's init, with the zero-init
    heads made non-zero."""
    p = to_numpy(init_desire(_img_cfg(), torch.Generator().manual_seed(0),
                             "cpu"))
    assert p["scf"]["conv1"]["w"].shape[2] == 3
    rng = np.random.default_rng(1)
    for sub, name in (("sgm", "prior"), ("sgm", "ztemp_fc2"),
                      ("ioc", "delta"), ("ioc", "gate")):
        w = p[sub][name]["w"]
        p[sub][name]["w"] = (0.3 * rng.standard_normal(w.shape)).astype(
            np.float32)
    return jax.tree_util.tree_map(jnp.asarray, p)


def _raster(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    g = cfg.scene_grid
    return rng.uniform(0.0, 1.0, (b, g, g, 1)).astype(np.float32)


def _latent(cfg, key, rows):
    """The latent draw of a JAX inference forward called with ``key``."""
    return _torch(jax.random.normal(jax.random.split(key, 3)[0],
                                    (rows, cfg.num_samples,
                                     cfg.latent_size)))


def test_forward_with_raster_matches_jax(jax_params):
    """Fails where the forward drops the raster: its scene features, and
    so the refined positions and scores, differ from zero imagery's."""
    cfg = _img_cfg()
    xy, mask, ids = _batch(cfg)
    img = _raster(cfg, xy.shape[0])
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, *a: jdesire.desire_forward(
        p, cfg, *a[:3], key=key, train=False, scene_image=a[3]))(
            jax_params, *map(jnp.asarray, (xy, mask, ids, img)))
    tp = from_jax(jax_params)
    eps = _latent(cfg, key, xy.shape[0] * xy.shape[2])
    got = tdesire.desire_forward(tp, cfg, *map(_torch, (xy, mask, ids)),
                                 eps=eps, scene_image=_torch(img))
    for name in ("raw5", "sgm_traj", "refined_traj", "scores"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   err_msg=name, **FWD_TOL)
    zero = tdesire.desire_forward(tp, cfg, *map(_torch, (xy, mask, ids)),
                                  eps=eps)
    assert not torch.allclose(got["scores"], zero["scores"], **FWD_TOL)


def test_loss_with_raster_matches_jax(jax_params):
    """The total and every metric of desire_loss."""
    cfg = _img_cfg()
    xy, mask, ids = _batch(cfg)
    img = _raster(cfg, xy.shape[0], seed=1)
    key = jax.random.PRNGKey(3)
    total, metrics = jax.jit(lambda p, *a: jdesire.desire_loss(
        p, cfg, *a[:3], key=key, step=7, scene_image=a[3]))(
            jax_params, *map(jnp.asarray, (xy, mask, ids, img)))
    noise = {k: _torch(v) for k, v in
             _loss_noise(cfg, key, xy.shape[0], xy.shape[2]).items()}
    t_total, t_metrics = tdesire.desire_loss(
        from_jax(jax_params), cfg, *map(_torch, (xy, mask, ids)), step=7,
        noise=noise, scene_image=_torch(img))
    np.testing.assert_allclose(float(t_total), float(total), **TOL)
    assert set(t_metrics) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(metrics[k]),
                                   err_msg=k, **TOL)


def test_train_step_on_a_loader_batch_with_raster(jax_params, tmp_path,
                                                  monkeypatch):
    """batch_to_device hands the loader's occupancy raster on, and one
    make_train_step step on that batch matches the JAX step."""
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    cfg = _img_cfg(data_dir=_micro_dataset(tmp_path), subsample=2,
                   window_hop=2, save_dir="")
    batch = next(SDDLoader(cfg, use_native=False).epoch_batches(0))
    staged = batch_to_device(batch, "cpu")
    assert len(staged) == 4
    np.testing.assert_array_equal(staged[3].numpy(), batch.image)
    assert batch.image.shape == (cfg.batch_size, cfg.scene_grid,
                                 cfg.scene_grid, 1)
    assert batch.image.max() > 0
    _check_train_step(cfg, jax_params,
                      batch=tuple(x.numpy() for x in staged))


def _window(cfg, na=3, seed=0):
    """na straight-line agents in raw pixels (scale 100)."""
    rng = np.random.RandomState(seed)
    t = np.arange(cfg.obs_len, dtype=np.float32)
    p0 = rng.uniform(20, 60, (na, 2)).astype(np.float32)
    v = rng.uniform(-2, 2, (na, 2)).astype(np.float32)
    return (p0[:, None] + v[:, None] * t[None, :, None],
            np.ones((na, cfg.obs_len), np.float32),
            np.arange(1, na + 1, dtype=np.int64))


def test_predictor_with_raster_matches_jax(jax_params):
    """Predictor(scene_image=...) and a per-call scene_image, against the
    JAX Predictor's forecasts at the same latent draws."""
    cfg = _img_cfg()
    img, other = _raster(cfg, 2, seed=2)
    j_pred = JPredictor(params=jax_params, cfg=cfg, max_windows=2,
                        scene_image=img)
    t_pred = Predictor(from_jax(jax_params), cfg, device="cpu",
                       max_windows=2, scene_image=img)
    win = _window(cfg)
    key = jax.random.PRNGKey(9)
    eps = _latent(cfg, key, 2 * cfg.max_num_obj)
    outs = []
    for override in (None, other):
        ref = j_pred.predict(*win, scale=100.0, key=key,
                             scene_image=override)
        got = t_pred.predict(*win, scale=100.0, eps=eps,
                             scene_image=override)
        for name, atol in (("traj", 2e-2), ("best", 2e-2), ("scores", 2e-4)):
            np.testing.assert_allclose(got[name], ref[name], rtol=2e-4,
                                       atol=atol, err_msg=name)
        outs.append(got["scores"])
    assert not np.allclose(outs[0], outs[1], rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="scene_image"):
        t_pred.predict(*win, scene_image=img[:4])
