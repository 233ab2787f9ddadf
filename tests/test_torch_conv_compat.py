"""The port's deconv mask decoder (vae_dec='conv'), its reference facade
(``desire_tpu_torch.compat.DESIREModel``) and its toy example
(``desire_tpu_torch.examples.toy_gaussian``) against the JAX package on the
CPU.

Tolerances: float32 on both sides. ``deconv2d`` within 1e-5 of its
output's peak (one convolution, other summation orders); the conv model's
forward, loss and gradients within tests/test_torch_train.py's (2e-4 on
values, 2e-3 on gradients: the JAX kernel suite's); ``remat`` on against
off exactly (the same arithmetic, recomputed); the facade's loss within
2e-4 and its forecasts within 2e-4 relative, 2e-3 px; the toy example's
losses, params and RMSProp state within 1e-5 relative.
"""

import argparse
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from desire_tpu import compat as jcompat
from desire_tpu.config import DesireConfig as JConfig
from desire_tpu.models import desire as jdesire
from desire_tpu.models import layers as JL
from desire_tpu.models import sgm as jsgm
from desire_tpu_torch import compat
from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.models import desire as tdesire
from desire_tpu_torch.models import layers as TL
from desire_tpu_torch.models import sgm as tsgm
from desire_tpu_torch.params import from_jax, init_desire, to_numpy
from desire_tpu_torch.train import state as tstate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _jtree(tree):
    """A tree of tensors or numpy arrays as JAX arrays."""
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(to_numpy(x) if torch.is_tensor(x) else x),
        tree)


# -- deconv2d and the conv decoder ----------------------------------------------

# the four layers of the deconv stack: (input side, kernel, Cin, Cout,
# stride, padding), latent 8 in
_DECONVS = [(1, 4, 8, 128, 1, "VALID"), (4, 5, 128, 64, 1, "VALID"),
            (8, 5, 64, 32, 2, "SAME"), (16, 5, 32, 1, 2, "SAME")]


@pytest.mark.parametrize("side,k,cin,cout,stride,padding", _DECONVS)
def test_deconv2d_matches_jax(side, k, cin, cout, stride, padding):
    """jax.lax.conv_transpose's unflipped kernel and its padding (SAME,
    k 5, s 2 pads the dilated input (3, 2)), at the stack's geometries."""
    rng = np.random.default_rng(side)
    x = rng.standard_normal((3, side, side, cin)).astype(np.float32)
    p = {"w": rng.standard_normal((k, k, cin, cout)).astype(np.float32),
         "b": rng.standard_normal(cout).astype(np.float32)}
    ref = np.asarray(JL.deconv2d(jax.tree_util.tree_map(jnp.asarray, p),
                                 jnp.asarray(x), stride=stride,
                                 padding=padding))
    got = TL.deconv2d({n: _t(v) for n, v in p.items()}, _t(x),
                      stride=stride, padding=padding).numpy()
    out = side * stride if padding == "SAME" else (side - 1) * stride + k
    assert got.shape == ref.shape == (3, out, out, cout)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _cfg(**kw):
    """tests/test_torch_train.py's toy model with the deconv decoder
    (rnn_size 512: the VAE side 32, the reference's own geometry)."""
    base = dict(batch_size=2, max_num_obj=4, obs_len=4, pred_len=3,
                num_samples=4, d_dim=16, latent_size=8, embedding_size=8,
                channel_multiplier=10, scene_grid=8, scene_channels=4,
                num_refine=2, compute_dtype="float32", rnn_size=512,
                vae_dec="conv", variety_k=3)
    base.update(kw)
    return DesireConfig(**base)


@pytest.fixture(scope="module")
def conv_params():
    """The port's init of the conv model, the zero-init heads made
    non-zero, as numpy."""
    p = to_numpy(init_desire(_cfg(), torch.Generator().manual_seed(0),
                             "cpu"))
    assert "vdec1" in p["sgm"] and "vdec_fc1" not in p["sgm"]
    rng = np.random.default_rng(1)
    for sub, name in (("sgm", "prior"), ("sgm", "ztemp_fc2"),
                      ("ioc", "delta"), ("ioc", "gate")):
        w = p[sub][name]["w"]
        p[sub][name]["w"] = (0.3 * rng.standard_normal(w.shape)).astype(
            np.float32)
    return p


def _batch(cfg, b=None, seed=0):
    b = b or cfg.batch_size
    a, t = cfg.max_num_obj, cfg.total_len
    rng = np.random.default_rng(seed)
    xy = (rng.uniform(size=(b, t, a, 2)) * 0.5 + 0.25).astype(np.float32)
    mask = np.ones((b, t, a), np.float32)
    mask[:, :, -1] = 0.0
    mask[0, 0, 0] = 0.0
    mask[1, cfg.obs_len:, 1] = 0.0
    ids = np.tile(np.arange(1, a + 1), (b, 1)).astype(np.float32)
    ids[:, -1] = 0.0
    return xy, mask, ids


def test_conv_decoder_matches_jax(conv_params):
    cfg = _cfg()
    z = np.random.default_rng(2).standard_normal((6, 8)).astype(np.float32)
    ref = jsgm.vae_decode_mask(_jtree(conv_params["sgm"]), jnp.asarray(z),
                               32)
    got = tsgm.vae_decode_mask(from_jax(conv_params["sgm"]), _t(z),
                               cfg.vae_side)
    for name, g, r in zip(("beta", "recon"), got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_conv_sgm_forward_matches_jax(conv_params, train):
    """The SGM with the deconv decoder, inference (the layer-by-layer
    sampler: the fused one needs the MLP decoder) and training (the
    recognition network, the prior lanes, dropout), draws pinned."""
    cfg = _cfg()
    xy, mask, _ = _batch(cfg)
    obs, fut, om, fm = jdesire.split_batch(cfg, jnp.asarray(xy),
                                           jnp.asarray(mask))
    n = xy.shape[0] * xy.shape[2]
    rows = [x.reshape(n, *x.shape[2:]) for x in (obs, om, fut, fm)]
    key = jax.random.PRNGKey(4)
    ref = jax.jit(lambda p, *r: jsgm.sgm_forward(
        p, cfg, r[0], r[1], r[2] if train else None,
        r[3] if train else None, key=key, train=train))(
            _jtree(conv_params["sgm"]), *rows)
    k_eps, kdx, kdy = jax.random.split(key, 3)
    kw = dict(eps=_t(jax.random.normal(k_eps, (n, cfg.num_samples,
                                               cfg.latent_size))))
    if train:
        kw.update(
            keep_x=_t(jax.random.bernoulli(
                kdx, cfg.keep_prob, (n, cfg.obs_len, cfg.embedding_size))),
            keep_y=_t(jax.random.bernoulli(
                kdy, cfg.keep_prob, (n, cfg.pred_len, cfg.embedding_size))))
    got = tsgm.sgm_forward(
        from_jax(conv_params["sgm"]), cfg, _t(rows[0]), _t(rows[1]),
        _t(rows[2]) if train else None, _t(rows[3]) if train else None,
        train=train, **kw)
    names = ["raw5", "dec_h", "zp_mu", "zp_logvar", "hx"]
    names += ["z_mu", "z_logvar"] if train else []
    for name in names:
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   np.asarray(ref[name]), err_msg=name,
                                   **TOL)


def test_conv_desire_forward_matches_jax(conv_params):
    """The serving forward of a conv model: the layer-by-layer sampler
    and the fused IOC (its plain version on the CPU), eps pinned."""
    cfg = _cfg()
    xy, mask, ids = _batch(cfg)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, *bt: jdesire.desire_forward(
        p, cfg, *bt, key=key, train=False))(
            _jtree(conv_params), *map(jnp.asarray, (xy, mask, ids)))
    eps = jax.random.normal(jax.random.split(key, 3)[0],
                            (xy.shape[0] * xy.shape[2], cfg.num_samples,
                             cfg.latent_size))
    got = tdesire.desire_forward(from_jax(conv_params), cfg,
                                 *map(_t, (xy, mask, ids)), eps=_t(eps))
    for name in ("raw5", "sgm_traj", "refined_traj", "zp_mu", "zp_logvar"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), rtol=2e-4,
                               atol=2e-4)


def _loss_noise(cfg, key, b, a):
    """The draws of JAX desire_loss(key=key) (tests/test_torch_train.py)."""
    key, k_lanes = jax.random.split(key)
    k_eps, kdx, kdy = jax.random.split(key, 3)
    n, k = b * a, cfg.num_samples
    to = cfg.obs_len if cfg.protocol == "paper" else cfg.seq_length
    tf = cfg.total_len - to if cfg.protocol == "paper" else 1
    return {k_: _t(v) for k_, v in {
        "eps": jax.random.normal(k_eps, (n, k, cfg.latent_size)),
        "keep_x": jax.random.bernoulli(kdx, cfg.keep_prob,
                                       (n, to, cfg.embedding_size)),
        "keep_y": jax.random.bernoulli(kdy, cfg.keep_prob,
                                       (n, tf, cfg.embedding_size)),
        "lane_u": jax.random.uniform(k_lanes, (b, a, k))}.items()}


def _port_loss(params, cfg, batch, noise):
    tp = from_jax(params)
    leaves = tstate.tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    total, metrics = tdesire.desire_loss(tp, cfg, *map(_t, batch), step=7,
                                         noise=noise)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return total, metrics, [np.zeros(x.shape, np.float32) if g is None
                            else g.numpy() for g, x in zip(grads, leaves)]


def test_conv_desire_loss_matches_jax(conv_params):
    """The total, every metric and every parameter gradient of a conv
    model's training loss (through the deconv decoder's backward), the
    JAX draws pinned."""
    cfg = _cfg()
    batch = _batch(cfg)
    key = jax.random.PRNGKey(3)
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, *bt: jdesire.desire_loss(p, cfg, *bt, key=key, step=7),
        has_aux=True))(_jtree(conv_params), *map(jnp.asarray, batch))
    noise = _loss_noise(cfg, key, batch[0].shape[0], batch[0].shape[2])
    t_total, t_metrics, t_grads = _port_loss(conv_params, cfg, batch, noise)
    np.testing.assert_allclose(float(t_total.detach()), float(total), **TOL)
    assert set(t_metrics) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(t_metrics[k].detach()),
                                   float(metrics[k]), err_msg=k, **TOL)
    ref = jax.tree_util.tree_leaves_with_path(grads)
    assert len(ref) == len(t_grads)
    for (kp, r), g in zip(ref, t_grads):
        np.testing.assert_allclose(g, np.asarray(r), err_msg=str(kp),
                                   **GRAD_TOL)


@pytest.mark.parametrize("fused_train", [True, False])
def test_conv_remat_equals_no_remat(conv_params, fused_train):
    """remat recomputes the deconv stack (and, layer by layer, the IOC
    passes) in the backward: the same loss and gradients, bit for bit."""
    cfg = _cfg(fused_train=fused_train)
    batch = _batch(cfg)
    noise = _loss_noise(cfg, jax.random.PRNGKey(3), batch[0].shape[0],
                        batch[0].shape[2])
    off = _port_loss(conv_params, cfg, batch, noise)
    on = _port_loss(conv_params, cfg.replace(remat=True), batch, noise)
    assert float(on[0].detach()) == float(off[0].detach())
    for a, b in zip(on[2], off[2]):
        np.testing.assert_array_equal(a, b)


def test_conv_checkpoint_serves(conv_params, tmp_path):
    """A conv model trained one step by make_train_step, checkpointed, and
    served by Predictor.from_checkpoint: the geometry (vae_dec included)
    comes from the saved config over a default float32 one, and its
    forecasts are those of Predictor on the same params and seed."""
    from desire_tpu_torch.data.loader import LoaderState
    from desire_tpu_torch.serve import Predictor
    from desire_tpu_torch.train import checkpoint as ckpt
    from desire_tpu_torch.train.trainer import make_train_step
    cfg = _cfg(max_num_obj=5)
    st = tstate.create_train_state(cfg, from_jax(conv_params))
    st, met = make_train_step(cfg, 10)(st, *map(_t, _batch(cfg)))
    assert np.isfinite(float(met["loss"]))
    ckpt.CheckpointManager(str(tmp_path)).save(st, LoaderState(), cfg)
    pred = Predictor.from_checkpoint(
        str(tmp_path), device="cpu", k_samples=cfg.num_samples,
        max_windows=2, seed=3, cfg=DesireConfig(compute_dtype="float32"))
    assert pred.cfg.vae_dec == "conv" and pred.cfg.rnn_size == 512
    ref = Predictor(st.params, cfg, device="cpu", max_windows=2, seed=3)
    rng = np.random.default_rng(4)
    t = np.arange(cfg.obs_len, dtype=np.float32)
    obs = (rng.uniform(20, 60, (3, 1, 2)) + rng.uniform(-2, 2, (3, 1, 2))
           * t[None, :, None]).astype(np.float32)
    args = (obs, np.ones((3, cfg.obs_len), np.float32), np.arange(1, 4))
    got, want = pred.predict(*args, scale=100.0), ref.predict(*args,
                                                             scale=100.0)
    assert got["traj"].shape == (3, cfg.num_samples, cfg.pred_len, 2)
    for key in ("traj", "scores", "best"):
        np.testing.assert_array_equal(got[key], want[key])


# -- the reference facade -------------------------------------------------------

def _reference_args(**kw):
    """tests/test_compat.py's: the reference's 19 flags with its defaults,
    tiny widths."""
    ns = argparse.Namespace(
        rnn_size=512, num_layers=1, model="gru", batch_size=2, seq_length=6,
        num_epochs=1, save_every=400, grad_clip=10.0, learning_rate=1e-3,
        decay_rate=0.95, keep_prob=0.8, embedding_size=8,
        neighborhood_size=32, grid_size=4, max_num_obj=5, leave_dataset=5,
        latent_size=8, e_dim=256, d_dim=16, stride=1)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _traj(rng, t, a):
    """(T, A, 3) reference layout, column 0 the id (0: an empty slot)."""
    out = np.zeros((t, a, 3), np.float32)
    for i in range(a - 1):
        v = rng.uniform(-1, 1, 2)
        p0 = rng.uniform(10, 50, 2)
        out[:, i, 0] = i + 1
        out[:, i, 1:3] = p0 + np.arange(t)[:, None] * v
    return out


@pytest.fixture(scope="module")
def model():
    return compat.DESIREModel(_reference_args(), device="cpu")


def test_constructor_accepts_reference_args():
    """tests/test_compat.py:47, and the facade's device rule."""
    m = compat.DESIREModel(_reference_args(), device="cpu")
    assert m.cfg.protocol == "compat"
    assert (m.cfg.seq_length, m.cfg.obs_len, m.cfg.pred_len) == (6, 6, 6)
    assert m.cfg.max_num_obj == 5 and not m.cfg.normalize
    with pytest.raises(AttributeError, match="train_step"):
        m.cost


def test_cfg_from_args_matches_jax():
    """The same config as the JAX facade's, with and without a protocol."""
    for args in (_reference_args(), _reference_args(protocol="paper")):
        got = compat._cfg_from_args(args)
        want = jcompat._cfg_from_args(args)
        assert got.to_json() == want.to_json()


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        compat.DESIREModel(_reference_args())


def test_train_step_reference_layout(model):
    rng = np.random.RandomState(0)
    full = _traj(rng, 7, 5)
    x, y = full[:6], full[1:7]
    l1 = model.train_step(x, y)
    l2 = model.train_step(x, y)
    assert np.isfinite(l1) and np.isfinite(l2)
    assert model._state.step == 2


def test_sample_reference_signature(model):
    rng = np.random.RandomState(1)
    traj = _traj(rng, 6, 5)
    out = model.sample(None, traj, grid=None, dimensions=(100, 100), num=4)
    assert out.shape == (10, 5, 3)
    np.testing.assert_array_equal(out[:6], traj)
    np.testing.assert_array_equal(
        out[6:, :, 0], np.broadcast_to(traj[0, :, 0], (4, 5)))
    assert np.isfinite(out).all()
    live = traj[0, :, 0] > 0
    jump = np.linalg.norm(out[6, live, 1:3] - traj[-1, live, 1:3], axis=-1)
    spread = np.linalg.norm(traj[-1, live, 1:3] - traj[0, live, 1:3],
                            axis=-1)
    assert (jump < np.maximum(spread, 5.0) * 3).all()


def test_sample_late_appearing_agent(model):
    """tests/test_compat.py:88: a slot occupied only from frame 2 keeps its
    id and gets forecasts."""
    rng = np.random.RandomState(3)
    traj = _traj(rng, 6, 5)
    late = 3
    traj[:2, late, :] = 0.0
    traj[2:, late, 0] = late + 1
    out = model.sample(None, traj, num=4)
    np.testing.assert_array_equal(out[6:, late, 0], np.full(4, late + 1))
    assert np.isfinite(out[6:, late, 1:3]).all()
    assert np.abs(out[6:, late, 1:3]).sum() > 0
    assert np.linalg.norm(out[6, late, 1:3] - traj[-1, late, 1:3]) < 50.0


@pytest.mark.parametrize("obs,num", [(4, 3), (9, 8)])
def test_sample_arbitrary_obs_length(model, obs, num):
    """tests/test_compat.py:109: obs lengths other than seq_length (padded
    or trimmed to its window), and num beyond one chunk."""
    rng = np.random.RandomState(2)
    traj = _traj(rng, obs, 5)
    out = model.sample(None, traj, num=num)
    assert out.shape == (obs + num, 5, 3)
    np.testing.assert_array_equal(out[:obs], traj)
    assert np.isfinite(out).all()


def _rollout_eps(cfg, key, rows, chunks):
    """The latent draws of JAX make_rollout(key)'s chunks (each chunk's
    sampler takes split(key)[1]; its forward split(.)[0], split(., 3)[0])."""
    out = []
    for _ in range(chunks):
        key, sub = jax.random.split(key)
        k1, _ = jax.random.split(sub)
        out.append(_t(jax.random.normal(jax.random.split(k1, 3)[0],
                                        (rows, cfg.num_samples,
                                         cfg.latent_size))))
    return out


def test_facade_matches_jax(monkeypatch):
    """The port's DESIREModel against the JAX facade from the same params
    (converted; the JAX init would take ~10 s op by op), in float32: one
    train_step's loss with the JAX step's draws pinned, then one sample of
    4 frames from the updated params with the JAX rollout's draws
    pinned."""
    from desire_tpu_torch.eval.sampler import make_rollout
    args = _reference_args(compute_dtype="float32")
    tm = compat.DESIREModel(args, device="cpu")
    monkeypatch.setattr(jcompat, "init_desire",
                        lambda key, cfg: _jtree(tm.params))
    jm = jcompat.DESIREModel(args)
    cfg = tm.cfg
    rng = np.random.RandomState(0)
    full = _traj(rng, 7, 5)
    _, sub = jax.random.split(jm._state.key)
    noise = _loss_noise(cfg, sub, 1, 5)
    step = tm._step_fn
    tm._step_fn = lambda st, *bt: step(st, *bt, noise=noise)
    got, want = tm.train_step(full[:6], full[1:]), jm.train_step(full[:6],
                                                                 full[1:])
    np.testing.assert_allclose(got, want, **TOL)

    # sample from the stepped params: rebind the JAX facade to the port's
    # (Adam's first step may flip a noise-level gradient's sign)
    jm.params = _jtree(tm.params)
    traj = _traj(np.random.RandomState(1), 6, 5)
    _, key = jax.random.split(jm._key)
    rcfg = cfg.replace(protocol="paper", obs_len=6, pred_len=6, subsample=1)
    rollout = make_rollout(rcfg, k_samples=cfg.num_samples)
    eps = _rollout_eps(cfg, key, 5, 1)
    tm._samplers[6] = lambda *a, **kw: rollout(*a, **dict(kw, eps=eps))
    got = tm.sample(None, traj, dimensions=(100, 100), num=4)
    want = jm.sample(None, traj, dimensions=(100, 100), num=4)
    np.testing.assert_array_equal(got[:6], want[:6])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


# -- the toy example ----------------------------------------------------------------

def _toy_tree(root):
    """Two videos of 6 agents on straight lines, 3000 frames: 3 batches of
    32 windows at the example's geometry."""
    for i in range(2):
        rng = np.random.RandomState(i)
        recs = []
        for aid in range(1, 7):
            v, p0 = rng.uniform(-0.2, 0.2, 2), rng.uniform(100, 800, 2)
            recs += [(f, aid, *(p0 + v * f)) for f in range(3000)]
        path = os.path.join(str(root), f"scene/video{i}/"
                                       "annotations_processed.csv")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            for row in np.asarray(recs, np.float64).T:
                f.write(",".join(f"{x:g}" for x in row) + "\n")
    return str(root)


def test_toy_example_matches_jax(tmp_path, monkeypatch, capsys):
    """5 steps of the port's example on a toy SDD tree against the JAX
    example's step (optax.rmsprop(1e-3), the masked NLL) from the same
    params over the JAX loader's batches: every loss, the params and the
    RMSProp state; and the JAX script itself, from those params, prints
    the same final NLL."""
    from desire_tpu.data.loader import SDDLoader as JLoader
    from desire_tpu.models import losses as jlosses
    from desire_tpu_torch.data.loader import SDDLoader
    from desire_tpu_torch.examples import toy_gaussian as tg
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", str(tmp_path / "tc"))
    monkeypatch.setenv("DESIRE_CACHE_DIR", str(tmp_path / "jc"))
    data = _toy_tree(tmp_path / "data")
    steps = 5
    loader = SDDLoader(tg.toy_config(data))
    assert loader.num_batches >= 2
    params, nu, losses = tg.train(loader, steps, "cpu", log=lambda s: None)

    jp = _jtree(tg.init_params("cpu"))
    tx = optax.rmsprop(1e-3)
    opt = tx.init(jp)

    @jax.jit
    def jstep(p, opt, xy, mask, ids):
        def loss_fn(p):
            cur, nxt = xy[:, -2], xy[:, -1]
            m = mask[:, -2] * mask[:, -1] * (ids > 0)
            nll = jlosses.bivariate_nll(JL.dense(p["head"], cur), nxt - cur)
            return jlosses.masked_mean(nll, m)
        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, opt = tx.update(g, opt)
        return optax.apply_updates(p, upd), opt, loss

    jloader = JLoader(JConfig(**{f: getattr(tg.toy_config(data), f) for f in
                                 ("batch_size", "max_num_obj", "obs_len",
                                  "pred_len", "data_dir", "scenes",
                                  "window_hop")}))
    ref, it = [], None
    for i in range(steps):
        if it is None:
            it = jloader.epoch_batches(i // max(jloader.num_batches, 1))
        try:
            b = next(it)
        except StopIteration:
            it = None
            continue
        jp, opt, loss = jstep(jp, opt, jnp.asarray(b.xy), jnp.asarray(b.mask),
                              jnp.asarray(b.ids, jnp.float32))
        ref.append(float(loss))
    np.testing.assert_allclose([float(x) for x in losses], ref, rtol=1e-5)
    for name in ("w", "b"):
        np.testing.assert_allclose(params["head"][name].numpy(),
                                   np.asarray(jp["head"][name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(nu["head"][name].numpy(),
                                   np.asarray(opt[0].nu["head"][name]),
                                   rtol=1e-5, atol=1e-12, err_msg=name)

    # the JAX script, its init swapped for the port's params
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import toy_gaussian as jtg
        monkeypatch.setattr(jtg.L, "init_dense",
                            lambda key, i, o: _jtree(
                                tg.init_params("cpu"))["head"])
        capsys.readouterr()
        jtg.main(["--data_dir", data, "--steps", str(steps)])
    finally:
        sys.path.remove(os.path.join(ROOT, "examples"))
    last = capsys.readouterr().out.strip().splitlines()[-1]
    np.testing.assert_allclose(float(last.split(":")[1]), float(losses[-1]),
                               rtol=1e-5)


def test_toy_example_entry_point(tmp_path, monkeypatch):
    """python -m desire_tpu_torch.examples.toy_gaussian --device cpu: the
    JAX script's output lines; --device cuda raises without a card."""
    data = _toy_tree(tmp_path / "data")
    env = dict(os.environ, DESIRE_TORCH_CACHE_DIR=str(tmp_path / "tc"),
               PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "desire_tpu_torch.examples.toy_gaussian",
         "--data_dir", data, "--steps", "3", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("step    0  nll")
    assert lines[-1].startswith("final nll:")
    assert np.isfinite(float(lines[-1].split(":")[1]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from desire_tpu_torch.examples import toy_gaussian as tg
    with pytest.raises(RuntimeError, match="CUDA device"):
        tg.main(["--data_dir", data, "--steps", "1"])
