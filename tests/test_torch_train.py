"""Port parity of the training slice against the JAX package on the CPU
(f32, toy sizes, the same parameters and the same random draws): the SGM
training branch, desire_loss (total, metrics and every parameter
gradient), the optimizer against optax, one whole training step, and the
epoch loop."""

import ctypes
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from desire_tpu.config import DesireConfig
from desire_tpu.data.loader import SDDLoader as JaxSDDLoader
from desire_tpu.models import desire as jdesire
from desire_tpu.models import sgm as jsgm
from desire_tpu.train import state as jstate
from desire_tpu.train import trainer as jtrainer
from desire_tpu_torch.data.loader import SDDLoader
from desire_tpu_torch.models import desire as tdesire
from desire_tpu_torch.models import sgm as tsgm
from desire_tpu_torch.params import from_jax, init_desire, to_numpy
from desire_tpu_torch.train import state as tstate
from desire_tpu_torch.train import trainer as ttrainer

# f32 on both sides: values differ only in the order of float32 sums
TOL = dict(rtol=2e-4, atol=2e-5)
# gradients through the whole model: the JAX kernel suite's gradient
# tolerances (tests/test_kernels.py)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _cfg(**kw):
    """A toy model with every training term on: dropout (keep_prob 0.8),
    the variety subset (variety_k 3 < K 5), prior lanes, the conditional
    prior, the learned temperature, speed-balanced weights, KLD warm-up."""
    base = dict(batch_size=2, max_num_obj=4, obs_len=4, pred_len=3,
                num_samples=5, d_dim=16, latent_size=8, embedding_size=8,
                channel_multiplier=10, scene_grid=8, scene_channels=4,
                num_refine=2, compute_dtype="float32", rnn_size=128,
                variety_k=3)
    base.update(kw)
    return DesireConfig(**base)


@pytest.fixture(scope="module")
def jax_params():
    """One parameter tree for every case of this file, drawn by the port's
    init (tests/test_torch_params.py holds its tree to the JAX init's),
    with the zero-init heads made non-zero so that no branch is trivially
    zero."""
    p = to_numpy(init_desire(_cfg(), torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(1)
    for sub, name in (("sgm", "prior"), ("sgm", "ztemp_fc2"),
                      ("ioc", "delta"), ("ioc", "gate")):
        w = p[sub][name]["w"]
        p[sub][name]["w"] = (0.3 * rng.standard_normal(w.shape)).astype(
            np.float32)
    return jax.tree_util.tree_map(jnp.asarray, p)


def _batch(cfg, seed=0):
    """xy (B, T, A, 2), mask, ids: the last agent dead, one observed step
    of agent 0 masked, one agent without a future."""
    b, a, t = cfg.batch_size, cfg.max_num_obj, cfg.total_len
    rng = np.random.default_rng(seed)
    xy = (rng.uniform(size=(b, t, a, 2)) * 0.5 + 0.25).astype(np.float32)
    mask = np.ones((b, t, a), np.float32)
    mask[:, :, -1] = 0.0
    mask[0, 0, 0] = 0.0
    mask[1, cfg.obs_len:, 1] = 0.0
    ids = np.tile(np.arange(1, a + 1), (b, 1)).astype(np.float32)
    ids[:, -1] = 0.0
    return xy, mask, ids


def _loss_noise(cfg, key, b, a):
    """The random draws of the JAX desire_loss(key=key), as numpy: latent
    noise, dropout keep-masks of both encoders, variety-subset uniforms."""
    key, k_lanes = jax.random.split(key)
    k_eps, kdx, kdy = jax.random.split(key, 3)
    n, k = b * a, cfg.num_samples
    return {"eps": jax.random.normal(k_eps, (n, k, cfg.latent_size)),
            "keep_x": jax.random.bernoulli(
                kdx, cfg.keep_prob, (n, cfg.obs_len, cfg.embedding_size)),
            "keep_y": jax.random.bernoulli(
                kdy, cfg.keep_prob, (n, cfg.pred_len, cfg.embedding_size)),
            "lane_u": jax.random.uniform(k_lanes, (b, a, k))}


def _torch(x):
    return torch.from_numpy(np.array(x, np.float32))


def _grad_leaves(jp):
    """The port's params as leaves that require grad, in JAX order."""
    tp = from_jax(jp)
    leaves = tstate.tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    return tp, leaves


def test_sgm_train_branch_matches_jax(jax_params):
    cfg = _cfg()
    xy, mask, _ = _batch(cfg)
    obs, fut, om, fm = jdesire.split_batch(cfg, jnp.asarray(xy),
                                           jnp.asarray(mask))
    n = xy.shape[0] * xy.shape[2]
    rows = [x.reshape(n, *x.shape[2:]) for x in (obs, om, fut, fm)]
    key = jax.random.PRNGKey(4)
    ref = jax.jit(lambda p, *r: jsgm.sgm_forward(
        p, cfg, r[0], r[1], r[2], r[3], key=key, train=True))(
            jax_params["sgm"], *rows)
    k_eps, kdx, kdy = jax.random.split(key, 3)
    got = tsgm.sgm_forward(
        from_jax(jax_params["sgm"]), cfg, *map(_torch, rows), train=True,
        eps=_torch(jax.random.normal(k_eps, (n, cfg.num_samples,
                                             cfg.latent_size))),
        keep_x=_torch(jax.random.bernoulli(
            kdx, cfg.keep_prob, (n, cfg.obs_len, cfg.embedding_size))),
        keep_y=_torch(jax.random.bernoulli(
            kdy, cfg.keep_prob, (n, cfg.pred_len, cfg.embedding_size))))
    for name in ("raw5", "dec_h", "z_mu", "z_logvar", "zp_mu", "zp_logvar",
                 "hx"):
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   np.asarray(ref[name]), err_msg=name,
                                   **TOL)


@functools.cache
def _jax_loss(variant):
    cfg = _cfg(**dict(variant))
    return cfg, jax.jit(jax.value_and_grad(
        lambda p, xy, m, ids, key, step: jdesire.desire_loss(
            p, cfg, xy, m, ids, key=key, step=step), has_aux=True))


@pytest.mark.parametrize("variant", [(), (("use_pallas", False),),
                                     (("recon_agg", "mean"),
                                      ("social_freeze", True)),
                                     (("fused_train", False),),
                                     (("use_social", False),),
                                     (("fused_train", False),
                                      ("remat", True))])
def test_desire_loss_matches_jax(variant, jax_params):
    """The total, every metric and every parameter gradient. The default
    config takes the port's trainable fused IOC (its plain version on the
    CPU); use_pallas=False, fused_train=False and use_social=False the
    layer-by-layer ioc_forward, the last two through the scene-pool op
    (its plain version on the CPU); remat recomputes its passes and the
    mask decoder in the backward."""
    cfg, fn = _jax_loss(variant)
    xy, mask, ids = _batch(cfg)
    key = jax.random.PRNGKey(3)
    (total, metrics), grads = fn(jax_params, *map(jnp.asarray, (xy, mask,
                                                                 ids)),
                                 key, jnp.asarray(7))
    noise = {k: _torch(v) for k, v in
             _loss_noise(cfg, key, xy.shape[0], xy.shape[2]).items()}
    tp, leaves = _grad_leaves(jax_params)
    t_total, t_metrics = tdesire.desire_loss(
        tp, cfg, *map(_torch, (xy, mask, ids)), step=7, noise=noise)
    np.testing.assert_allclose(float(t_total.detach()), float(total),
                               **TOL)
    assert set(t_metrics) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(t_metrics[k].detach()),
                                   float(metrics[k]), err_msg=k, **TOL)
    got = torch.autograd.grad(t_total, leaves, allow_unused=True)
    ref = jax.tree_util.tree_leaves_with_path(grads)
    assert len(got) == len(ref)
    for (kp, r), g in zip(ref, got):
        g = np.zeros(r.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(r), err_msg=str(kp),
                                   **GRAD_TOL)


@pytest.mark.parametrize("clip", [True, False])
def test_optimizer_matches_optax(clip):
    """Three updates with steps_per_epoch=2 (the rate decays between the
    second and third), with the global-norm clip active or not."""
    cfg = _cfg(grad_clip=0.5 if clip else 1e3, learning_rate=1e-2,
               decay_rate=0.5)
    rng = np.random.default_rng(2)
    params = {"a": {"w": rng.standard_normal((3, 4)), "b": np.zeros(4)},
              "gru": [{"wi": rng.standard_normal((2, 6))}],
              "s": np.asarray(0.3)}
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params)
    tx = jstate.make_optimizer(cfg, steps_per_epoch=2)
    j_p, j_s = params, tx.init(params)
    t_st = tstate.create_train_state(cfg, from_jax(params))
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda x: np.asarray(rng.standard_normal(x.shape) * 2.0,
                                 np.float32), params)
        norm = float(optax.global_norm(g))
        assert (norm >= cfg.grad_clip) == clip
        upd, j_s = tx.update(g, j_s, j_p)
        j_p = optax.apply_updates(j_p, upd)
        p, mu, nu, count = tstate.apply_updates(cfg, 2, t_st, from_jax(g))
        t_st = tstate.TrainState(t_st.step + 1, p, mu, nu, count,
                                 t_st.generator)
        for r, x in zip(jax.tree_util.tree_leaves(j_p),
                        tstate.tree_leaves(t_st.params)):
            np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-7)


def _adam_moments(opt_state):
    """(mu, nu) of the Adam state inside an optax chain's state."""
    adam = optax.ScaleByAdamState
    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, adam)):
        if isinstance(s, adam):
            return s.mu, s.nu
    raise AssertionError("no ScaleByAdamState in the optimizer state")


def test_optimizer_matches_optax_on_a_nan_norm():
    """A gradient with one NaN element makes the global norm NaN: optax's
    clip selects on |g| < max_norm, so every leaf is rescaled to NaN. The
    port's params, mu and nu hold NaN in the same places, and finite values
    equal to optax's (one finite update first, then the NaN one)."""
    cfg = _cfg(grad_clip=0.5, learning_rate=1e-2, decay_rate=0.5)
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal(3).astype(np.float32),
              "b": rng.standard_normal(2).astype(np.float32)}
    tx = jstate.make_optimizer(cfg, steps_per_epoch=2)
    j_p, j_s = params, tx.init(params)
    t_st = tstate.create_train_state(cfg, from_jax(params))
    finite = {"a": np.asarray([0.1, -0.2, 0.05], np.float32),
              "b": np.asarray([0.3, 0.1], np.float32)}
    nan = {"a": np.asarray([np.nan, 1.0, 1.0], np.float32),
           "b": np.asarray([1.0, 1.0], np.float32)}
    for g in (finite, nan):
        upd, j_s = tx.update(g, j_s, j_p)
        j_p = optax.apply_updates(j_p, upd)
        p, mu, nu, count = tstate.apply_updates(cfg, 2, t_st, from_jax(g))
        t_st = tstate.TrainState(t_st.step + 1, p, mu, nu, count,
                                 t_st.generator)
        j_mu, j_nu = _adam_moments(j_s)
        for ref, got in ((j_p, t_st.params), (j_mu, t_st.mu),
                         (j_nu, t_st.nu)):
            for r, x in zip(jax.tree_util.tree_leaves(ref),
                            tstate.tree_leaves(got)):
                np.testing.assert_allclose(x.numpy(), np.asarray(r),
                                           rtol=1e-6, atol=1e-7,
                                           equal_nan=True)
    assert np.isnan(t_st.params["b"].numpy()).all()


@pytest.mark.parametrize("clip", [True, False])
def test_apply_updates_with_a_given_norm(clip):
    """apply_updates(..., g_norm=global_norm(g)) is apply_updates without
    it, bit for bit, clipped or not."""
    cfg = _cfg(grad_clip=0.5 if clip else 1e3, learning_rate=1e-2)
    rng = np.random.default_rng(4)
    params = {"a": {"w": _torch(rng.standard_normal((3, 4)))},
              "l": [_torch(rng.standard_normal(5)), _torch(0.3)]}
    grads = tstate.tree_unflatten(params, [
        _torch(rng.standard_normal(x.shape) * 2.0)
        for x in tstate.tree_leaves(params)])
    st = tstate.create_train_state(cfg, params)
    norm = tstate.global_norm(tstate.tree_leaves(grads))
    assert (float(norm) >= cfg.grad_clip) == clip
    given = tstate.apply_updates(cfg, 2, st, grads, g_norm=norm)
    taken = tstate.apply_updates(cfg, 2, st, grads)
    assert given[3] == taken[3] == 1
    for a_tree, b_tree in zip(given[:3], taken[:3]):
        for x, y in zip(tstate.tree_leaves(a_tree),
                        tstate.tree_leaves(b_tree)):
            assert torch.equal(x, y)


def test_apply_updates_leaves_the_state_it_was_given():
    """An update on the plain path (CPU leaves) returns new trees in fresh
    memory and leaves the params, mu and nu of the state it was given bit
    for bit (a step that hands back its input state, and the graphed
    loss's copy-in, rely on it); the gradients as the tree or as its
    leaves give the same update."""
    cfg = _cfg(learning_rate=1e-2)
    rng = np.random.default_rng(8)
    params = {"a": {"w": _torch(rng.standard_normal((3, 4)))},
              "l": [_torch(rng.standard_normal(5)), _torch(0.3)]}

    def grads():
        return tstate.tree_unflatten(params, [
            _torch(rng.standard_normal(x.shape))
            for x in tstate.tree_leaves(params)])
    st = tstate.create_train_state(cfg, params)
    p, mu, nu, count = tstate.apply_updates(cfg, 2, st, grads())
    st = tstate.TrainState(1, p, mu, nu, count, st.generator)
    trees = lambda s: [tstate.tree_leaves(t) for t in (s.params, s.mu,
                                                        s.nu)]
    before = [[x.clone() for x in leaves] for leaves in trees(st)]
    g = grads()
    new = tstate.apply_updates(cfg, 2, st, g)
    again = tstate.apply_updates(cfg, 2, st, tstate.tree_leaves(g))
    assert new.flat is None and new[3] == again[3] == 2
    for old, kept, got, got2 in zip(before, trees(st), new[:3], again[:3]):
        got, got2 = tstate.tree_leaves(got), tstate.tree_leaves(got2)
        assert all(torch.equal(x, y) for x, y in zip(old, kept))
        assert all(torch.equal(x, y) for x, y in zip(got, got2))
        assert all(x.data_ptr() != y.data_ptr() for x, y in zip(kept, got))
        assert not any(torch.equal(x, y) for x, y in zip(kept, got))


class _AdamLibrary:
    """The kernel library's adam_layout by csrc/adam.cu's rule (each
    leaf's size rounded up to 4 values, blocks of 4096 values, 1 to 256
    leaves), counting its calls."""
    calls = 0

    @classmethod
    def adam_layout(cls, n, size, start):
        cls.calls += 1
        if n < 1 or n > 256:
            return -1
        sizes = np.ctypeslib.as_array(
            (ctypes.c_longlong * n).from_address(size))
        out = np.ctypeslib.as_array(
            (ctypes.c_longlong * (n + 1)).from_address(start))
        out[0] = 0
        out[1:] = np.cumsum((sizes + 3) // 4 * 4)
        return (int(out[n]) + 4095) // 4096


def test_flat_layout_puts_each_leaf_at_its_aligned_start(monkeypatch):
    """The optimizer's flat layout, made once a tree shape from the
    library's adam_layout: each leaf a view at its start in one buffer,
    16-byte aligned, the padding zero, the pointers the leaves'; the
    three trees of a state over three buffers; leaves of another dtype or
    shape, or more than 256 of them, refused."""
    from desire_tpu_torch.ops import _build, adam
    monkeypatch.setattr(_build, "library", _AdamLibrary)
    adam.layout.cache_clear()
    try:
        shapes = ((3, 4), (5,), (), (2, 3, 7), (4097,))
        calls = _AdamLibrary.calls
        lay = adam.layout(shapes)
        assert adam.layout(tuple(torch.Size(s) for s in shapes)) is lay
        assert _AdamLibrary.calls == calls + 1
        assert lay.starts == [0, 12, 20, 24, 68]
        assert (lay.total, lay.blocks) == (68 + 4100, 2)
        rng = np.random.default_rng(3)
        like = {"a": [_torch(rng.standard_normal(s)) for s in shapes[:2]],
                "b": {"c": _torch(rng.standard_normal(shapes[2])),
                      "d": [_torch(rng.standard_normal(s))
                            for s in shapes[3:]]}}
        leaves = tstate.tree_leaves(like)
        flat = adam.Flat(lay, *(lay.pack([k * x for x in leaves])
                                for k in (1.0, 2.0, 3.0)))
        trees = tstate._trees(like, flat)
        for k, buf, tree in zip((1.0, 2.0, 3.0), flat[1:], trees):
            views = tstate.tree_leaves(tree)
            assert [x.data_ptr() for x in views] == [
                buf.data_ptr() + 4 * s for s in lay.starts]
            assert list(lay.pointers(buf)) == [x.data_ptr() for x in views]
            assert all(x.data_ptr() % 16 == 0 for x in views)
            assert all(x.untyped_storage().data_ptr()
                       == buf.untyped_storage().data_ptr() for x in views)
            assert all(torch.equal(x, k * y) for x, y in zip(views, leaves))
            pad = torch.ones(lay.total, dtype=torch.bool)
            for s, x in zip(lay.starts, views):
                pad[s:s + x.numel()] = False
            assert pad.sum() == 3 + 3 + 2 + 3 and not buf[pad].any()
        with pytest.raises(ValueError, match="float32"):
            lay.pack([x.double() for x in leaves])
        with pytest.raises(ValueError, match="shapes"):
            lay.pack(leaves[::-1])
        with pytest.raises(ValueError, match="kMaxLeaves"):
            adam.layout(((1,),) * 257)
    finally:
        adam.layout.cache_clear()


def test_train_step_grad_norm_is_the_norm_the_clip_used(jax_params,
                                                        monkeypatch):
    """step_fn's metrics["grad_norm"] is the very norm apply_updates
    clipped with, taken once: with grad_clip far below the gradient's
    norm, Adam's first moment after one step is (1 - b1) * the clipped
    gradient, whose global norm is (1 - b1) * grad_clip."""
    cfg = _cfg(grad_clip=1e-3)
    seen = []
    apply = ttrainer.apply_updates

    def spy(*a, g_norm=None):
        seen.append(g_norm)
        return apply(*a, g_norm=g_norm)
    monkeypatch.setattr(ttrainer, "apply_updates", spy)
    xy, mask, ids = map(_torch, _batch(cfg, seed=6))
    state = tstate.create_train_state(cfg, from_jax(jax_params))
    new, metrics = ttrainer.make_train_step(cfg, 10)(state, xy, mask, ids)
    assert len(seen) == 1 and seen[0] is metrics["grad_norm"]
    assert float(metrics["grad_norm"]) > 100 * cfg.grad_clip
    mu_norm = float(tstate.global_norm(tstate.tree_leaves(new.mu)))
    np.testing.assert_allclose(mu_norm, (1.0 - tstate.B1) * cfg.grad_clip,
                               rtol=1e-5)


def test_train_step_matches_jax(jax_params):
    """One make_train_step step against the JAX step, on the same state and
    the JAX step's own random draws."""
    _check_train_step(_cfg(), jax_params)


def test_train_step_unfused_ioc_matches_jax(jax_params):
    """The same with fused_train=False: the layer-by-layer IOC and the
    scene-pool op under autograd."""
    _check_train_step(_cfg(fused_train=False), jax_params)


def _check_train_step(cfg, jax_params, batch=None):
    """batch: (xy, mask, ids, *img) numpy arrays, default _batch's."""
    xy, mask, ids, *img = batch if batch is not None else _batch(cfg, seed=5)
    # the JAX step donates its state: it gets a copy of the shared params
    j_state = jstate.create_train_state(
        cfg, jax.tree_util.tree_map(jnp.array, jax_params),
        steps_per_epoch=10, key=jax.random.PRNGKey(11))
    _, sub = jax.random.split(j_state.key)
    noise = {k: _torch(v) for k, v in
             _loss_noise(cfg, sub, xy.shape[0], xy.shape[2]).items()}
    j_new, j_metrics = jtrainer.make_train_step(cfg, 10)(
        j_state, *map(jnp.asarray, (xy, mask, ids, *img)))
    t_state = tstate.create_train_state(cfg, from_jax(jax_params))
    t_new, t_metrics = ttrainer.make_train_step(cfg, 10)(
        t_state, *map(_torch, (xy, mask, ids, *img)), noise=noise)
    assert t_new.step == int(j_new.step) == 1
    for k in j_metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]),
                                   err_msg=k, **TOL)
    # Adam's first moment is (1 - b1) g: the gradients agree to GRAD_TOL
    j_mu = jax.tree_util.tree_leaves_with_path(j_new.opt_state[1][0].mu)
    for (kp, r), x in zip(j_mu, tstate.tree_leaves(t_new.mu)):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=2e-3,
                                   atol=2e-5, err_msg=str(kp))
    # its first update is lr * g / (|g| + eps): the same lr-sized step
    # wherever the gradient is clear of float32 noise (|g| > 1e-4); a
    # gradient that is zero up to noise (a score bias under the
    # shift-invariant ranking loss) may point either way
    lr = cfg.learning_rate
    for (kp, r), x, m in zip(jax.tree_util.tree_leaves_with_path(
            j_new.params), tstate.tree_leaves(t_new.params), j_mu):
        r, x = np.asarray(r), x.numpy()
        clear = np.abs(np.asarray(m[1])) > 1e-5
        np.testing.assert_allclose(x[clear], r[clear], rtol=1e-5, atol=1e-6,
                                   err_msg=str(kp))
        assert np.all(np.abs(x - r) <= 2 * lr + 1e-6), kp


def _micro_dataset(root, frames=60):
    """One synthetic video of agents on straight lines (as
    tests/test_train.py builds it)."""
    rng = np.random.RandomState(0)
    path = os.path.join(str(root), "scene/video0/annotations_processed.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    recs = []
    for aid in range(1, 7):
        v, p0 = rng.uniform(-1.5, 1.5, 2), rng.uniform(20, 80, 2)
        recs += [(f, aid, *(p0 + v * f)) for f in range(frames)]
    with open(path, "w") as f:
        for row in np.asarray(recs, np.float64).T:
            f.write(",".join(f"{x:g}" for x in row) + "\n")
    return str(root)


def test_run_epoch_on_sdd_loader_batches(tmp_path, jax_params, monkeypatch):
    """The port's epoch loop over the port's SDDLoader's batches."""
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    cfg = _cfg(data_dir=_micro_dataset(tmp_path), subsample=2, window_hop=2,
               batch_size=2, max_num_obj=4, save_dir="")
    loader = SDDLoader(cfg, use_native=False)
    state = tstate.create_train_state(cfg, from_jax(jax_params))
    logged = []
    state, mean_loss = ttrainer.run_epoch(
        state, loader, 0, ttrainer.make_train_step(cfg, loader.num_batches),
        log_fn=lambda m, st: logged.append(m), log_every=1, max_batches=2)
    assert state.step == 2 and len(logged) == 2
    assert np.isfinite(mean_loss)
    assert all(np.isfinite(m["grad_norm"]) for m in logged)


def test_run_epoch_same_losses_on_both_loaders(tmp_path, jax_params,
                                                monkeypatch):
    """The port's epoch loop gives the same losses, bit for bit, over the
    JAX SDDLoader's batches as over the port's: the two loaders stay held
    together."""
    monkeypatch.setenv("DESIRE_CACHE_DIR", str(tmp_path / "jcache"))
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", str(tmp_path / "tcache"))
    cfg = _cfg(data_dir=_micro_dataset(tmp_path), subsample=2, window_hop=2,
               batch_size=2, max_num_obj=4, save_dir="")
    losses = []
    for loader in (JaxSDDLoader(cfg, use_native=False),
                   SDDLoader(cfg, use_native=False)):
        state = tstate.create_train_state(cfg, from_jax(jax_params))
        logged = []
        ttrainer.run_epoch(
            state, loader, 1,
            ttrainer.make_train_step(cfg, loader.num_batches),
            log_fn=lambda m, st: logged.append(m["loss"]), log_every=1,
            max_batches=2)
        losses.append(logged)
    assert len(losses[0]) == 2 and losses[0] == losses[1]


def test_run_epoch_stops_the_loader_at_max_batches(tmp_path, monkeypatch):
    """With max_batches, the loader's position (what a checkpoint records)
    is the batch after the last one trained, not one further."""
    monkeypatch.setenv("DESIRE_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    cfg = _cfg(data_dir=_micro_dataset(tmp_path), subsample=2, window_hop=2,
               batch_size=2, max_num_obj=4, save_dir="")
    loader = SDDLoader(cfg, use_native=False)
    assert loader.num_batches > 3

    def step_fn(state, xy, mask, ids):
        state = tstate.TrainState(state.step + 1, state.params, state.mu,
                                  state.nu, state.count, state.generator)
        return state, {"loss": torch.tensor(1.0)}

    st = tstate.create_train_state(cfg, {"w": torch.zeros(2)})
    st, _ = ttrainer.run_epoch(st, loader, 0, step_fn, start_batch=1,
                               max_batches=2)
    assert st.step == 2
    assert (loader.state.epoch, loader.state.batch_index) == (0, 3)


def test_run_epoch_raises_after_max_bad_steps():
    """Non-finite losses on max_bad_steps consecutive logged steps raise
    NonFiniteLossError; fewer do not."""
    class Loader:
        def epoch_batches(self, epoch, start_batch=0):
            for _ in range(start_batch, 4):
                yield type("B", (), dict(xy=np.zeros((1, 2, 1, 2)),
                                         mask=np.ones((1, 2, 1)),
                                         ids=np.ones((1, 1))))()

    def step_fn(state, xy, mask, ids):
        bad = state.step in (0, 1, 2)
        state = tstate.TrainState(state.step + 1, state.params, state.mu,
                                  state.nu, state.count, state.generator)
        return state, {"loss": torch.tensor(float("nan") if bad else 1.0)}

    st = tstate.create_train_state(_cfg(), {"w": torch.zeros(2)})
    with pytest.raises(ttrainer.NonFiniteLossError):
        ttrainer.run_epoch(st, Loader(), 0, step_fn, log_every=1)
    _, mean = ttrainer.run_epoch(st, Loader(), 0, step_fn, log_every=1,
                                 max_bad_steps=4)
    assert mean == 1.0
