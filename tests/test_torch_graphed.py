"""The graphed training step's CPU side (``train/graphed.py``): the rule
that decides when a step replays the CUDA graphs, the counters of a step
that does not, the loss's stages run apart as the graphs run them against
``desire_loss`` in one piece, and ``run_epoch``'s mean over distinct step
losses. The graphs themselves run on the card
(``tests/test_torch_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from desire_tpu_torch import DesireConfig
from desire_tpu_torch.models import desire
from desire_tpu_torch.params import init_desire
from desire_tpu_torch.train import graphed, trainer
from desire_tpu_torch.train import state as tstate
from desire_tpu_torch.utils import telemetry

FLAGSHIP = dict(batch_size=64, max_num_obj=60, num_samples=20,
                compute_dtype="bfloat16")
FLAGSHIP_SHAPE = ((64, 20, 60, 2), None)


def _cfg(**kw):
    """A toy model with every training term on (as
    tests/test_torch_train.py's)."""
    base = dict(batch_size=2, max_num_obj=4, obs_len=4, pred_len=3,
                num_samples=5, d_dim=16, latent_size=8, embedding_size=8,
                channel_multiplier=10, scene_grid=8, scene_channels=4,
                num_refine=2, compute_dtype="float32", rnn_size=128,
                variety_k=3)
    base.update(kw)
    return DesireConfig(**base)


def _params(cfg):
    """The port's init with the zero-init heads made non-zero."""
    g = torch.Generator().manual_seed(0)
    p = init_desire(cfg, g, "cpu")
    for sub, name in (("sgm", "prior"), ("ioc", "delta"), ("ioc", "gate")):
        if name in p.get(sub, {}):
            w = p[sub][name]["w"]
            p[sub][name]["w"] = 0.3 * torch.randn(w.shape, generator=g)
    return p


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b, t, a = cfg.batch_size, cfg.total_len, cfg.max_num_obj
    xy = torch.as_tensor(rng.uniform(0.3, 0.7, (b, t, a, 2)).astype(
        np.float32))
    mask = torch.ones((b, t, a))
    mask[0, -1, 1] = 0.0
    ids = torch.arange(1, a + 1).float().repeat(b, 1)
    ids[-1, -1] = 0.0
    return xy, mask, ids


@pytest.mark.parametrize("cfg_kw,call_kw,engages", [
    ({}, {}, True),
    ({}, dict(captured=FLAGSHIP_SHAPE), True),
    ({}, dict(cuda=False), False),
    ({}, dict(mesh=object()), False),
    (dict(remat=True), {}, False),
    (dict(fused_train=False), {}, False),
    (dict(use_pallas=False), {}, False),
    (dict(use_social=False), {}, False),
    ({}, dict(shape=((32, 20, 60, 2), None)), True),
    ({}, dict(shape=((32, 20, 60, 2), None), captured=FLAGSHIP_SHAPE),
     False),
    ({}, dict(shape=(FLAGSHIP_SHAPE[0], (64, 32, 32, 1)),
              captured=FLAGSHIP_SHAPE), False),
], ids=["flagship_first_call", "flagship_captured_shape", "cpu", "mesh",
        "remat", "layer_by_layer_ioc", "plain_ops", "no_social",
        "another_shape_first", "another_shape", "another_raster"])
def test_graphs_engage(cfg_kw, call_kw, engages):
    """The graphed loss takes a step on CUDA, without a mesh, with the
    fused training IOC and no remat, for the captured batch shape (any
    shape before the first capture)."""
    cfg = DesireConfig(**dict(FLAGSHIP, **cfg_kw))
    call = dict(cuda=True, mesh=None, shape=FLAGSHIP_SHAPE, captured=None)
    call.update(call_kw)
    assert graphed.engages(cfg, **call) is engages


def test_batch_shape_keys_the_raster():
    xy = torch.zeros((2, 7, 4, 2))
    assert graphed.batch_shape(xy) == ((2, 7, 4, 2), None)
    assert graphed.batch_shape(xy, torch.zeros((2, 8, 8, 1))) == (
        (2, 7, 4, 2), (2, 8, 8, 1))


def test_cpu_step_counts_its_loss_calls_and_no_replay():
    """step_fn counts every call in ``train.loss_calls``; on the CPU no
    call replays the graphs (``train.loss_graphed`` stays)."""
    cfg = _cfg()
    state = tstate.create_train_state(cfg, _params(cfg), seed=0)
    step_fn = trainer.make_train_step(cfg, steps_per_epoch=10)
    before = telemetry.tally()
    for _ in range(3):
        state, metrics = step_fn(state, *_batch(cfg))
        assert np.isfinite(float(metrics["loss"]))
    after = telemetry.tally()
    assert after["train.loss_calls"] - before.get("train.loss_calls", 0) == 3
    assert after.get("train.loss_graphed", 0) == before.get(
        "train.loss_graphed", 0)


@pytest.mark.parametrize("cfg_kw", [
    {}, dict(keep_prob=1.0), dict(cond_prior=False), dict(aniso_bound=True),
    dict(speed_loss_alpha=0.0, recon_agg="mean")],
    ids=["toy", "no_dropout", "no_cond_prior", "aniso_bound", "mean_agg"])
def test_stages_give_desire_loss_bit_for_bit(cfg_kw):
    """The loss's stages run apart as the graphs run them (each cut from
    the one before, the IOC's gradient and the tail's summed into the
    encode's, the warm-up step a tensor) give desire_loss's total,
    metrics and gradients bit for bit, and so does the forward in one
    piece (``desire_forward(train=True)``) with the tail, the call
    sequence before the stages."""
    cfg = _cfg(**cfg_kw)
    p = _params(cfg)
    xy, mask, ids = _batch(cfg)
    noise = trainer.step_noise(cfg, torch.Generator().manual_seed(3),
                               xy.shape, "cpu")
    state = tstate.create_train_state(cfg, p)
    for step in (0, 37, 500):
        got = []
        for how in ("loss", "forward_and_tail", "stages"):
            leaves = [x.detach().requires_grad_(True)
                      for x in tstate.tree_leaves(p)]
            params = tstate.tree_unflatten(p, leaves)
            if how == "stages":
                st = dataclasses.replace(state, step=step)
                g = graphed.GraphedLoss(cfg, st, xy, mask, ids, None, noise)
                metrics = g.forward(st, params, xy, mask, ids, None, noise)
                grads = g.backward(leaves)
            else:
                if how == "loss":
                    total, metrics = desire.desire_loss(
                        params, cfg, xy, mask, ids, step=step, noise=noise)
                else:
                    out = desire.desire_forward(
                        params, cfg, xy, mask, ids, eps=noise["eps"],
                        train=True, keep_x=noise.get("keep_x"),
                        keep_y=noise.get("keep_y"))
                    total, metrics = desire.loss_tail(
                        cfg, out, noise["lane_u"], step=step)
                grads = [torch.zeros_like(x) if gr is None else gr
                         for gr, x in zip(torch.autograd.grad(
                             total, leaves, allow_unused=True), leaves)]
            got.append(({k: v.detach() for k, v in metrics.items()}, grads))
        ref_m, ref_g = got[0]
        for m, grads in got[1:]:
            assert list(m) == list(ref_m)
            for k in ref_m:
                assert torch.equal(m[k], ref_m[k]), (step, k)
            for i, (a, b) in enumerate(zip(grads, ref_g)):
                assert torch.equal(a, b), (step, i)


def test_run_epoch_mean_is_over_distinct_step_losses():
    """run_epoch keeps each step's metrics["loss"] without copying: the
    mean it returns is the mean of the logged step losses, which
    differ."""
    cfg = _cfg()

    class Loader:
        def epoch_batches(self, epoch, start_batch=0):
            for i in range(start_batch, 4):
                xy, mask, ids = _batch(cfg, seed=i)
                yield type("B", (), dict(xy=xy.numpy(), mask=mask.numpy(),
                                         ids=ids.numpy()))()

    state = tstate.create_train_state(cfg, _params(cfg), seed=0)
    logged = []
    _, mean = trainer.run_epoch(
        state, Loader(), 0, trainer.make_train_step(cfg, 10),
        log_fn=lambda m, st: logged.append(m["loss"]), log_every=1)
    assert len(logged) == 4 and len(set(logged)) == 4
    assert mean == float(np.mean(logged))
