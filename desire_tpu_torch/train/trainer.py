"""The training step and the epoch loop (PyTorch port of
``desire_tpu/train/trainer.py``).

One step: the optional speed-augmentation zoom, ``desire_loss`` and its
gradients (through the training kernels on CUDA tensors), the gradient
norm before clipping, the optimizer update with that norm
(``train/state.py``; two kernel launches on CUDA tensors) and step + 1.
Every random draw comes from the state's generator. On the card the loss
and its gradients replay CUDA graphs (``train/graphed.py``).

Under a ``parallel.mesh.Mesh`` of mesh_data x mesh_k ranks: every rank
holds its rows of each batch, block d of the ``data`` axis (``run_epoch``
has the loader assemble only those), draws the step's global noise from
its generator (the same state on every rank) and keeps its rows of it,
and computes its share of the loss (global normalisers,
``desire_loss``): the full loss of its rows, its IOC on its block k of
the lanes (lane-parallel, mesh_k > 1). One all-reduce of one flat buffer
over the whole mesh then sums the gradients and metrics over ``data`` and
averages them over ``k``: a ``k`` rank's gradient holds every replicated
term in full and mk times its lanes' share of the IOC's, so the sum over
``k`` is mk times the unsharded gradient. The gradient norm, the clip and
Adam then run the same on every rank, so the params stay equal.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable

import numpy as np
import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.models import desire
from desire_tpu_torch.ops import ioc_bwd
from desire_tpu_torch.parallel import mesh as mesh_mod
from desire_tpu_torch.train import graphed as graphed_mod
from desire_tpu_torch.train.state import (TrainState, apply_updates,
                                          global_norm, tree_leaves,
                                          tree_unflatten)
from desire_tpu_torch.utils import telemetry


def step_noise(cfg: DesireConfig, generator, xy_shape, device,
               noise=None) -> dict:
    """The random draws of one training step on a batch of ``xy_shape``
    (B, T, A, 2), from generator, in the order the step consumes them:
    "zoom" (B,) log zoom factors in [-speed_aug, speed_aug) of the speed
    augmentation (speed_aug > 0), "lane_u" (B, A, K) uniforms of the
    variety subset, "eps" (B*A, K, lat) latent noise, "keep_x" (B*A, To,
    emb) and "keep_y" (B*A, Tf, emb) dropout keep-masks (keep_prob < 1).
    Draws given in ``noise`` are kept and not drawn."""
    b, t, a, _ = xy_shape
    k, emb = cfg.num_samples, cfg.embedding_size
    to = cfg.obs_len if cfg.protocol == "paper" else cfg.seq_length
    shapes = {"lane_u": (b, a, k), "eps": (b * a, k, cfg.latent_size)}
    if cfg.keep_prob < 1.0:
        shapes.update(keep_x=(b * a, to, emb), keep_y=(b * a, t - to, emb))
    out = dict(noise or {})
    if cfg.speed_aug > 0 and out.get("zoom") is None:
        out["zoom"] = (torch.rand((b,), generator=generator, device=device)
                       * 2.0 - 1.0) * cfg.speed_aug
    for key, shape in shapes.items():
        if out.get(key) is None:
            draw = torch.randn if key == "eps" else torch.rand
            out[key] = draw(shape, generator=generator, device=device)
            if key.startswith("keep"):
                out[key] = out[key] < cfg.keep_prob
    return out


def make_train_step(cfg: DesireConfig, steps_per_epoch: int,
                    mesh=None) -> Callable:
    """step_fn(state, xy, mask, ids, img=None, noise=None) -> (new state,
    metrics).

    img: the batch's (B, G, G, Ci) scene raster (cfg.scene_image_channels
    > 0; zeros when not given). noise: optional pinned draws of the step
    (``step_noise``'s keys); missing ones come from state.generator.
    metrics are the loss's, plus "grad_norm" of the gradients before
    clipping. mesh: a ``parallel.mesh.Mesh`` of any shape; xy, mask, ids
    and img are then the rank's rows of the global batch, noise the global
    draws, and the metrics the global ones (the module's docstring).

    Where ``graphed.engages`` (on the card, no mesh, the fused training
    IOC, the captured batch shape) the loss and its gradients replay CUDA
    graphs around the eager IOC, captured at the first such call
    (``train/graphed.py``); elsewhere they run eagerly. Every call counts
    ``train.loss_calls``, every graphed one ``train.loss_graphed``; a
    graphed step ends waiting for the card to finish the step before it
    (span ``train.wait``), so the host keeps one step ahead."""
    data = mesh if mesh is not None and mesh.size > 1 else None
    graphed = None      # the graphed loss, captured at the first call
    pending = None      # the card's end of the last graphed step

    def step_fn(state: TrainState, xy, mask, ids, img=None, noise=None):
        nonlocal graphed, pending
        telemetry.count("train.loss_calls")
        if xy.is_cuda and desire.uses_fused_train_ioc(cfg):
            # before any launch: the IOC backward's block holds the lane
            ioc_bwd.check_bwd_agents(
                xy.shape[2], cfg.pred_len, cfg.d_dim, cfg.scene_channels,
                cfg.scene_grid, cfg.compute_dtype == "bfloat16")
        gen = state.generator
        xy = xy.float()
        global_shape = list(xy.shape)
        if data is not None:
            global_shape[0] *= data.shape[0]
        noise = step_noise(cfg, gen, global_shape, xy.device, noise)
        if data is not None:
            # the rank's rows of every draw (rows lead each of them)
            noise = {k: v[data.rows(v.shape[0])] for k, v in noise.items()}
        if cfg.speed_aug > 0:
            # a global window zoom around the scene center, log-uniform in
            # [e^-a, e^a], clipped to stay in the scene
            s = torch.exp(torch.as_tensor(noise["zoom"],
                                          device=xy.device).reshape(
                -1, 1, 1, 1))
            xy = torch.clamp(0.5 + (xy - 0.5) * s, 0.0, 1.0)
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        shape = graphed_mod.batch_shape(xy, img)
        use_graphs = graphed_mod.engages(
            cfg, cuda=xy.is_cuda, mesh=data, shape=shape,
            captured=None if graphed is None else graphed.shape)
        batch = (xy, mask, ids, img, noise)
        if use_graphs and graphed is None:
            with telemetry.span("setup.train_graphs"):
                graphed = graphed_mod.GraphedLoss(cfg, state, *batch)
                graphed.capture(state, params, *batch)
        with telemetry.span("train.forward"):
            if use_graphs:
                metrics = graphed.forward(state, params, *batch)
            else:
                total, metrics = desire.desire_loss(
                    params, cfg, xy, mask, ids, step=state.step,
                    noise=noise, generator=gen, scene_image=img, mesh=data)
        with telemetry.span("train.backward"):
            if use_graphs:
                grads = graphed.backward(leaves)
            else:
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
                # contiguous, as the optimizer kernels take them: autograd
                # hands a weight read transposed a transposed gradient
                grads = [torch.zeros_like(x) if g is None else g.contiguous()
                         for g, x in zip(grads, leaves)]
        if use_graphs:
            telemetry.count("train.loss_graphed")
        else:
            metrics = {k: torch.as_tensor(v).detach()
                       for k, v in metrics.items()}
        if data is not None:
            with telemetry.span("train.allreduce"):
                grads, metrics = _reduce_over_mesh(data, grads, metrics)
        with telemetry.span("train.optimizer"):
            # the norm taken once: the metric is the one the clip uses
            metrics["grad_norm"] = g_norm = global_norm(grads)
            new = apply_updates(cfg, steps_per_epoch, state, grads,
                                g_norm=g_norm)
        if use_graphs:
            # the host runs at most one step ahead of the card: it waits
            # here for the step before this one, and not at a launch of
            # the next step's, which a full queue of the card's would stop
            done = torch.cuda.Event()
            done.record()
            if pending is not None:
                with telemetry.span("train.wait"):
                    pending.synchronize()
            pending = done
        p, mu, nu, count = new
        return TrainState(step=state.step + 1, params=p, mu=mu, nu=nu,
                          count=count, generator=gen, flat=new.flat), metrics

    return step_fn


def _reduce_over_mesh(mesh, grads, metrics):
    """The gradients and metrics summed over ``data`` and averaged over
    ``k``, in one all-reduce of one flat buffer over the whole mesh."""
    names = list(metrics)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [metrics[k].reshape(1).to(grads[0].dtype)
                        for k in names])
    flat = mesh_mod.all_sum(mesh, flat, axis=mesh_mod.MESH)
    if mesh.shape[1] > 1:
        flat = flat / mesh.shape[1]
    parts = flat.split(
        [g.numel() for g in grads] + [1] * len(names))
    return ([p.view_as(g) for p, g in zip(parts, grads)],
            {k: p.reshape(()) for k, p in zip(names, parts[len(grads):])})


class NonFiniteLossError(RuntimeError):
    """Raised when training produces non-finite losses repeatedly: fail
    fast instead of carrying NaN parameters on."""


def make_eval_forward(cfg: DesireConfig, k_samples=None,
                      mesh=None) -> Callable:
    """fwd(params, xy, mask, ids, img=None, eps=None, generator=None,
    z_temp=None) -> ``desire_forward(train=False)``'s outputs: img the
    batch's scene raster, the latent noise from eps (B*A, K, lat) when
    given, else from generator; z_temp the optional (B, A) latent
    temperature. mesh: a ``parallel.mesh.Mesh``, the forward then
    collective over the global batch (``desire_forward``)."""
    def fwd(params, xy, mask, ids, img=None, eps=None, generator=None,
            z_temp=None):
        return desire.desire_forward(params, cfg, xy, mask, ids, eps=eps,
                                     generator=generator,
                                     k_samples=k_samples, train=False,
                                     z_temp=z_temp, scene_image=img,
                                     mesh=mesh)
    return fwd


def stage_to_device(arrays, device) -> tuple:
    """numpy arrays -> float32 tensors of their shapes on ``device``, in one
    copy: on CUDA through one pinned host buffer and one asynchronous copy,
    with no fallback to the CPU (a CUDA device that is missing raises); on
    the CPU as views of one buffer."""
    arrs = [np.asarray(a, np.float32) for a in arrays]
    sizes = [a.size for a in arrs]
    device = torch.device(device)
    if device.type == "cuda":
        host = torch.empty(sum(sizes), dtype=torch.float32, pin_memory=True)
        np.concatenate([a.reshape(-1) for a in arrs], out=host.numpy())
        flat = host.to(device, non_blocking=True)
    else:
        flat = torch.from_numpy(
            np.concatenate([a.reshape(-1) for a in arrs])).to(device)
    return tuple(x.view(a.shape) for x, a in
                 zip(torch.split(flat, sizes), arrs))


def batch_to_device(batch, device) -> tuple:
    """A host batch -> (xy, mask, ids, *img) float32 tensors on ``device``,
    in one copy (``stage_to_device``): img is the batch's (B, G, G, Ci)
    scene raster where it carries one (cfg.scene_image_channels > 0), for
    callers to splat into the step or forward."""
    arrs = [batch.xy, batch.mask, batch.ids]
    if getattr(batch, "image", None) is not None:
        arrs.append(batch.image)
    return stage_to_device(arrs, device)


def run_epoch(state: TrainState, loader, epoch: int, step_fn,
              log_fn=None, log_every: int = 20, start_batch: int = 0,
              max_batches: int | None = None, max_bad_steps: int = 3,
              mesh=None):
    """Drive one epoch over ``loader.epoch_batches(epoch, start_batch)``
    (batches with xy, mask and ids arrays, and a scene raster ``image``
    where the config has imagery), at most max_batches of them.
    The batches go to the params' device (``batch_to_device``). mesh: a
    ``parallel.mesh.Mesh`` (step_fn made with it): the loader assembles
    only this rank's rows of each batch (block d; the ``k`` ranks of a
    row hold the same rows). Returns
    (state, mean loss).

    Every batch is the span ``train.step`` (id: the batch index), which
    holds ``train.loader`` (the wait for the batch), ``train.copy``, the
    step and ``train.sync`` (the log cadence's reads); the last wait, which
    finds no batch, is no step. The counters ``train.slots`` and
    ``train.live_slots`` add each batch's agent slots and those that hold
    an agent. With a ``log_fn`` each record carries ``span_ms``: every
    span's mean ms a call since the previous record."""
    device = tree_leaves(state.params)[0].device
    losses_acc, t0 = [], time.time()
    bad = 0
    if mesh is not None and mesh.shape[0] > 1:
        # the step's rows are a fixed block of cfg.batch_size rows: a short
        # remainder batch would not split
        if not loader.drop_remainder:
            raise ValueError("data-parallel training needs a loader with "
                             "drop_remainder batches")
        batches = loader.epoch_batches(
            epoch, start_batch,
            rows=mesh_mod.local_batch_rows(mesh, loader.cfg.batch_size))
    else:
        batches = loader.epoch_batches(epoch, start_batch)
    if max_batches is not None:
        # stop before the loader assembles the next batch: its position
        # (loader.state, which a checkpoint records) stays at the last
        # batch trained
        batches = itertools.islice(batches, max_batches)
    batches = iter(batches)
    last = telemetry.snapshot() if log_fn is not None else None
    for bi in itertools.count(start_batch):
        with telemetry.span("train.step", bi) as step:
            with telemetry.span("train.loader") as wait:
                batch = next(batches, None)
                # the epoch's end is no step
                wait.discard = step.discard = batch is None
            if batch is None:
                break
            telemetry.count("train.slots", batch.ids.size)
            telemetry.count("train.live_slots", np.count_nonzero(batch.ids))
            with telemetry.span("train.copy"):
                xy, mask, ids, *img = batch_to_device(batch, device)
            state, metrics = step_fn(state, xy, mask, ids, *img)
            if bi % log_every == 0:
                # the finiteness check rides the logging cadence: reading a
                # value waits for the device
                with telemetry.span("train.sync"):
                    m = {k: float(v) for k, v in metrics.items()}
                if not (np.isfinite(m["loss"])
                        and np.isfinite(m.get("grad_norm", 0.0))):
                    # a non-finite gradient has already poisoned this
                    # update: the state is not handed to log_fn
                    bad += 1
                    if bad >= max_bad_steps:
                        raise NonFiniteLossError(
                            f"{bad} consecutive non-finite losses at epoch "
                            f"{epoch} batch {bi}; resume from the last good "
                            f"checkpoint")
                    continue
                bad = 0
                if log_fn is not None:
                    now = telemetry.snapshot()
                    m.update(epoch=epoch, batch=bi, step=int(state.step),
                             sec_per_batch=(time.time() - t0)
                             / max(bi - start_batch + 1, 1),
                             span_ms=telemetry.mean_ms(
                                 telemetry.delta(last, now)))
                    last = now
                    log_fn(m, state)
            losses_acc.append(metrics["loss"])
    mean_loss = (float(np.mean([float(x) for x in losses_acc]))
                 if losses_acc else float("nan"))
    if losses_acc and not np.isfinite(mean_loss):
        raise NonFiniteLossError(
            f"epoch {epoch} mean loss is non-finite; resume from the last "
            f"good checkpoint")
    return state, mean_loss
