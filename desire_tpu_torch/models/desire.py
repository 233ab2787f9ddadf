"""The full DESIRE model: SGM sampler + scene context + IOC
rank-and-refine, and its multi-task training loss (PyTorch port of
``desire_tpu/models/desire.py``).

Batch convention: xy (B, T, A, 2), mask (B, T, A), ids (B, A); id 0 marks
an empty agent slot. Agents are flattened into rows (N = B*A) for the
per-agent work and keep their (B, A) structure where they interact.

All randomness is an input: the latent noise, the variety-subset lane
draws and the encoder dropout keep-masks may be passed in (``noise``),
else they are drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import functools

import torch

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch import ops
from desire_tpu_torch.models import ioc as ioc_mod
from desire_tpu_torch.models import losses
from desire_tpu_torch.models import scf as scf_mod
from desire_tpu_torch.models import sgm as sgm_mod
from desire_tpu_torch.parallel import mesh as mesh_mod
from desire_tpu_torch.utils import telemetry


def init_desire(cfg: DesireConfig, generator: torch.Generator, device,
                dtype=torch.float32) -> dict:
    """A parameter tree with the JAX ``init_desire``'s keys and shapes,
    drawn from ``generator``."""
    params = {"sgm": sgm_mod.init_sgm(generator, cfg, device, dtype)}
    if cfg.use_scf or cfg.use_ioc:
        params["scf"] = scf_mod.init_scf(generator, cfg, device, dtype)
    if cfg.use_ioc:
        params["ioc"] = ioc_mod.init_ioc(generator, cfg, device, dtype)
    return params


def uses_fused_ioc(cfg: DesireConfig) -> bool:
    """Whether desire_forward refines through the fused IOC loop rather
    than layer by layer."""
    return cfg.use_ioc and cfg.use_pallas and cfg.use_social


@telemetry.span("setup.pack")
def pack_kernel_weights(params, cfg: DesireConfig, device) -> dict:
    """The weights of the forward's CUDA kernels in the layouts they read,
    packed once for ``desire_forward(kernel_weights=...)`` (a Predictor does
    so when it loads its params). Empty off CUDA: the plain versions read
    the param tree."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    cd = sgm_mod.compute_dtype(cfg)
    out = {}
    if sgm_mod.uses_fused_sampler(params["sgm"], cfg):
        out["sgm"] = ops.pack_sampler(params["sgm"], cd, device)
    if uses_fused_ioc(cfg):
        out["ioc"] = ops.pack_ioc(params["ioc"], params["scf"], cd, device,
                                  cfg.max_num_obj)
    return out


def split_batch(cfg: DesireConfig, xy, mask):
    """(B, T, A, ·) -> observed and future parts, agent-major."""
    to = cfg.obs_len if cfg.protocol == "paper" else cfg.seq_length
    obs_xy = xy[:, :to].transpose(1, 2)
    fut_xy = xy[:, to:].transpose(1, 2)
    obs_mask = mask[:, :to].transpose(1, 2)
    fut_mask = mask[:, to:].transpose(1, 2)
    return obs_xy, fut_xy, obs_mask, fut_mask


def uses_fused_train_ioc(cfg: DesireConfig) -> bool:
    """Whether the training forward refines through the trainable fused IOC
    (the training forward kernel and the backward kernel)."""
    return cfg.fused_train and uses_fused_ioc(cfg)


def desire_forward(params, cfg: DesireConfig, xy, mask, ids, *, eps=None,
                   generator=None, k_samples=None, train=False,
                   kernel_weights=None, keep_x=None, keep_y=None,
                   z_temp=None, scene_image=None, mesh=None,
                   lane_mesh=None):
    """End-to-end forward. Returns a dict of the stage outputs.

    eps: optional latent noise (B*A, K, lat); keep_x / keep_y: optional
    training dropout keep-masks of the observed and future encoders
    (B*A, To, emb) and (B*A, Tf, emb); whatever is not given is drawn from
    generator. kernel_weights: from :func:`pack_kernel_weights` for these
    params (inference); without them each kernel call packs its own.
    z_temp: optional (B, A) per-agent latent temperature of the inference
    draws (``sgm.sgm_forward``).
    scene_image: optional (B, G, G, cfg.scene_image_channels) imagery
    raster of the scene CNN; zeros when the config declares imagery
    channels and the caller gives none.
    Inference runs without autograd; train=True records the graph for
    :func:`desire_loss`.
    mesh: a ``parallel.mesh.Mesh`` of more than one rank (inference):
    collective, every rank of the mesh calls it with the same global
    batch and eps (or a generator in the same state), computes its block
    of rows and lanes (:func:`_meshed_forward`) and returns the global
    outputs. Without one the forward is unsharded, whatever the config's
    mesh_data and mesh_k.
    lane_mesh: training (train=True) on rank (d, k) of a mesh whose k
    divides K: xy, mask, ids and every draw are the rank's rows; the
    sampler runs all K lanes of them, and the IOC its block of the lanes,
    gathered to all K (``parallel.mesh.on_lanes``), so every output holds
    all K lanes (:func:`desire_loss`)."""
    if mesh is not None and mesh.size > 1:
        if train:
            raise ValueError("the meshed forward is inference; desire_loss "
                             "trains under a mesh")
        with torch.inference_mode():
            return _meshed_forward(params, cfg, mesh, xy, mask, ids,
                                   eps=eps, generator=generator,
                                   k_samples=k_samples,
                                   kernel_weights=kernel_weights,
                                   z_temp=z_temp, scene_image=scene_image)
    if lane_mesh is not None and not train:
        raise ValueError("lane_mesh is training's; the meshed inference "
                         "forward takes mesh")
    with torch.inference_mode(not train):
        return _forward(params, cfg, xy, mask, ids, eps=eps,
                        generator=generator, k_samples=k_samples,
                        train=train, kernel_weights=kernel_weights,
                        keep_x=keep_x, keep_y=keep_y, z_temp=z_temp,
                        scene_image=scene_image, lane_mesh=lane_mesh)


# outputs of the meshed forward with lanes on dim 2, and with rows only
_LANE_OUTPUTS = ("raw5", "refined_traj", "scores")
_ROW_OUTPUTS = ("z_mu", "z_logvar", "zp_mu", "zp_logvar")


def _meshed_forward(params, cfg, mesh, xy, mask, ids, *, eps, generator,
                    k_samples, kernel_weights, z_temp, scene_image):
    """The inference forward on rank (d, k) of a mesh: the latent noise is
    the global draw (eps, else drawn from generator as the unsharded
    forward draws it); the rank runs every stage on its rows (block d of
    the B windows), the two kernels on its lanes (block k of the K), and
    the outputs are gathered to their global shapes on every rank (two
    all-reduces). Every stage is per row and per lane (the scene CNN's
    group norm is per window, the social attention per lane), so the
    blocks need no other collective. Where B or K does not split over the
    mesh, every rank runs the unsharded forward (the JAX package falls
    back to XLA there)."""
    K = k_samples or cfg.num_samples
    b, _, a, _ = xy.shape
    kw = dict(generator=generator, k_samples=K, train=False,
              kernel_weights=kernel_weights, keep_x=None, keep_y=None)
    if not mesh.divides(b, K):
        return _forward(params, cfg, xy, mask, ids, eps=eps, z_temp=z_temp,
                        scene_image=scene_image, mesh=None, **kw)
    if eps is None:
        eps = torch.randn((b * a, K, cfg.latent_size), generator=generator,
                          device=xy.device)
    rows = mesh.rows(b)

    def cut(x):
        return None if x is None else x[rows]

    out = _forward(params, cfg, xy[rows], mask[rows], ids[rows],
                   eps=eps[mesh.rows(b * a)], z_temp=cut(z_temp),
                   scene_image=cut(scene_image), mesh=mesh, **kw)

    # (B/md, A, K/mk, ...) blocks of (B, A, K, ...), (B/md, ...) of (B, ...)
    lane_keys = [k for k in _LANE_OUTPUTS if (cfg.use_ioc or k == "raw5")
                 and out[k] is not None]
    blocks = [out[k] for k in lane_keys] + out["per_iter_trajs"]
    got = mesh_mod.assemble(
        mesh, [(x, (b, a, K) + x.shape[3:]) for x in blocks], lane_dim=2)
    result = dict(zip(lane_keys, got), per_iter_trajs=got[len(lane_keys):])
    row_keys = [k for k in _ROW_OUTPUTS if out[k] is not None]
    result.update(zip(row_keys, mesh_mod.assemble(
        mesh, [(out[k], (b,) + out[k].shape[1:]) for k in row_keys])))
    obs_xy, fut_xy, obs_mask, fut_mask = split_batch(cfg, xy.float(),
                                                     mask.float())
    result.update(sgm_traj=result["raw5"][..., 0:2],
                  live=losses.agent_validity_mask(ids), obs_xy=obs_xy,
                  fut_xy=fut_xy, obs_mask=obs_mask, fut_mask=fut_mask)
    for k in _ROW_OUTPUTS + ("scores",):
        result.setdefault(k, None)
    if not cfg.use_ioc:
        result["refined_traj"] = result["sgm_traj"]
    return result


def _forward(params, cfg, xy, mask, ids, *, eps, generator, k_samples,
             train, kernel_weights, keep_x, keep_y, z_temp, scene_image,
             mesh=None, lane_mesh=None, encode_only=False):
    """The forward on the given rows: under ``mesh`` (inference) on the
    rank's lanes of every stage, under ``lane_mesh`` (training) on all K
    lanes but the IOC's (:func:`desire_forward`). encode_only: stop before
    the IOC, with its inputs dec_h and feat_map among the outputs
    (:func:`loss_encode`)."""
    K = k_samples or cfg.num_samples
    xy = xy.float()
    mask = mask.float()
    b, _, a, _ = xy.shape
    obs_xy, fut_xy, obs_mask, fut_mask = split_batch(cfg, xy, mask)
    live = losses.agent_validity_mask(ids)
    n = b * a
    packed = kernel_weights or {}
    with telemetry.span("model.sgm"):
        out = sgm_mod.sgm_forward(
            params["sgm"], cfg, obs_xy.reshape(n, *obs_xy.shape[2:]),
            obs_mask.reshape(n, -1),
            fut_xy.reshape(n, *fut_xy.shape[2:]) if train else None,
            fut_mask.reshape(n, -1) if train else None,
            eps=eps, generator=generator, k_samples=K, train=train,
            keep_x=keep_x, keep_y=keep_y, sampler_weights=packed.get("sgm"),
            z_temp=(None if z_temp is None
                    else z_temp.reshape(n, 1, 1).float()),
            mesh=mesh)

    K = out["traj_mu"].shape[1]     # the rank's lanes under a meshed forward
    tf_len = fut_xy.shape[2]
    traj = out["traj_mu"].reshape(b, a, K, tf_len, 2)
    dec_h = out["dec_h"].reshape(b, a, K, tf_len, -1)

    def per_agent(x):
        return None if x is None else x.reshape(b, a, -1)

    result = {
        "raw5": out["raw5"].reshape(b, a, K, tf_len, 5),
        "sgm_traj": traj,
        "z_mu": per_agent(out["z_mu"]),
        "z_logvar": per_agent(out["z_logvar"]),
        "zp_mu": per_agent(out["zp_mu"]),
        "zp_logvar": per_agent(out["zp_logvar"]),
        "live": live, "obs_xy": obs_xy, "fut_xy": fut_xy,
        "obs_mask": obs_mask, "fut_mask": fut_mask,
    }
    if not cfg.use_ioc:
        result.update(refined_traj=traj, scores=None, per_iter_trajs=[])
        return result

    cd = sgm_mod.compute_dtype(cfg)
    with telemetry.span("model.scf"):
        if cfg.use_scf:
            image = None
            if cfg.scene_image_channels:
                image = scene_image
                if image is None:
                    image = torch.zeros((b, cfg.scene_grid, cfg.scene_grid,
                                         cfg.scene_image_channels),
                                        device=xy.device)
            feat_map = scf_mod.scene_feature_map(
                params["scf"], obs_xy.transpose(1, 2),
                obs_mask.transpose(1, 2), cfg.scene_grid, compute_dtype=cd,
                image=image)
        else:
            # IOC without scene context: a zero map keeps the fusion layout
            feat_map = torch.zeros(
                (b, cfg.scene_grid, cfg.scene_grid, cfg.scene_channels),
                dtype=cd, device=xy.device)

    if encode_only:
        result.update(dec_h=dec_h, feat_map=feat_map)
        return result
    refined, scores, per_iter = _refine(
        params, cfg, traj, dec_h, feat_map, live, fut_mask, train=train,
        packed=packed, mesh=mesh, lane_mesh=lane_mesh)
    result.update(refined_traj=refined, scores=scores,
                  per_iter_trajs=per_iter)
    return result


def _refine(params, cfg, traj, dec_h, feat_map, live, fut_mask, *, train,
            packed, mesh, lane_mesh):
    """The IOC stage (span ``model.ioc``) of :func:`_forward`: (refined,
    scores, per-pass trajectories)."""
    with telemetry.span("model.ioc"):
        kw = dict(num_refine=max(cfg.num_refine, 1),
                  delta_scale=ioc_mod._DELTA_SCALE,
                  social_freeze=cfg.social_freeze)
        if not train and uses_fused_ioc(cfg):
            refine = (ops.ioc_refine if mesh is None
                      else functools.partial(ops.ioc_refine_sharded, mesh))
            refined, scores = refine(
                params["ioc"], params["scf"], traj.contiguous(),
                dec_h.contiguous(), feat_map.contiguous(), live.contiguous(),
                fut_mask.contiguous(), weights=packed.get("ioc"), **kw)
            per_iter = []
        elif train and uses_fused_train_ioc(cfg):
            refine = (ops.ioc_refine_train if lane_mesh is None else
                      functools.partial(ops.ioc_refine_train_sharded,
                                        lane_mesh))
            refined, scores, iters = refine(
                params["ioc"], params["scf"], traj, dec_h, feat_map, live,
                fut_mask, **kw)
            per_iter = list(iters.unbind(0))
        else:
            # layer by layer; every lane is independent (the social pool
            # attends within a lane), so lane_mesh splits it
            def refine(traj, dec_h):
                refined, scores, per_iter = ioc_mod.ioc_forward(
                    params["ioc"], params["scf"], cfg, traj, dec_h, feat_map,
                    live, fut_mask)
                return [refined, scores, *per_iter]
            refined, scores, *per_iter = (
                refine(traj, dec_h) if lane_mesh is None
                else mesh_mod.on_lanes(lane_mesh, refine, traj, dec_h,
                                       [2] * (2 + kw["num_refine"])))
    return refined, scores, per_iter


def desire_loss(params, cfg: DesireConfig, xy, mask, ids, *, step=None,
                k_samples=None, noise=None, generator=None,
                scene_image=None, mesh=None):
    """Multi-task training loss and metrics (JAX ``desire_loss``).

    noise: optional dict of the step's random draws: "eps" (B*A, K, lat),
    "lane_u" (B, A, K) uniforms of the variety subset, "keep_x" and
    "keep_y" dropout keep-masks; each missing one is drawn from generator.
    scene_image: the batch's imagery raster (``desire_forward``).
    mesh: a ``parallel.mesh.Mesh``. The batch and noise are then the
    rank's rows (block d; every draw given, cut from the global draws by
    rows only: ``train.trainer.step_noise``), and every masked mean
    divides the rank's total by the mask's sum over the global batch, so
    that the losses and metrics of the ``data`` ranks add up to the global
    ones; the speed weights' statistics are global too. With mesh_k > 1
    the sampler, the scene CNN and every loss term run on all K lanes of
    the rank's rows, and the IOC on its block of the lanes, gathered to
    all K (``ops.ioc_refine_train_sharded``; layer by layer,
    ``parallel.mesh.on_lanes``): every ``k`` rank of a row computes
    the same loss, and the IOC's share of its gradients is mk times its
    lanes' (``train.trainer`` sums over the mesh and divides by mk). Where
    K does not split over ``k``, every rank runs all the lanes.
    Returns (total, metrics), metrics with the JAX package's keys.

    It runs as three stages: :func:`loss_encode` (the SGM training forward
    and the scene feature map), :func:`loss_refine` (the IOC) and
    :func:`loss_tail` (every term after the IOC). The graphed training
    step (``train/graphed.py``) replays the first and the last as CUDA
    graphs around the eager IOC."""
    K = k_samples or cfg.num_samples
    b, _, a, _ = xy.shape
    dev = xy.device
    nz = noise or {}
    lane_mesh = (mesh if mesh is not None and mesh.shape[1] > 1
                 and K % mesh.shape[1] == 0 else None)
    if mesh is not None and (
            {"lane_u", "eps"} - set(nz)
            or (cfg.keep_prob < 1.0 and {"keep_x", "keep_y"} - set(nz))):
        raise ValueError("under a mesh the loss takes the rank's rows of "
                         "the step's global draws: pass every one in noise")
    lane_u = nz.get("lane_u")
    if lane_u is None:
        lane_u = torch.rand((b, a, K), generator=generator, device=dev)
    elif tuple(lane_u.shape) != (b, a, K):
        raise ValueError(f"lane_u must be {(b, a, K)}, got "
                         f"{tuple(lane_u.shape)}")
    out = loss_encode(params, cfg, xy, mask, ids, k_samples=K, noise=nz,
                      generator=generator, scene_image=scene_image,
                      lane_mesh=lane_mesh)
    refined, scores, per_iter = loss_refine(params, cfg, out,
                                            lane_mesh=lane_mesh)
    out.update(refined_traj=refined, scores=scores, per_iter_trajs=per_iter)
    return loss_tail(cfg, out, lane_u, step=step, mesh=mesh)


def loss_encode(params, cfg: DesireConfig, xy, mask, ids, *, k_samples,
                noise, generator=None, scene_image=None, lane_mesh=None):
    """:func:`desire_loss`'s first stage: the training forward up to the
    IOC, that is the SGM training forward (encoders, CVAE, the decoder
    layer by layer) and the scene feature map. noise: the step's draws
    ("eps", "keep_x", "keep_y"; a missing one is drawn from generator).
    Returns :func:`desire_forward`'s outputs before the IOC, with the
    IOC's inputs dec_h and feat_map where the model has an IOC."""
    return _forward(params, cfg, xy, mask, ids, eps=noise.get("eps"),
                    generator=generator, k_samples=k_samples, train=True,
                    kernel_weights=None, keep_x=noise.get("keep_x"),
                    keep_y=noise.get("keep_y"), z_temp=None,
                    scene_image=scene_image, lane_mesh=lane_mesh,
                    encode_only=True)


def loss_refine(params, cfg: DesireConfig, enc, *, lane_mesh=None):
    """:func:`desire_loss`'s second stage: the IOC on ``enc``'s sgm_traj,
    dec_h, feat_map, live and fut_mask (:func:`loss_encode`'s outputs).
    With the fused training IOC it is ``ops.ioc_refine_train``, looked up
    at call time, whose backward is the IOC backward kernel. Returns
    (refined, scores, per-pass trajectories); without an IOC the
    sampler's trajectories, None and no passes."""
    if not cfg.use_ioc:
        return enc["sgm_traj"], None, []
    return _refine(params, cfg, enc["sgm_traj"], enc["dec_h"],
                   enc["feat_map"], enc["live"], enc["fut_mask"], train=True,
                   packed={}, mesh=None, lane_mesh=lane_mesh)


def loss_tail(cfg: DesireConfig, out, lane_u, *, step=None, mesh=None):
    """:func:`desire_loss`'s last stage: every term after the IOC (the NLL
    kernels, the KLD with its warm-up, the prior lanes' NLL, the IOC
    cross-entropy, the refinement regression, the trust region, the speed
    weights) down to the total and the metrics. out: :func:`loss_encode`'s
    outputs with refined_traj, scores and per_iter_trajs
    (:func:`loss_refine`'s); lane_u: the variety subset's (B, A, K)
    uniforms; step: the update count of the KLD warm-up, an int or a 0-d
    float32 tensor on the batch's device (the graphed step's, which
    replays the stage for every step); mesh: as :func:`desire_loss`'s.
    Returns (total, metrics)."""
    K = lane_u.shape[-1]
    b, a = out["live"].shape
    dev = out["fut_xy"].device

    def stat_mean(values, weights):
        # a detached masked mean over the global batch
        if mesh is None:
            return losses.masked_mean(values, weights)
        tot = mesh_mod.all_sum(mesh, torch.stack(
            [(values * weights).sum(), weights.sum()]))
        return tot[0] / torch.clamp(tot[1], min=1e-8)

    fut_xy, fut_mask, live = out["fut_xy"], out["fut_mask"], out["live"]
    f32 = torch.float32
    # an agent must have at least one valid future step
    live = live * (fut_mask.sum(dim=-1) > 0).to(live.dtype)

    if cfg.speed_loss_alpha > 0:
        # speed-balanced weights, renormalized to mean 1 over live agents
        s = sgm_mod.observed_speed(
            out["obs_xy"].reshape(-1, out["obs_xy"].shape[2], 2),
            out["obs_mask"].reshape(-1, out["obs_mask"].shape[2]))
        s = s.reshape(live.shape).detach()
        mean_s = stat_mean(s, live)
        w = ((s + 1e-4) / (mean_s + 1e-4)) ** cfg.speed_loss_alpha
        w = w / torch.clamp(stat_mean(w, live), min=1e-6)
        live = live * w
    # the masked means' denominator: the live agents' weight
    count = (None if mesh is None
             else mesh_mod.all_sum(mesh, live.sum().detach()))

    raw5 = out["raw5"].to(f32)
    tf_len = raw5.shape[3]
    if cfg.use_pallas:
        nll_per_lane = ops.bivariate_nll_sum(
            raw5.reshape(b * a, K, tf_len, 5),
            fut_xy.reshape(b * a, tf_len, 2).to(f32),
            fut_mask.reshape(b * a, tf_len).to(f32)).reshape(b, a, K)
    else:
        nll_per_lane = losses.bivariate_nll(
            raw5, fut_xy[:, :, None].to(f32),
            step_mask=fut_mask[:, :, None].to(f32)).sum(dim=-1)
    # variety subset: min-aggregated losses see variety_k random lanes
    lane_pen = None
    if cfg.recon_agg == "min" and 0 < cfg.variety_k < K:
        kth = torch.sort(lane_u, dim=-1).values[..., cfg.variety_k - 1, None]
        lane_pen = torch.where(lane_u <= kth, 0.0, 1e9).to(f32)
    if cfg.recon_agg == "min":
        nll_agg = torch.amin(nll_per_lane if lane_pen is None
                             else nll_per_lane + lane_pen, dim=-1)
    else:
        nll_agg = nll_per_lane.mean(dim=-1)
    nll = losses.masked_mean(nll_agg, live, count=count)

    if out["zp_mu"] is not None:
        kld_per = losses.kld_gaussians(
            out["z_mu"].to(f32), out["z_logvar"].to(f32),
            out["zp_mu"].to(f32), out["zp_logvar"].to(f32),
            free_bits=cfg.kld_free_bits)
    else:
        kld_per = losses.kld_normal(out["z_mu"].to(f32),
                                    out["z_logvar"].to(f32),
                                    free_bits=cfg.kld_free_bits)
    kld = losses.masked_mean(kld_per, live, count=count)
    w_kld = cfg.w_kld
    if cfg.kld_warmup and step is not None:
        if torch.is_tensor(step):
            # a divisor on the card: one given as a number is multiplied
            # in as its reciprocal there, which can round otherwise than
            # the eager step's division on the host
            ramp = step / torch.full_like(step, cfg.kld_warmup)
        else:
            ramp = torch.as_tensor(step, dtype=f32) / cfg.kld_warmup
        w_kld = w_kld * torch.clamp(ramp, 0.0, 1.0).to(dev)

    total = cfg.w_nll * nll + w_kld * kld
    metrics = {"nll": nll, "kld": kld}

    kp = int(round(K * cfg.prior_lane_frac))
    if kp > 0 and cfg.w_prior_nll > 0:
        # best of the prior lanes: prior-predictive coverage
        nll_prior = losses.masked_mean(
            torch.amin(nll_per_lane[..., :kp], dim=-1), live, count=count)
        total = total + cfg.w_prior_nll * nll_prior
        metrics["prior_nll"] = nll_prior

    if cfg.use_ioc:
        scores = out["scores"].to(f32)
        live_t = live.to(f32)
        ce = losses.ioc_cross_entropy(
            scores, out["refined_traj"].to(f32), fut_xy.to(f32), live_t,
            step_mask=fut_mask.to(f32), temperature=cfg.ioc_temp,
            count=count)
        reg = 0.0
        for t in out["per_iter_trajs"]:
            reg = reg + losses.refine_regression_loss(
                t.to(f32), fut_xy.to(f32), live_t,
                step_mask=fut_mask.to(f32), agg=cfg.recon_agg,
                lane_penalty=lane_pen, count=count)
        reg = reg / max(len(out["per_iter_trajs"]), 1)
        # trust region: every lane's refinement stays near its hypothesis
        delta2 = ((out["refined_traj"].to(f32)
                   - out["sgm_traj"].to(f32)) ** 2).sum(dim=-1)
        delta2 = delta2 * fut_mask[:, :, None].to(f32)
        delta_mag = losses.masked_mean(delta2.mean(dim=(-1, -2)), live_t,
                                       count=count)
        total = (total + cfg.w_ce * ce + cfg.w_reg * reg
                 + cfg.w_delta * delta_mag)
        metrics.update(ioc_ce=ce, refine_reg=reg, delta_mag=delta_mag)

    metrics["loss"] = total
    return total, metrics
