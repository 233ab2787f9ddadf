"""The full DESIRE model at inference: SGM sampler + scene context + IOC
rank-and-refine (PyTorch port of ``desire_tpu/models/desire.py``).

Batch convention: xy (B, T, A, 2), mask (B, T, A), ids (B, A); id 0 marks
an empty agent slot. Agents are flattened into rows (N = B*A) for the
per-agent work and keep their (B, A) structure where they interact.
"""

from __future__ import annotations

import torch

from desire_tpu.config import DesireConfig
from desire_tpu_torch import ops
from desire_tpu_torch.models import ioc as ioc_mod
from desire_tpu_torch.models import losses
from desire_tpu_torch.models import scf as scf_mod
from desire_tpu_torch.models import sgm as sgm_mod


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


@torch.inference_mode()
def desire_forward(params, cfg: DesireConfig, xy, mask, ids, *, eps=None,
                   generator=None, k_samples=None, train=False,
                   kernel_weights=None):
    """End-to-end inference forward. Returns a dict of the stage outputs.

    eps: optional latent noise (B*A, K, lat); else drawn from generator.
    kernel_weights: from :func:`pack_kernel_weights` for these params;
    without them each kernel call packs its own.
    A model with cfg.scene_image_channels > 0 sees a zero imagery raster."""
    if train:
        raise NotImplementedError("the training forward is not ported")
    if cfg.mesh_data * cfg.mesh_k > 1:
        raise NotImplementedError("meshed execution is not ported")
    K = k_samples or cfg.num_samples
    xy = xy.float()
    mask = mask.float()
    b, _, a, _ = xy.shape
    obs_xy, fut_xy, obs_mask, fut_mask = split_batch(cfg, xy, mask)
    live = losses.agent_validity_mask(ids)
    n = b * a
    packed = kernel_weights or {}
    out = sgm_mod.sgm_forward(
        params["sgm"], cfg, obs_xy.reshape(n, *obs_xy.shape[2:]),
        obs_mask.reshape(n, -1), eps=eps, generator=generator, k_samples=K,
        sampler_weights=packed.get("sgm"))

    tf_len = fut_xy.shape[2]
    traj = out["traj_mu"].reshape(b, a, K, tf_len, 2)
    dec_h = out["dec_h"].reshape(b, a, K, tf_len, -1)
    result = {
        "raw5": out["raw5"].reshape(b, a, K, tf_len, 5),
        "sgm_traj": traj,
        "zp_mu": (None if out["zp_mu"] is None
                  else out["zp_mu"].reshape(b, a, -1)),
        "zp_logvar": (None if out["zp_logvar"] is None
                      else out["zp_logvar"].reshape(b, a, -1)),
        "live": live, "obs_xy": obs_xy, "fut_xy": fut_xy,
        "obs_mask": obs_mask, "fut_mask": fut_mask,
    }
    if not cfg.use_ioc:
        result.update(refined_traj=traj, scores=None)
        return result

    cd = sgm_mod.compute_dtype(cfg)
    if cfg.use_scf:
        image = None
        if cfg.scene_image_channels:
            image = torch.zeros(
                (b, cfg.scene_grid, cfg.scene_grid, cfg.scene_image_channels),
                device=xy.device)
        feat_map = scf_mod.scene_feature_map(
            params["scf"], obs_xy.transpose(1, 2), obs_mask.transpose(1, 2),
            cfg.scene_grid, compute_dtype=cd, image=image)
    else:
        # IOC without scene context: a zero map keeps the fusion layout
        feat_map = torch.zeros(
            (b, cfg.scene_grid, cfg.scene_grid, cfg.scene_channels),
            dtype=cd, device=xy.device)

    if uses_fused_ioc(cfg):
        refined, scores = ops.ioc_refine(
            params["ioc"], params["scf"], traj.contiguous(),
            dec_h.contiguous(), feat_map.contiguous(), live.contiguous(),
            fut_mask.contiguous(), num_refine=max(cfg.num_refine, 1),
            delta_scale=ioc_mod._DELTA_SCALE,
            social_freeze=cfg.social_freeze, weights=packed.get("ioc"))
    else:
        refined, scores, _ = ioc_mod.ioc_forward(
            params["ioc"], params["scf"], cfg, traj, dec_h, feat_map, live,
            fut_mask)
    result.update(refined_traj=refined, scores=scores)
    return result
