"""Scene Context Fusion (PyTorch port of ``desire_tpu/models/scf.py``).

Observed positions of all agents are splatted onto a G x G occupancy grid,
a small CNN turns it into a (B, G, G, C) feature map, and hypothesis
positions pool from it bilinearly. Social context is a distance-kernel
attention over the agents of one hypothesis lane and step.

``bilinear_pool``, ``social_messages``, ``social_pool`` and
``fuse_context`` serve the layer-by-layer IOC path (``models/ioc.
ioc_forward``); the fused IOC kernel computes the same context inside its
own loop. With ``cfg.use_pallas`` that path pools the scene through the
scene-pool kernels (``ops.bilinear_pool``), else through ``bilinear_pool``
here, which keeps the XLA path's numerics (weights not rounded).
"""

from __future__ import annotations

import torch

from desire_tpu_torch import ops
from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.models import layers as L
from desire_tpu_torch.ops import scene_pool


def init_scf(generator, cfg: DesireConfig, device, dtype=torch.float32):
    c = cfg.scene_channels
    c_in = 2 + cfg.scene_image_channels
    kw = dict(device=device, dtype=dtype)
    return {
        "conv1": L.init_conv(generator, 3, 3, c_in, c, **kw),
        "gn1": L.init_groupnorm(c, **kw),
        "conv2": L.init_conv(generator, 3, 3, c, c, **kw),
        "gn2": L.init_groupnorm(c, **kw),
        "soc_msg": L.init_dense(generator, cfg.d_dim, cfg.d_dim, **kw),
        "soc_logtau": torch.zeros((), **kw),
    }


def rasterize_occupancy(obs_xy, obs_mask, grid):
    """(B, To, A, 2) normalized positions -> (B, G, G, 2) raster: channel 0
    time-integrated occupancy, channel 1 last-step occupancy. A bilinear
    splat onto the nodes bilinear_pool samples from, by scatter-add
    (``index_add_``; its order of addition on CUDA is not fixed)."""
    b, t, a, _ = obs_xy.shape
    idx, cw, _, _ = scene_pool.corners(obs_xy, grid)
    last = torch.zeros_like(obs_mask)
    last[:, -1] = obs_mask[:, -1]
    w = torch.stack([obs_mask, last], -1)                 # (B, To, A, 2)
    flat = torch.zeros((b * grid * grid, 2), dtype=obs_xy.dtype,
                       device=obs_xy.device)
    base = (torch.arange(b, device=obs_xy.device) * grid * grid)[:, None,
                                                                 None]
    for ii, ww in zip(idx, cw):
        flat.index_add_(0, (base + ii).reshape(-1),
                        (w * ww[..., None]).reshape(-1, 2))
    return (flat / t).reshape(b, grid, grid, 2)


def scene_feature_map(p, obs_xy, obs_mask, grid, compute_dtype=torch.float32,
                      image=None):
    """Occupancy raster (+ optional imagery channels) -> 2-layer CNN ->
    (B, G, G, C). The splat runs in float32, the CNN in compute_dtype."""
    raster = rasterize_occupancy(obs_xy.float(), obs_mask.float(), grid)
    if image is not None:
        if tuple(image.shape[1:3]) != tuple(raster.shape[1:3]):
            raise ValueError(f"scene image {tuple(image.shape)} must match "
                             f"the {grid}x{grid} grid")
        raster = torch.cat([raster, image.to(raster.dtype)], dim=-1)
    raster = raster.to(compute_dtype)
    h = torch.relu(L.groupnorm(p["gn1"], L.conv2d(p["conv1"], raster)))
    return torch.relu(L.groupnorm(p["gn2"], L.conv2d(p["conv2"], h)))


def bilinear_pool(feat_map, pos):
    """Sample (B, G, G, C) bilinearly (align corners) at positions
    (B, P, 2) in [0, 1]. Returns (B, P, C)."""
    b, g, _, c = feat_map.shape
    flat = feat_map.reshape(b, g * g, c)
    idx, w, _, _ = scene_pool.corners(pos, g)

    def gather(ii):
        return torch.take_along_dim(flat, ii[..., None], dim=1)

    return (gather(idx[0]) * w[0][..., None] + gather(idx[1]) * w[1][..., None]
            + gather(idx[2]) * w[2][..., None]
            + gather(idx[3]) * w[3][..., None])


def social_messages(p, dec_h):
    """Project decoder hiddens to social messages (pass-invariant)."""
    return L.dense(p["soc_msg"], dec_h)


def social_pool(p, traj, msg, live):
    """Distance-kernel attention over agents, per lane and step.

    traj (B, A, K, Tf, 2), msg (B, A, K, Tf, d), live (B, A). Returns
    (B, A, K, Tf, d): each agent's kernel-weighted sum of the other live
    agents' messages; rows with no live neighbour are zero. Runs in the
    message dtype, as the JAX package's plain path does."""
    b, a, k, tf, d = msg.shape
    traj = traj.to(msg.dtype)
    y = traj.permute(0, 2, 3, 1, 4).reshape(b, k * tf, a, 2)
    m = msg.permute(0, 2, 3, 1, 4).reshape(b, k * tf, a, d)
    sq = (y * y).sum(dim=-1)
    gram = y @ y.transpose(-1, -2)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * gram
    tau = torch.exp(p["soc_logtau"]).to(d2.dtype) + 1e-4
    logits = -d2 / tau
    eye = torch.eye(a, dtype=torch.bool, device=msg.device)
    livej = (live[:, None, None, :] > 0)
    logits = torch.where(eye | ~livej, torch.full_like(logits, -1e9), logits)
    w = torch.softmax(logits, dim=-1)
    any_nb = (~eye & livej).to(d2.dtype).sum(dim=-1) > 0
    w = w * any_nb[..., None]
    out = w @ m
    return out.reshape(b, k, tf, a, d).permute(0, 3, 1, 2, 4)


def fuse_context(p, cfg: DesireConfig, traj, msg, feat_map, live,
                 social=None):
    """The (velocity, scene, social) blocks per (agent, lane, step), in the
    message dtype. social: a precomputed social block (social_freeze)."""
    vel = torch.diff(traj, dim=-2, prepend=traj[..., :1, :]).to(msg.dtype)
    b, a, k, tf, _ = traj.shape
    pool = ops.bilinear_pool if cfg.use_pallas else bilinear_pool
    scene = pool(feat_map, traj.reshape(b, a * k * tf, 2))
    scene = scene.reshape(b, a, k, tf, -1).to(msg.dtype)
    if social is None and cfg.use_social:
        social = social_pool(p, traj, msg, live)
    return vel, scene, social
