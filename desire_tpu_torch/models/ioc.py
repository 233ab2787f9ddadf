"""IOC ranking and refinement (PyTorch port of ``desire_tpu/models/ioc.py``).

A score GRU runs over each hypothesis' fused context (velocity, scene,
social, decoder hidden) and emits a per-step reward psi; the hypothesis
score is the future-mask-weighted sum of rewards. A gated, tanh-bounded
delta head refines the hypothesis, ``num_refine`` times, and a final pass
re-scores the refined trajectory.

This is the layer-by-layer path; with ``cfg.use_pallas`` and social
pooling on, the model runs the fused kernels of ``ops/ioc_fused.py`` (and,
in training with ``cfg.fused_train``, ``ops/ioc_bwd.py``) instead. On this
path ``cfg.use_pallas`` pools the scene through the scene-pool kernels
(``scf.fuse_context``). It differentiates like the JAX version: the final
re-score reads the refined positions detached, so the ranking loss never
moves a hypothesis. ``cfg.remat`` recomputes each refinement pass in the
backward instead of keeping its activations.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.models import layers as L
from desire_tpu_torch.models import scf

# deltas are tanh-bounded and scaled by this (times a learned sigmoid gate)
_DELTA_SCALE = 0.1


def init_ioc(generator, cfg: DesireConfig, device, dtype=torch.float32):
    feat_dim = 2 + cfg.scene_channels + 2 * cfg.d_dim
    kw = dict(device=device, dtype=dtype)
    return {
        "gru": L.init_gru_stack(generator, feat_dim, cfg.d_dim, 1, **kw),
        "score": L.init_dense(generator, cfg.d_dim, 1, **kw),
        # zero-init delta and gate: refinement starts as the identity
        "delta": L.zeros_dense(cfg.d_dim, 2, **kw),
        "gate": L.zeros_dense(cfg.d_dim, 1, **kw),
    }


def score_and_delta(p, feats, dec_h, fut_mask, scene_channels):
    """Run the score GRU over one hypothesis set. feats: the (vel, scene,
    social) blocks of scf.fuse_context, each (B, A, K, Tf, ·) or None.
    Returns scores (B, A, K), deltas (B, A, K, Tf, 2), hiddens."""
    vel, scene, social = feats
    b, a, k, tf, _ = vel.shape
    gp = p["gru"][0]
    if social is None:
        soc_dim = gp["wi"].shape[0] - 2 - scene_channels - dec_h.shape[-1]
        social = vel.new_zeros(vel.shape[:-1] + (soc_dim,))
    fused = torch.cat([vel, scene, social, dec_h.to(vel.dtype)], dim=-1)
    xs = fused.reshape(b * a * k, tf, -1).transpose(0, 1)
    h0 = vel.new_zeros((b * a * k, gp["wh"].shape[0]))
    _, hs = L.gru_scan(gp, h0, xs)
    hs = hs.transpose(0, 1).reshape(b, a, k, tf, -1)
    psi = L.dense(p["score"], hs)[..., 0]
    m = fut_mask.to(psi.dtype)[:, :, None, :]
    scores = (psi * m).sum(dim=-1)
    gate = torch.sigmoid(L.dense(p["gate"], hs))
    deltas = torch.tanh(L.dense(p["delta"], hs)) * gate * _DELTA_SCALE
    deltas = deltas * m[..., None]
    return scores, deltas, hs


def ioc_forward(p_ioc, p_scf, cfg: DesireConfig, traj, dec_h, feat_map,
                live, fut_mask, num_refine=None):
    """Iterative rank-and-refine.

    traj (B, A, K, Tf, 2) f32, dec_h (B, A, K, Tf, d), feat_map (B, G, G, C),
    live (B, A), fut_mask (B, A, Tf). Returns (refined_traj, scores,
    per_iter): at least one refinement pass runs, and the scores come from
    a final pass over the refined trajectory."""
    iters = cfg.num_refine if num_refine is None else num_refine
    traj = traj.float()
    traj0 = traj
    msg = scf.social_messages(p_scf, dec_h) if cfg.use_social else dec_h
    social0 = (scf.social_pool(p_scf, traj0, msg, live)
               if (cfg.use_social and cfg.social_freeze) else None)

    def one_iter(traj, msg, social0):
        feats = scf.fuse_context(p_scf, cfg, traj, msg, feat_map, live,
                                 social=social0)
        _, deltas, _ = score_and_delta(p_ioc, feats, dec_h, fut_mask,
                                       cfg.scene_channels)
        return traj + deltas.float()

    step = one_iter
    if cfg.remat and torch.is_grad_enabled():
        # recompute each pass in the backward instead of keeping its
        # (B, K*T, A, A) social attention; a pass draws no random numbers
        step = functools.partial(checkpoint, one_iter, use_reentrant=False,
                                 preserve_rng_state=False)
    per_iter = []
    for _ in range(max(iters, 1)):
        traj = step(traj, msg, social0)
        per_iter.append(traj)
    # the re-score judges the hypotheses and must not move them: its
    # positions are detached (under social_freeze its social block is
    # re-pooled at the detached initial positions, same value as social0)
    social_sc = None
    if social0 is not None:
        social_sc = scf.social_pool(p_scf, traj0.detach(), msg, live)
    feats = scf.fuse_context(p_scf, cfg, traj.detach(), msg, feat_map, live,
                             social=social_sc)
    scores, _, _ = score_and_delta(p_ioc, feats, dec_h, fut_mask,
                                   cfg.scene_channels)
    return traj, scores, per_iter
