"""Sample Generation Module (SGM): the CVAE trajectory sampler (PyTorch
port of ``desire_tpu/models/sgm.py``).

Agents are flattened into rows (N = B*A) and the K hypothesis lanes are a
second batch dimension. Positions stay float32 throughout; only network
activations run in the compute dtype.

At inference every lane draws z from the (conditional) prior. In training
the future is encoded too, the recognition network gives the posterior
q(z | X, Y), the first round(K * prior_lane_frac) lanes draw from the
prior (their noise scaled by the learned temperature) and the rest from the
posterior, and the embedded encoder inputs get inverted dropout; with
``cfg.remat`` the mask decoder is recomputed in the backward. All
randomness is an input: the latent noise ``eps`` and the dropout keep-masks
may be passed in, else they are drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch import ops
from desire_tpu_torch.models import layers as L


def compute_dtype(cfg: DesireConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def init_sgm(generator, cfg: DesireConfig, device, dtype=torch.float32):
    """Same keys and shapes as the JAX ``init_sgm``; values are this
    package's own draws."""
    g = generator
    d, emb, cm = cfg.d_dim, cfg.embedding_size, cfg.channel_multiplier
    side, lat = cfg.vae_side, cfg.latent_size
    in_f = 5 if cfg.input_norm else 4
    kw = dict(device=device, dtype=dtype)
    p = {
        "embed_x": L.init_dense(g, in_f, emb, **kw),
        "embed_y": L.init_dense(g, in_f, emb, **kw),
        "enc_x": L.init_gru_stack(g, emb, d, cfg.num_layers, **kw),
        "enc_y": L.init_gru_stack(g, emb, d, cfg.num_layers, **kw),
        "temporal_w": L.glorot(g, (cfg.obs_len, 2, cm), **kw),
        "temporal_b": torch.zeros((2 * cm,), **kw),
        "fuse": L.init_dense(g, 2 * d, cfg.vae_input_size, **kw),
        "post_vae": L.init_dense(g, cfg.vae_input_size, d, **kw),
        "z_gate": L.init_dense(g, lat, d, **kw),
        "z_skip": L.init_dense(g, lat, d, **kw),
        "rho_proj": L.init_dense(g, 2 * cm, d, **kw),
        "dec": L.init_gru_stack(g, d, d, cfg.num_layers, **kw),
        # near-zero head: an untrained model predicts about the
        # constant-velocity extrapolation
        "head": L.init_dense(g, d, 5, scale=0.05, **kw),
    }
    if cfg.cond_prior:
        p["prior"] = L.zeros_dense(d, 2 * lat, **kw)
    if cfg.speed_norm and cfg.learn_bound:
        p["vel_gain_log"] = torch.tensor(math.log(cfg.vel_gain), **kw)
        p["vel_floor_log"] = torch.tensor(math.log(cfg.vel_floor), **kw)
        if cfg.aniso_bound:
            p["vel_gain_cross_log"] = torch.tensor(math.log(cfg.vel_gain),
                                                   **kw)
    if cfg.pace_range > 0:
        p["pace"] = L.zeros_dense(d, 1, **kw)
    if cfg.z_temp_learn:
        p["ztemp_fc1"] = L.init_dense(g, 1, 8, **kw)
        p["ztemp_fc2"] = L.zeros_dense(8, 1, **kw)
    if side == 32:
        # conv recognition network (run only by training)
        p.update({
            "venc1": L.init_conv(g, 5, 5, 1, 32, **kw),
            "vgn1": L.init_groupnorm(32, **kw),
            "venc2": L.init_conv(g, 5, 5, 32, 64, **kw),
            "vgn2": L.init_groupnorm(64, **kw),
            "venc3": L.init_conv(g, 5, 5, 64, 128, **kw),
            "vgn3": L.init_groupnorm(128, **kw),
            "venc_fc": L.init_dense(g, (side // 8) * (side // 8) * 128,
                                    2 * lat, **kw),
        })
    else:
        hid = max(4 * lat, side * side // 2)
        p.update({
            "venc_fc1": L.init_dense(g, side * side, hid, **kw),
            "venc_fc": L.init_dense(g, hid, 2 * lat, **kw),
        })
    if side == 32 and cfg.vae_dec == "conv":
        p.update({
            "vdec1": L.init_conv(g, 4, 4, lat, 128, **kw),
            "vdgn1": L.init_groupnorm(128, **kw),
            "vdec2": L.init_conv(g, 5, 5, 128, 64, **kw),
            "vdgn2": L.init_groupnorm(64, **kw),
            "vdec3": L.init_conv(g, 5, 5, 64, 32, **kw),
            "vdgn3": L.init_groupnorm(32, **kw),
            "vdec4": L.init_conv(g, 5, 5, 32, 1, **kw),
        })
    else:
        hid = max(4 * lat, side * side // 2)
        p.update({
            "vdec_fc1": L.init_dense(g, lat, hid, **kw),
            "vdec_fc": L.init_dense(g, hid, side * side, **kw),
        })
    return p


def temporal_features(p, rel_xy, obs_mask):
    """rho: full-window depthwise temporal conv + ReLU. rel_xy (N, To, 2),
    obs_mask (N, To) -> (N, 2*cm)."""
    x = rel_xy * obs_mask[..., None]
    feat = torch.einsum("ntc,tcm->ncm", x, p["temporal_w"].to(x.dtype))
    feat = feat.reshape(feat.shape[0], -1) + p["temporal_b"].to(x.dtype)
    return torch.relu(feat)


def _traj_feats(xy_rel, mask, extra=None):
    """Per-step [position, velocity(, extra)] features, masked."""
    d = torch.diff(xy_rel, dim=1, prepend=xy_rel[:, :1])
    fs = [xy_rel, d]
    if extra is not None:
        fs.append(extra[:, None].expand(xy_rel.shape[:2] + extra.shape[-1:]))
    return torch.cat(fs, -1) * mask[..., None]


def encode_trajectory(stack, embed_p, xy_rel, mask, extra=None, keep=None,
                      keep_prob=1.0):
    """GRU-encode (N, T, 2) trajectories; masked steps carry the state.
    keep: optional 0/1 mask of the embedded features (N, T, emb) for
    inverted dropout (kept features are scaled by 1 / keep_prob).
    Returns (top-layer final hidden (N, H), all finals (L, N, H))."""
    feats = torch.relu(L.dense(embed_p, _traj_feats(xy_rel, mask,
                                                    extra=extra)))
    if keep is not None and keep_prob < 1.0:
        feats = feats * keep.to(feats.dtype) / keep_prob
    xs = feats.transpose(0, 1)
    m = mask.transpose(0, 1)
    h0 = xs.new_zeros((len(stack), xs.shape[1], stack[0]["wh"].shape[0]))
    finals, _ = L.gru_stack_scan(stack, h0, xs, mask=m)
    return finals[-1], finals


def vae_encode(p, hx, hy, side):
    """Recognition network q(z | X, Y): the fused encodings through the
    conv stack (vae side 32, the reference geometry) or an MLP (any other
    side) -> (mu, logvar), each (N, latent)."""
    fused = torch.relu(L.dense(p["fuse"], torch.cat([hx, hy], -1)))
    if "venc1" in p:
        img = fused.reshape(-1, side, side, 1)
        h = F.elu(L.groupnorm(p["vgn1"], L.conv2d(p["venc1"], img,
                                                  stride=2)))
        h = F.elu(L.groupnorm(p["vgn2"], L.conv2d(p["venc2"], h, stride=2)))
        h = F.elu(L.groupnorm(p["vgn3"], L.conv2d(p["venc3"], h,
                                                  padding="VALID")))
        h = h.reshape(h.shape[0], -1)
    else:
        h = F.elu(L.dense(p["venc_fc1"], fused))
    mu, logvar = L.dense(p["venc_fc"], h).chunk(2, dim=-1)
    return mu, logvar


def vae_decode_mask(p, z, side):
    """Latent z (M, latent) -> 'reconstruction' (M, side * side) ->
    softmax mask beta (M, d), rescaled to mean 1. The reconstruction is the
    deconv stack where the model has one (vae_dec='conv', side 32: 1 x 1
    -> 4 x 4 x 128 -> 8 x 8 x 64 -> 16 x 16 x 32 -> 32 x 32 x 1, group
    norm and ELU between, a sigmoid last), else an MLP."""
    if "vdec1" in p:
        h = z[:, None, None, :]
        h = F.elu(L.groupnorm(p["vdgn1"], L.deconv2d(p["vdec1"], h,
                                                     padding="VALID")))
        h = F.elu(L.groupnorm(p["vdgn2"], L.deconv2d(p["vdec2"], h,
                                                     padding="VALID")))
        h = F.elu(L.groupnorm(p["vdgn3"], L.deconv2d(p["vdec3"], h,
                                                     stride=2)))
        h = torch.sigmoid(L.deconv2d(p["vdec4"], h, stride=2))
        recon = h.reshape(h.shape[0], -1)
    else:
        h = F.elu(L.dense(p["vdec_fc1"], z))
        recon = torch.sigmoid(L.dense(p["vdec_fc"], h))
    d = p["post_vae"]["w"].shape[-1]
    logits = L.dense(p["post_vae"], recon) + L.dense(p["z_gate"], z)
    beta = torch.softmax(logits, dim=-1) * d
    return beta, recon


def decode_hypotheses(p, h_seed, h_init, pred_len):
    """K-lane GRU decoder fed h_seed at every step. h_seed (M, d), h_init
    (L, M, d). Returns raw (M, Tf, 5) head outputs and hiddens (M, Tf, d)."""
    m, d = h_seed.shape
    if len(p["dec"]) == 1:
        _, hs = L.gru_scan_const_x(p["dec"][0], h_init[0], h_seed, pred_len)
    else:
        xs = h_seed.expand(pred_len, m, d)
        _, hs = L.gru_stack_scan(p["dec"], h_init, xs)
    raw = L.dense(p["head"], hs)
    return raw.transpose(0, 1), hs.transpose(0, 1)


def compose_positions(raw, origin, vel_scale=0.25, cv_vel=None,
                      vel_bound=None, vel_bound_cross=None, heading=None):
    """Velocity residuals around constant velocity -> absolute position
    Gaussians: mu_t = origin + cv_vel * t + cumsum(tanh(dv) * bound).
    raw (..., Tf, 5) -> raw5 with absolute means in channels 0:2."""
    bound = vel_scale if vel_bound is None else vel_bound[..., None, :]
    if heading is not None:
        ca = heading[..., None, 0:1]
        sa = heading[..., None, 1:2]
        va = torch.tanh(raw[..., 0:1]) * bound
        vc = torch.tanh(raw[..., 1:2]) * vel_bound_cross[..., None, :]
        vel = torch.cat([va * ca - vc * sa, va * sa + vc * ca], dim=-1)
    else:
        vel = torch.tanh(raw[..., 0:2]) * bound
    mu = origin[..., None, :] + torch.cumsum(vel, dim=-2)
    if cv_vel is not None:
        t = torch.arange(1, raw.shape[-2] + 1, dtype=mu.dtype,
                         device=mu.device)
        mu = mu + cv_vel[..., None, :] * t[:, None]
    return torch.cat([mu, raw[..., 2:]], dim=-1)


def _lane_cv(p, cfg, cv_vel, dec_h):
    """Per-lane constant-velocity base (N, K, 2), scaled by the pace head
    when the model has one."""
    cv_k = cv_vel[:, None, :]
    if "pace" in p:
        pace = 1.0 + cfg.pace_range * torch.tanh(
            L.dense(p["pace"], dec_h[:, :, 0].float()))
        if cfg.pace_lanes > 0:
            k = dec_h.shape[1]
            lane_on = (torch.arange(k, device=pace.device)
                       >= k - cfg.pace_lanes).to(pace.dtype)[None, :, None]
            pace = 1.0 + (pace - 1.0) * lane_on
        cv_k = cv_k * pace
    return cv_k


def observed_speed(rel_obs, obs_mask):
    """Masked mean step speed over the observed window -> (N, 1)."""
    both = obs_mask[:, 1:] * obs_mask[:, :-1]
    d = torch.linalg.norm(torch.diff(rel_obs, dim=1), dim=-1) * both
    steps = torch.clamp(both.sum(dim=1), min=1e-6)
    return (d.sum(dim=1) / steps)[..., None]


def mean_observed_velocity(rel_obs, obs_mask):
    """Masked mean step velocity over the observed window -> (N, 2)."""
    both = obs_mask[:, 1:] * obs_mask[:, :-1]
    d = torch.diff(rel_obs, dim=1) * both[..., None]
    steps = torch.clamp(both.sum(dim=1), min=1e-6)
    return d.sum(dim=1) / steps[..., None]


def _residual_envelope(p, cfg, rel_obs, obs_mask, cv_vel):
    """(vel_bound (N, 1, 1) or None, cross bound or None, heading (N, 1, 2)
    or None) for compose_positions."""
    if not cfg.speed_norm:
        return None, None, None
    s = observed_speed(rel_obs, obs_mask)
    if "vel_gain_log" in p:
        gain = torch.exp(p["vel_gain_log"]).to(s.dtype)
        floor = torch.exp(p["vel_floor_log"]).to(s.dtype)
    else:
        gain, floor = cfg.vel_gain, cfg.vel_floor
    vel_bound = (gain * s + floor)[:, None]
    if "vel_gain_cross_log" not in p:
        return vel_bound, None, None
    gain_c = torch.exp(p["vel_gain_cross_log"]).to(s.dtype)
    bound_c = (gain_c * s + floor)[:, None]
    nrm = torch.linalg.norm(cv_vel, dim=-1, keepdim=True)
    # (1, 0) made on the device: a copy from the host would stop the
    # graphed training step's capture (train/graphed.py)
    unit_x = torch.nn.functional.pad(torch.ones_like(nrm), (0, 1))
    u = torch.where(nrm > 1e-6, cv_vel / torch.clamp(nrm, min=1e-6), unit_x)
    return vel_bound, bound_c, u[:, None, :]


def _learned_z_temp(p, cfg, rel_obs, obs_mask):
    """Learned speed-conditioned latent temperature in [1/3, 3], (N, 1, 1),
    or None when the model has no such head."""
    if "ztemp_fc1" not in p:
        return None
    s = observed_speed(rel_obs, obs_mask)
    f = torch.log1p(s / cfg.vel_floor).float()
    lt = L.dense(p["ztemp_fc2"], torch.tanh(L.dense(p["ztemp_fc1"], f)))
    cap = 1.0986123  # log 3
    return torch.exp(cap * torch.tanh(lt / cap))[..., None]


def uses_fused_sampler(p, cfg: DesireConfig) -> bool:
    """Whether sgm_forward samples through the fused sampler (one-layer
    GRUs, MLP mask decoder) rather than layer by layer."""
    return cfg.use_pallas and cfg.num_layers == 1 and "vdec_fc1" in p


def _keep_mask(keep, shape, keep_prob, generator, device):
    """Inverted-dropout keep mask of ``shape``: the given one, else drawn
    from ``generator``; None when nothing is dropped."""
    if keep_prob >= 1.0:
        return None
    if keep is None:
        keep = torch.rand(shape, generator=generator, device=device) < keep_prob
    if tuple(keep.shape) != tuple(shape):
        raise ValueError(f"keep mask must be {tuple(shape)}, got "
                         f"{tuple(keep.shape)}")
    return keep


def sgm_forward(p, cfg: DesireConfig, obs_xy, obs_mask, fut_xy=None,
                fut_mask=None, *, eps=None, generator=None, k_samples=None,
                train=False, keep_x=None, keep_y=None, sampler_weights=None,
                z_temp=None, mesh=None):
    """SGM pass over flattened agent rows.

    obs_xy (N, To, 2) absolute normalized, obs_mask (N, To); in training
    also fut_xy (N, Tf, 2) and fut_mask (N, Tf). The latent noise is
    ``eps`` (N, K, lat) when given, else drawn from ``generator``, and so
    are the training dropout keep-masks ``keep_x`` (N, To, emb) and
    ``keep_y`` (N, Tf, emb) of the observed and future encoders.

    Inference: every lane draws z = mu_p + sigma_p * eps from the
    (conditional) prior, eps scaled by the learned temperature when the
    model has one. Training: z = mu + sigma * eps from the posterior, except
    the first round(K * prior_lane_frac) lanes, which draw from the prior
    with the temperature-scaled noise. z_temp: optional (N, 1, 1)
    per-agent temperature of the inference draws (an eval-time spread knob,
    z = mu_p + sigma_p * z_temp * eps), times the learned temperature where
    the model has one; ignored in training. sampler_weights: the fused
    sampler's kernel weights (``ops.pack_sampler``), packed per call when
    not given. mesh: a ``parallel.mesh.Mesh``; the rows given are then the
    rank's, eps holds every lane of them, the rank samples its block of
    the lanes (``mesh.lanes(K)``) and the outputs hold those alone.
    Returns a dict of absolute-position Gaussians for K hypotheses."""
    K = k_samples or cfg.num_samples
    n = obs_xy.shape[0]
    lat = cfg.latent_size
    pred_len = fut_xy.shape[1] if fut_xy is not None else cfg.pred_len
    cd = compute_dtype(cfg)
    if train and (fut_xy is None or fut_mask is None):
        raise ValueError("the training branch needs fut_xy and fut_mask")

    obs_xy = obs_xy.float()
    obs_mask = obs_mask.float()
    origin = obs_xy[:, -1]
    rel_obs = (obs_xy - origin[:, None]) * obs_mask[..., None]

    enc_rel, enc_extra, inv_scale = rel_obs, None, None
    if cfg.input_norm:
        s_obs = observed_speed(rel_obs, obs_mask)
        inv_scale = 1.0 / (s_obs + cfg.vel_floor)
        enc_rel = rel_obs * inv_scale[:, None]
        enc_extra = torch.log1p(s_obs / cfg.vel_floor).to(cd)

    rho = temporal_features(p, enc_rel.to(cd), obs_mask.to(cd))
    rho_seed = torch.relu(L.dense(p["rho_proj"], rho))

    # the learned temperature: at inference it multiplies the given one; in
    # training it scales only the prior lanes' noise
    lt = _learned_z_temp(p, cfg, rel_obs, obs_mask)
    if not train and lt is not None:
        z_temp = lt if z_temp is None else z_temp * lt

    if eps is None:
        eps = torch.randn((n, K, lat), generator=generator,
                          device=obs_xy.device)
    eps = eps.to(cd)
    if eps.shape != (n, K, lat):
        raise ValueError(f"eps must be {(n, K, lat)}, got {tuple(eps.shape)}")

    mu = logvar = None
    if not train and uses_fused_sampler(p, cfg):
        if z_temp is not None:
            eps = eps * z_temp.to(cd)
        feats = torch.relu(L.dense(
            p["embed_x"], _traj_feats(enc_rel.to(cd), obs_mask.to(cd),
                                      extra=enc_extra)))
        args = (p, feats.contiguous(), obs_mask.contiguous(),
                rho_seed.float().contiguous(), eps.contiguous(), pred_len)
        kw = dict(compute_dtype=cd, weights=sampler_weights)
        if mesh is None:
            dec_h_f32, hx = ops.sgm_sample_decode(*args, **kw)
        else:
            dec_h_f32, hx = ops.sgm_sample_decode_sharded(mesh, *args, **kw)
        mu_p = logvar_p = None
        if "prior" in p:
            mu_p, lv_raw = L.dense(p["prior"], hx.to(cd)).chunk(2, dim=-1)
            logvar_p = 4.0 * torch.tanh(lv_raw / 4.0)
        dec_h = dec_h_f32.to(cd)
        raw = L.dense(p["head"], dec_h)
        lane_h = dec_h_f32
    else:
        if mesh is not None:
            # the rank's lanes (the JAX layout hint on z)
            eps = eps[:, mesh.lanes(K)]
            K = eps.shape[1]
        kp = cfg.keep_prob if train else 1.0
        emb = cfg.embedding_size
        dev = obs_xy.device
        hx, hx_all = encode_trajectory(
            p["enc_x"], p["embed_x"], enc_rel.to(cd), obs_mask.to(cd),
            extra=enc_extra, keep_prob=kp,
            keep=_keep_mask(keep_x, (n, obs_xy.shape[1], emb), kp,
                            generator, dev))
        mu_p = logvar_p = None
        if "prior" in p:
            mu_p, lv_raw = L.dense(p["prior"], hx).chunk(2, dim=-1)
            logvar_p = 4.0 * torch.tanh(lv_raw / 4.0)
        if train:
            fut_xy = fut_xy.float()
            fut_mask = fut_mask.float()
            rel_fut = (fut_xy - origin[:, None]) * fut_mask[..., None]
            if inv_scale is not None:
                rel_fut = rel_fut * inv_scale[:, None]
            hy, _ = encode_trajectory(
                p["enc_y"], p["embed_y"], rel_fut.to(cd), fut_mask.to(cd),
                extra=enc_extra, keep_prob=kp,
                keep=_keep_mask(keep_y, (n, pred_len, emb), kp, generator,
                                dev))
            mu, logvar = vae_encode(p, hx, hy, cfg.vae_side)
            eps = eps.to(hx.dtype)
            z = mu[:, None] + torch.exp(0.5 * logvar)[:, None] * eps
            k_prior = int(round(K * cfg.prior_lane_frac))
            if k_prior > 0:
                # the first lanes sample the prior, with the learned
                # temperature on their noise
                eps_pr = eps if lt is None else eps * lt.to(eps.dtype)
                z_pr = eps_pr
                if mu_p is not None:
                    z_pr = (mu_p[:, None]
                            + torch.exp(0.5 * logvar_p)[:, None] * eps_pr)
                z = torch.cat([z_pr[:, :k_prior], z[:, k_prior:]], dim=1)
        else:
            if z_temp is not None:
                eps = eps * z_temp.to(cd)
            z = eps
            if mu_p is not None:
                z = mu_p[:, None] + torch.exp(0.5 * logvar_p)[:, None] * eps
        z_flat = z.reshape(n * K, lat)
        if cfg.remat and torch.is_grad_enabled():
            # recompute the per-lane mask decoder in the backward instead of
            # keeping its (N*K, ...) activations
            beta, _ = checkpoint(vae_decode_mask, p, z_flat, cfg.vae_side,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            beta, _ = vae_decode_mask(p, z_flat, cfg.vae_side)
        h_seed = (beta * hx.repeat_interleave(K, dim=0)
                  + L.dense(p["z_skip"], z_flat)
                  + rho_seed.repeat_interleave(K, dim=0))
        h_init = hx_all.repeat_interleave(K, dim=1)
        raw, dec_h = decode_hypotheses(p, h_seed, h_init, pred_len)
        raw = raw.reshape(n, K, pred_len, 5)
        dec_h = dec_h.reshape(n, K, pred_len, -1)
        lane_h = dec_h

    cv_vel = mean_observed_velocity(rel_obs, obs_mask)
    vel_bound, bound_c, heading = _residual_envelope(p, cfg, rel_obs,
                                                     obs_mask, cv_vel)
    raw5 = compose_positions(raw.float(), origin[:, None, :], cfg.vel_scale,
                             cv_vel=_lane_cv(p, cfg, cv_vel, lane_h),
                             vel_bound=vel_bound, vel_bound_cross=bound_c,
                             heading=heading)
    return {
        "raw5": raw5, "traj_mu": raw5[..., 0:2], "dec_h": dec_h,
        "z_mu": mu, "z_logvar": logvar,
        "zp_mu": mu_p, "zp_logvar": logvar_p,
        "rho": rho, "hx": hx, "origin": origin,
    }
