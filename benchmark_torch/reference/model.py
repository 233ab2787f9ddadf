"""DESIRE in plain PyTorch: the benchmark's reference.

Float32 throughout, with no kernel, cache or batching trick: the SGM
sampler (GRU encoders, the conditional prior, the CVAE recognition
network in training, the latent mask decoder as an MLP or the four
transposed convolutions of the reference geometry, the K-lane GRU
decoder), the occupancy-raster scene CNN, the IOC rank-and-refine passes
(velocity, bilinear scene pooling, distance-kernel social attention, the
score GRU and its gated delta head), the multi-task loss, and the clipped
Adam update. It imports nothing of the program: it follows the model's
published equations (DESIRE, arXiv:1704.04394) as the configuration
fixes them, on the parameter tree of ``params.py``.

``prec`` is the precision of the activations, the layers' outputs and
the operands of every product: "f32" (the reference) or "fp8" (the
precision below the configured bfloat16: the control that has to fail
the comparison). Under "fp8" each such value is float8 e4m3 in the
forward pass, and the gradient that flows back through it is float8
e5m2, scaled by its largest magnitude, as FP8 training keeps gradients
(Micikevicius et al., arXiv:2209.05433). Positions, the recurrent states
and the softmax and norm statistics stay float32, as the configuration
keeps them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


class _Fp8(torch.autograd.Function):
    """The value in float8 e4m3 (clamped to its range); its gradient scaled
    into float8 e5m2's range by its largest magnitude, rounded, and scaled
    back."""

    @staticmethod
    def forward(ctx, x):
        x = torch.clamp(x, -_E4M3_MAX, _E4M3_MAX)
        return x.to(torch.float8_e4m3fn).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        amax = g.abs().amax()
        scale = torch.where(amax > 0, _E5M2_MAX / amax, torch.ones_like(amax))
        return (g * scale).to(torch.float8_e5m2).to(torch.float32) / scale


def rnd(x, prec):
    """x with the precision of a product's operand under ``prec``."""
    if prec == "f32":
        return x
    if prec == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"unknown precision {prec!r}")


def mm(a, b, prec):
    return rnd(a, prec) @ rnd(b, prec)


def dense(p, x, prec):
    """A dense layer; its output is an activation, stored in ``prec``."""
    return rnd(mm(x, p["w"], prec) + p["b"], prec)


def gru_cell(p, h, gi, prec):
    gh = dense({"w": p["wh"], "b": p["bh"]}, h, prec)
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_input(p, x, prec):
    return dense({"w": p["wi"], "b": p["bi"]}, x, prec)


def group_norm(p, prec, x, groups=8, eps=1e-5):
    """x (N, H, W, C): normalised over each group's channels and every
    position."""
    n, h, w, c = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    xg = x.reshape(n, h * w, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xg = (xg - mean) / torch.sqrt(var + eps)
    return rnd(xg.reshape(n, h, w, c) * p["scale"] + p["bias"], prec)


def conv(p, x, stride, pads, prec):
    """Cross-correlation of x (N, H, W, Ci) with the HWIO kernel, the input
    padded (top, bottom, left, right) with zeros."""
    xc = F.pad(rnd(x, prec).permute(0, 3, 1, 2),
               (pads[2], pads[3], pads[0], pads[1]))
    y = F.conv2d(xc, rnd(p["w"], prec).permute(3, 2, 0, 1), stride=stride)
    return rnd(y.permute(0, 2, 3, 1) + p["b"], prec)


def same_pads(size, k, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(p, x, stride, prec):
    k = p["w"].shape[0]
    ph = same_pads(x.shape[1], k, stride)
    pw = same_pads(x.shape[2], k, stride)
    return conv(p, x, stride, ph + pw, prec)


def conv_transpose(p, x, stride, padding, prec):
    """The transposed convolution of the reference implementation (the
    forward conv's gradient as TensorFlow and JAX define it, the kernel
    not flipped): the input dilated by the stride, padded (SAME: k + s - 2
    in all, the larger half low; VALID: k - 1 a side plus max(k - s, 0)
    high), correlated with the kernel. ``F.conv_transpose2d`` pads k - 1 a
    side and flips the kernel: it gets the kernel flipped, and its output
    is cut to those pads."""
    k = p["w"].shape[0]
    if padding == "SAME":
        total = k + stride - 2
        low = k - 1 if stride > k - 1 else -(-total // 2)
    else:
        total = k + stride - 2 + max(k - stride, 0)
        low = k - 1
    high = total - low
    w = rnd(p["w"], prec).permute(2, 3, 0, 1).flip(2, 3)
    y = F.conv_transpose2d(rnd(x, prec).permute(0, 3, 1, 2), w,
                           stride=stride)
    cut = (low - (k - 1), high - (k - 1))
    y = F.pad(y, cut + cut)
    return rnd(y.permute(0, 2, 3, 1) + p["b"], prec)


# -- SGM ----------------------------------------------------------------------

def observed_speed(rel, mask):
    both = mask[:, 1:] * mask[:, :-1]
    step = torch.linalg.norm(rel[:, 1:] - rel[:, :-1], dim=-1) * both
    return (step.sum(dim=1) / torch.clamp(both.sum(dim=1), min=1e-6))[:, None]


def observed_velocity(rel, mask):
    both = mask[:, 1:] * mask[:, :-1]
    step = (rel[:, 1:] - rel[:, :-1]) * both[..., None]
    return step.sum(dim=1) / torch.clamp(both.sum(dim=1), min=1e-6)[:, None]


def encode(p_embed, p_gru, rel, mask, extra, keep, keep_prob, prec):
    """GRU encoding of (N, T, 2) tracks: per step [position, velocity,
    log speed] embedded (ReLU), dropped out where ``keep`` is 0, and run
    through the GRU; a masked step carries the state. Returns the final
    state (N, H)."""
    vel = rel - torch.cat([rel[:, :1], rel[:, :-1]], dim=1)
    ex = extra[:, None].expand(rel.shape[0], rel.shape[1], 1)
    feats = torch.cat([rel, vel, ex], dim=-1) * mask[..., None]
    x = torch.relu(dense(p_embed, feats, prec))
    if keep is not None:
        x = x * keep.float() / keep_prob
    gi = gru_input(p_gru, x, prec)
    h = x.new_zeros((x.shape[0], p_gru["wh"].shape[0]))
    for t in range(x.shape[1]):
        h = torch.where(mask[:, t, None] > 0,
                        gru_cell(p_gru, h, gi[:, t], prec), h)
    return h


def recognition(p, hx, hy, prec):
    """q(z | X, Y): the fused encodings as a 32 x 32 image through three
    convolutions (5 x 5, stride 2, 2, 1 VALID; group norm and ELU after
    each) and a dense layer -> (mu, logvar)."""
    fused = torch.relu(dense(p["fuse"], torch.cat([hx, hy], dim=-1), prec))
    side = math.isqrt(fused.shape[-1])
    h = fused.reshape(-1, side, side, 1)
    h = F.elu(group_norm(p["vgn1"], prec, conv_same(p["venc1"], h, 2, prec)))
    h = F.elu(group_norm(p["vgn2"], prec, conv_same(p["venc2"], h, 2, prec)))
    h = F.elu(group_norm(p["vgn3"], prec, conv(p["venc3"], h, 1, (0, 0, 0, 0),
                                         prec)))
    mu, logvar = dense(p["venc_fc"], h.reshape(h.shape[0], -1),
                       prec).chunk(2, dim=-1)
    return mu, logvar


def mask_decoder(p, z, prec):
    """z (M, lat) -> the latent's reconstruction (M, side^2) -> the
    softmax mask over the hidden units, rescaled to mean 1."""
    if "vdec1" in p:
        h = z[:, None, None, :]
        h = F.elu(group_norm(p["vdgn1"], prec,
                             conv_transpose(p["vdec1"], h, 1, "VALID", prec)))
        h = F.elu(group_norm(p["vdgn2"], prec,
                             conv_transpose(p["vdec2"], h, 1, "VALID", prec)))
        h = F.elu(group_norm(p["vdgn3"], prec,
                             conv_transpose(p["vdec3"], h, 2, "SAME", prec)))
        h = torch.sigmoid(conv_transpose(p["vdec4"], h, 2, "SAME", prec))
        recon = h.reshape(h.shape[0], -1)
    else:
        recon = torch.sigmoid(dense(
            p["vdec_fc"], F.elu(dense(p["vdec_fc1"], z, prec)), prec))
    d = p["post_vae"]["w"].shape[-1]
    logits = dense(p["post_vae"], recon, prec) + dense(p["z_gate"], z, prec)
    return torch.softmax(logits, dim=-1) * d


def sgm(p, cfg, obs_xy, obs_mask, eps, *, fut_xy=None, fut_mask=None,
        keep_x=None, keep_y=None, prec="f32"):
    """The sampler over agent rows: obs (N, To, 2) absolute, masks, the
    latent noise eps (N, K, lat); training also fut (N, Tf, 2) and the
    dropout keep masks. Returns dict(raw5 (N, K, Tf, 5) with absolute
    means, dec_h (N, K, Tf, d), and in training the posterior and prior
    moments)."""
    train = fut_xy is not None
    n, k, lat = eps.shape
    tf = cfg["pred_len"]
    floor = cfg["vel_floor"]
    origin = obs_xy[:, -1]
    rel = (obs_xy - origin[:, None]) * obs_mask[..., None]
    speed = observed_speed(rel, obs_mask)
    inv = 1.0 / (speed + floor)
    extra = torch.log1p(speed / floor)
    kp = cfg["keep_prob"]
    hx = encode(p["embed_x"], p["enc_x"][0], rel * inv[:, None], obs_mask,
                extra, keep_x if train else None, kp, prec)
    feat = torch.einsum("ntc,tcm->ncm", rnd(rel * inv[:, None]
                                            * obs_mask[..., None], prec),
                        rnd(p["temporal_w"], prec))
    rho = torch.relu(feat.reshape(n, -1) + p["temporal_b"])
    rho_seed = torch.relu(dense(p["rho_proj"], rho, prec))
    mu_p, lv = dense(p["prior"], hx, prec).chunk(2, dim=-1)
    logvar_p = 4.0 * torch.tanh(lv / 4.0)
    # the learned latent temperature, in [1/3, 3]
    lt = dense(p["ztemp_fc2"], torch.tanh(dense(
        p["ztemp_fc1"], torch.log1p(speed / floor), prec)), prec)
    temp = torch.exp(math.log(3.0) * torch.tanh(lt / math.log(3.0)))
    eps_prior = eps * temp[:, :, None]
    z = mu_p[:, None] + torch.exp(0.5 * logvar_p)[:, None] * eps_prior
    out = {}
    if train:
        rel_f = (fut_xy - origin[:, None]) * fut_mask[..., None] * inv[:, None]
        hy = encode(p["embed_y"], p["enc_y"][0], rel_f, fut_mask, extra,
                    keep_y, kp, prec)
        mu, logvar = recognition(p, hx, hy, prec)
        z_post = mu[:, None] + torch.exp(0.5 * logvar)[:, None] * eps
        k_prior = int(round(k * cfg["prior_lane_frac"]))
        z = torch.cat([z[:, :k_prior], z_post[:, k_prior:]], dim=1)
        out.update(z_mu=mu, z_logvar=logvar, zp_mu=mu_p, zp_logvar=logvar_p)
    zf = z.reshape(n * k, lat)
    beta = mask_decoder(p, zf, prec)
    seed = (beta * hx.repeat_interleave(k, dim=0)
            + dense(p["z_skip"], zf, prec)
            + rho_seed.repeat_interleave(k, dim=0))
    dec = p["dec"][0]
    gi = gru_input(dec, seed, prec)
    h = hx.repeat_interleave(k, dim=0)
    hs = []
    for _ in range(tf):
        h = gru_cell(dec, h, gi, prec)
        hs.append(h)
    dec_h = torch.stack(hs, dim=1)                      # (N*K, Tf, d)
    raw = dense(p["head"], dec_h, prec).reshape(n, k, tf, 5)
    # positions: constant velocity plus tanh-bounded velocity residuals
    # whose bound follows the observed speed
    cv = observed_velocity(rel, obs_mask)
    bound = (torch.exp(p["vel_gain_log"]) * speed
             + torch.exp(p["vel_floor_log"]))[:, :, None, None]
    steps = torch.arange(1, tf + 1, dtype=raw.dtype, device=raw.device)
    mu_xy = (origin[:, None, None] + torch.cumsum(torch.tanh(raw[..., :2])
                                                   * bound, dim=2)
             + cv[:, None, None] * steps[:, None])
    out.update(raw5=torch.cat([mu_xy, raw[..., 2:]], dim=-1),
               dec_h=dec_h.reshape(n, k, tf, -1))
    return out


# -- scene context and IOC ---------------------------------------------------

def _bilinear(pos, g):
    """Align-corners bilinear corners of positions clamped to [0, 1] on a
    G x G grid: four (flat node index, weight) pairs."""
    xy = torch.clamp(pos, 0.0, 1.0) * (g - 1)
    x0 = torch.floor(xy[..., 0])
    y0 = torch.floor(xy[..., 1])
    fx, fy = xy[..., 0] - x0, xy[..., 1] - y0
    x0, y0 = x0.long(), y0.long()
    x1 = torch.clamp(x0 + 1, max=g - 1)
    y1 = torch.clamp(y0 + 1, max=g - 1)
    return [(y0 * g + x0, (1 - fx) * (1 - fy)), (y0 * g + x1, fx * (1 - fy)),
            (y1 * g + x0, (1 - fx) * fy), (y1 * g + x1, fx * fy)]


def scene_map(p, obs_xy, obs_mask, g, prec):
    """obs (B, A, To, 2), masks (B, A, To) -> the occupancy raster
    (time-integrated and last-step presence splatted bilinearly, over To)
    through two 3 x 3 convolutions with group norm and ReLU -> (B, G, G,
    C)."""
    b, a, to, _ = obs_xy.shape
    last = torch.zeros_like(obs_mask)
    last[..., -1] = obs_mask[..., -1]
    w = torch.stack([obs_mask, last], dim=-1).reshape(b, a * to, 2)
    raster = obs_xy.new_zeros((b, g * g, 2))
    for idx, wt in _bilinear(obs_xy.reshape(b, a * to, 2), g):
        raster.scatter_add_(1, idx[..., None].expand(-1, -1, 2),
                            w * wt[..., None])
    raster = (raster / to).reshape(b, g, g, 2)
    h = torch.relu(group_norm(p["gn1"], prec,
                              conv_same(p["conv1"], raster, 1, prec)))
    return torch.relu(group_norm(p["gn2"], prec,
                                 conv_same(p["conv2"], h, 1, prec)))


def pool(fmap, pos):
    """fmap (B, G, G, C) sampled bilinearly at pos (B, P, 2) -> (B, P, C)."""
    b, g, _, c = fmap.shape
    flat = fmap.reshape(b, g * g, c)
    out = 0.0
    for idx, wt in _bilinear(pos, g):
        out = out + wt[..., None] * torch.gather(
            flat, 1, idx[..., None].expand(-1, -1, c))
    return out


def social(p, traj, msg, live, prec):
    """Distance-kernel attention over the live agents of one lane and step,
    self excluded: (B, A, K, Tf, d); zero where no other agent is live."""
    b, a, k, tf, d = msg.shape
    y = traj.permute(0, 2, 3, 1, 4)                     # (B, K, Tf, A, 2)
    diff = y[..., :, None, :] - y[..., None, :, :]
    d2 = (diff * diff).sum(dim=-1)                      # (B, K, Tf, A, A)
    tau = torch.exp(p["soc_logtau"]) + 1e-4
    eye = torch.eye(a, dtype=torch.bool, device=msg.device)
    excl = eye | (live[:, None, None, None, :] <= 0)
    logits = torch.where(excl, torch.full_like(d2, -1e9), -d2 / tau)
    att = torch.softmax(logits, dim=-1) * (~excl).any(dim=-1, keepdim=True)
    out = mm(att, msg.permute(0, 2, 3, 1, 4), prec)     # (B, K, Tf, A, d)
    return out.permute(0, 3, 1, 2, 4)


def ioc_pass(p_ioc, p_scf, traj, dec_h, msg, fmap, live, fut_mask, prec):
    """One pass of the score GRU over the hypotheses: (per-step reward
    psi, refinement delta), each over (B, A, K, Tf)."""
    b, a, k, tf, _ = traj.shape
    vel = traj - torch.cat([traj[..., :1, :], traj[..., :-1, :]], dim=-2)
    scene = pool(fmap, traj.reshape(b, a * k * tf, 2)).reshape(
        b, a, k, tf, -1)
    soc = social(p_scf, traj, msg, live, prec)
    x = torch.cat([vel, scene, soc, dec_h], dim=-1)
    gru = p_ioc["gru"][0]
    gi = gru_input(gru, x, prec)
    h = x.new_zeros((b, a, k, gru["wh"].shape[0]))
    hs = []
    for t in range(tf):
        h = gru_cell(gru, h, gi[..., t, :], prec)
        hs.append(h)
    hs = torch.stack(hs, dim=3)
    psi = dense(p_ioc["score"], hs, prec)[..., 0]
    gate = torch.sigmoid(dense(p_ioc["gate"], hs, prec))
    delta = torch.tanh(dense(p_ioc["delta"], hs, prec)) * gate * 0.1
    return psi, delta * fut_mask[:, :, None, :, None]


def ioc(p_ioc, p_scf, traj, dec_h, fmap, live, fut_mask, passes, prec):
    """Rank and refine: ``passes`` refinement passes, then a re-score of
    the refined hypotheses at detached positions (the ranking never moves
    a hypothesis). Returns (refined, scores (B, A, K), every pass's
    positions)."""
    msg = dense(p_scf["soc_msg"], dec_h, prec)
    iters = []
    for _ in range(passes):
        _, delta = ioc_pass(p_ioc, p_scf, traj, dec_h, msg, fmap, live,
                            fut_mask, prec)
        traj = traj + delta
        iters.append(traj)
    psi, _ = ioc_pass(p_ioc, p_scf, traj.detach(), dec_h, msg, fmap, live,
                      fut_mask, prec)
    scores = (psi * fut_mask[:, :, None, :]).sum(dim=-1)
    return traj, scores, iters


def forward(params, cfg, xy, mask, ids, eps, *, prec="f32", train=False,
            noise=None):
    """The forward over a batch xy (B, T, A, 2), mask (B, T, A), ids (B,
    A), latent noise eps (B*A, K, lat). Returns dict(sgm_traj, refined,
    scores, iters, raw5, the latent moments, live, fut_xy, fut_mask,
    obs_xy, obs_mask)."""
    b, t, a, _ = xy.shape
    to = cfg["obs_len"]
    k = eps.shape[1]
    obs_xy = xy[:, :to].transpose(1, 2)
    fut_xy = xy[:, to:].transpose(1, 2)
    obs_mask = mask[:, :to].transpose(1, 2)
    fut_mask = mask[:, to:].transpose(1, 2)
    live = (ids != 0).float()
    noise = noise or {}
    s = sgm(params["sgm"], cfg, obs_xy.reshape(b * a, to, 2),
            obs_mask.reshape(b * a, to), eps,
            fut_xy=fut_xy.reshape(b * a, t - to, 2) if train else None,
            fut_mask=fut_mask.reshape(b * a, t - to) if train else None,
            keep_x=noise.get("keep_x"), keep_y=noise.get("keep_y"), prec=prec)
    raw5 = s["raw5"].reshape(b, a, k, t - to, 5)
    traj = raw5[..., :2]
    dec_h = s["dec_h"].reshape(b, a, k, t - to, -1)
    fmap = scene_map(params["scf"], obs_xy, obs_mask, cfg["scene_grid"], prec)
    refined, scores, iters = ioc(params["ioc"], params["scf"], traj, dec_h,
                                 fmap, live, fut_mask,
                                 max(cfg["num_refine"], 1), prec)
    out = dict(sgm_traj=traj, refined=refined, scores=scores, iters=iters,
               raw5=raw5, live=live, fut_xy=fut_xy, fut_mask=fut_mask,
               obs_xy=obs_xy, obs_mask=obs_mask)
    for key in ("z_mu", "z_logvar", "zp_mu", "zp_logvar"):
        if key in s:
            out[key] = s[key].reshape(b, a, -1)
    return out


# -- loss and update ---------------------------------------------------------

def masked_mean(v, m):
    return (v * m).sum() / torch.clamp(m.sum(), min=1e-8)


def bivariate_nll(raw5, target, step_mask):
    """Per-step NLL of target under the bivariate Gaussians (log sigma in
    [-9, 6], |rho| <= 0.999, the density floored at 1e-20)."""
    mux, muy, lsx, lsy, rr = raw5.unbind(-1)
    lsx = torch.clamp(lsx, -9.0, 6.0)
    lsy = torch.clamp(lsy, -9.0, 6.0)
    rho = torch.tanh(rr) * 0.999
    nx = (target[..., 0] - mux) / torch.exp(lsx)
    ny = (target[..., 1] - muy) / torch.exp(lsy)
    om = 1.0 - rho * rho
    logp = (-(nx * nx + ny * ny - 2.0 * rho * nx * ny) / (2.0 * om)
            - math.log(2.0 * math.pi) - lsx - lsy - 0.5 * torch.log(om))
    return -torch.clamp(logp, min=math.log(1e-20)) * step_mask


def loss(params, cfg, xy, mask, ids, noise, step, *, prec="f32"):
    """The multi-task loss of one training step with its draws pinned
    (noise: eps, lane_u, keep_x, keep_y). Returns (total, terms)."""
    k = noise["eps"].shape[1]
    out = forward(params, cfg, xy, mask, ids, noise["eps"], prec=prec,
                  train=True, noise=noise)
    fut_xy, fut_mask = out["fut_xy"], out["fut_mask"]
    live = out["live"] * (fut_mask.sum(dim=-1) > 0).float()
    if cfg["speed_loss_alpha"] > 0:
        b, a, to, _ = out["obs_xy"].shape
        s = observed_speed(out["obs_xy"].reshape(b * a, to, 2),
                           out["obs_mask"].reshape(b * a, to)).reshape(b, a)
        w = ((s + 1e-4) / (masked_mean(s, live) + 1e-4)) ** cfg[
            "speed_loss_alpha"]
        live = live * (w / torch.clamp(masked_mean(w, live), min=1e-6))
    nll_lane = bivariate_nll(out["raw5"], fut_xy[:, :, None],
                             fut_mask[:, :, None]).sum(dim=-1)  # (B, A, K)
    # the variety subset: the min-aggregated losses see variety_k random
    # lanes
    lane_u = noise["lane_u"]
    pen = torch.zeros_like(lane_u)
    if 0 < cfg["variety_k"] < k:
        kth = torch.sort(lane_u, dim=-1).values[..., cfg["variety_k"] - 1,
                                                  None]
        pen = torch.where(lane_u <= kth, 0.0, 1e9)
    nll = masked_mean(torch.amin(nll_lane + pen, dim=-1), live)
    var_q = torch.exp(out["z_logvar"])
    kld_dim = 0.5 * (out["zp_logvar"] - out["z_logvar"] - 1.0
                     + (var_q + (out["z_mu"] - out["zp_mu"]) ** 2)
                     * torch.exp(-out["zp_logvar"]))
    kld = masked_mean(torch.clamp(kld_dim, min=cfg["kld_free_bits"]).sum(-1),
                      live)
    w_kld = cfg["w_kld"] * min(max(step / cfg["kld_warmup"], 0.0), 1.0)
    kp = int(round(k * cfg["prior_lane_frac"]))
    prior_nll = masked_mean(torch.amin(nll_lane[..., :kp], dim=-1), live)
    # the IOC ranking target: a softmax over the lanes' z-scored mean
    # displacement errors, a constant of the loss
    ref = out["refined"]
    err = torch.sqrt(((ref.detach() - fut_xy[:, :, None]) ** 2).sum(-1)
                     + 1e-12)
    fm = fut_mask[:, :, None]
    err = (err * fm).sum(-1) / torch.clamp(fm.sum(-1), min=1e-8)
    err = (err - err.mean(-1, keepdim=True)) / (
        err.std(-1, keepdim=True, correction=0) + 1e-8)
    q = torch.softmax(-err / cfg["ioc_temp"], dim=-1)
    ce = masked_mean(-(q * torch.log_softmax(out["scores"], dim=-1)).sum(-1),
                     live)
    reg = 0.0
    for it in out["iters"]:
        e = (((it - fut_xy[:, :, None]) ** 2).sum(-1) * fm).sum(-1) \
            / torch.clamp(fm.sum(-1), min=1e-8)
        reg = reg + masked_mean(torch.amin(e + pen, dim=-1), live)
    reg = reg / len(out["iters"])
    d2 = ((ref - out["sgm_traj"]) ** 2).sum(-1) * fm
    delta_mag = masked_mean(d2.mean(dim=(-1, -2)), live)
    total = (cfg["w_nll"] * nll + w_kld * kld + cfg["w_prior_nll"] * prior_nll
             + cfg["w_ce"] * ce + cfg["w_reg"] * reg
             + cfg["w_delta"] * delta_mag)
    return total, dict(nll=nll, kld=kld, prior_nll=prior_nll, ioc_ce=ce,
                       refine_reg=reg, delta_mag=delta_mag)


def adam_step(cfg, leaves, grads, mu, nu, count, steps_per_epoch):
    """The gradients clipped to a global norm of cfg["grad_clip"], then
    Adam (0.9, 0.999, 1e-8) at the staircase-decayed rate. Returns (leaves,
    mu, nu, the clipped gradients)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    clip = cfg["grad_clip"]
    scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    grads = [g * scale for g in grads]
    t = count + 1
    lr = cfg["learning_rate"] * cfg["decay_rate"] ** (count // steps_per_epoch)
    out_p, out_m, out_v = [], [], []
    for p, g, m, v in zip(leaves, grads, mu, nu):
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        u = (m / (1 - 0.9 ** t)) / (torch.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
        out_p.append(p - lr * u)
        out_m.append(m)
        out_v.append(v)
    return out_p, out_m, out_v, grads
