"""Work from shapes, and the card's peaks: the yardstick of every roofline
and MFU metric.

Each ``*_work`` gives (bytes, FLOPs) that a kernel's call needs at its
shapes: each input byte read once, each output byte written once, the
products counted as 2 FLOPs a multiply-add. ``bound_ms`` turns them into
the least time the card could take.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, at its 700 W limit): HBM3 bytes/s and
# FLOP/s by operand type
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"bf16": 989e12, "f32": 67e12}


def bound_ms(nbytes, flops, kind):
    """The larger of bytes over the memory rate and FLOPs over the peak of
    their type, in ms."""
    return max(nbytes / HBM_BYTES_S, flops / PEAK_FLOP_S[kind]) * 1e3


def _kind(cfg):
    return "bf16" if cfg["compute_dtype"] == "bfloat16" else "f32"


def _cs(cfg):
    return 2 if cfg["compute_dtype"] == "bfloat16" else 4


def sampler_work(cfg, n, k):
    """The fused sampler on n agent rows and k lanes: features, mask, rho
    and eps read once, dec_h (f32) and hx written once; the encoder,
    prior, mask MLP and k-lane decoder products."""
    t, d, lat = cfg["pred_len"], cfg["d_dim"], cfg["latent_size"]
    to, emb = cfg["obs_len"], cfg["embedding_size"]
    side2 = 2 * cfg["rnn_size"]
    hid = max(4 * lat, side2 // 2)
    cs = _cs(cfg)
    nbytes = (n * to * emb * cs + n * to * 4 + n * d * 4 + n * k * lat * cs
              + n * k * t * d * 4 + n * d * 4)
    mac_row = to * (emb + d) * 3 * d + d * 2 * lat
    mac_lane = (lat * hid + hid * side2 + side2 * d + 2 * lat * d
                + d * 3 * d + t * d * 3 * d)
    return nbytes, 2 * (n * mac_row + n * k * mac_lane)


def ioc_fwd_work(cfg, b, a, k, iters_out=False):
    """The IOC rank-and-refine forward on (b, a, k): traj, dec_h, the
    feature map and masks read once; refined, scores (and every pass's
    positions) written once; per pass, step and agent row the message,
    pooling, gate and head products."""
    t, d = cfg["pred_len"], cfg["d_dim"]
    g, c, r = cfg["scene_grid"], cfg["scene_channels"], max(cfg["num_refine"],
                                                            1)
    cs = _cs(cfg)
    rows = b * a * k
    nbytes = (rows * t * 2 * 4 + rows * t * d * cs + b * g * g * c * cs
              + b * a * 4 + b * a * t * 4 + rows * t * 2 * 4 + rows * 4
              + (r * rows * t * 2 * 4 if iters_out else 0))
    mac = d * d + a * d + (2 * d + c) * 3 * d + d * 3 * d + d * 4
    return nbytes, 2 * (r + 1) * t * rows * mac


def ioc_bwd_work(cfg, b, a, k):
    """The IOC backward on (b, a, k): its inputs (every pass's positions,
    dec_h, messages, the feature map, masks, cotangents) read once, its
    outputs (d_traj, d_dec, d_msg, d_map) written once; per pass, step and
    agent row the recomputed forward products and the adjoint products."""
    t, d = cfg["pred_len"], cfg["d_dim"]
    g, c, r = cfg["scene_grid"], cfg["scene_channels"], max(cfg["num_refine"],
                                                            1)
    cs = _cs(cfg)
    rows = b * a * k
    f = 2 + c + 2 * d
    nbytes = ((r + 1) * rows * t * 2 * 4 + 2 * rows * t * d * cs
              + b * g * g * c * cs + b * a * 4 + b * a * t * 4
              + rows * t * 2 * 4 + rows * 4 + r * rows * t * 2 * 4
              + rows * t * 2 * 4 + 2 * rows * t * d * 4 + b * g * g * c * 4)
    fwd = a * d + (2 * d + c) * 3 * d + d * 3 * d + 2 * d * 4
    adj = 3 * d * d + 3 * d * (2 * d + c) + (f + d) * 3 * d + 2 * a * d
    return nbytes, 2 * (r + 1) * t * rows * (fwd + adj)


def roofline_pct(work, cfg, device_ms_per_call):
    """A call's bound over its measured device time, in %."""
    if not device_ms_per_call or device_ms_per_call <= 0:
        return None
    return 100.0 * bound_ms(*work, _kind(cfg)) / device_ms_per_call


def shape_key(b, a, k):
    return f"B{b}.A{a}.K{k}"

