"""The fused IOC rank-and-refine loop: CUDA kernel wrapper and its plain
PyTorch version (port of ``desire_tpu/ops/ioc_fused.py``).

Per (batch row, hypothesis lane), ``num_refine`` passes and a final
re-score. Each step t of a pass builds the score-GRU input from four
blocks and advances the GRU:

    velocity   traj[t] - traj[t-1] (0 at t = 0)
    scene      align-corners bilinear pooling of the (G, G, C) feature map
               at the position clamped to [0, 1]
    social     softmax over the lane's agents of -d^2 / (exp(logtau) + 1e-4),
               self and dead agents excluded, rows without a live neighbour
               zeroed, pooling msg = dec_h Wmsg + bmsg
    dec_h      the hypothesis' own decoder hidden

The heads give [psi | gate | dx | dy] per step. After a pass,
traj += tanh(d) * sigmoid(gate) * delta_scale * fut_mask; the final pass
moves nothing and scores each lane sum_t psi * fut_mask (ascending t).
With collect_iters (the training forward) every refine pass's positions
come out too, (num_refine, B, A, K, T, 2); the backward is
``ops/ioc_bwd.py``.

Numerics follow the TPU kernel: products round their operands to the
compute dtype and accumulate in float32; positions, distances and the
social softmax stay float32 even under bfloat16; msg is the float32
product rounded to the compute dtype plus the rounded bias, rounded again.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from desire_tpu_torch.ops import _build
from desire_tpu_torch.ops.scene_pool import bilinear_pool_plain
from desire_tpu_torch.utils import telemetry

_F32 = torch.float32
# the most agents a lane the tensor-core kernel holds (csrc/ioc_refine.cu
# kTcMaxAgents)
TC_MAX_AGENTS = 128


def _mm(a, b, cd):
    """Product with operands rounded to cd and float32 accumulation."""
    return a.to(cd).to(_F32) @ b.to(cd).to(_F32)


def _split_weights(p_ioc, c, d):
    """Input-gate matrix split by feature block [vel 2 | scene C | social d
    | dec d], and the heads packed as [score | gate | delta] (d, 4)."""
    gp = p_ioc["gru"][0]
    wi = gp["wi"]
    heads_w = torch.cat([p_ioc["score"]["w"], p_ioc["gate"]["w"],
                         p_ioc["delta"]["w"]], dim=-1)
    heads_b = torch.cat([p_ioc["score"]["b"], p_ioc["gate"]["b"],
                         p_ioc["delta"]["b"]])
    return dict(wiv=wi[:2], wis=wi[2:2 + c], wio=wi[2 + c:2 + c + d],
                wid=wi[2 + c + d:], wh=gp["wh"], bi=gp["bi"], bh=gp["bh"],
                heads_w=heads_w, heads_b=heads_b)


def _scene(feat_map, px, py):
    """The scene block at (B, K, T, A) positions -> (B, K, T, A, C), as the
    scene-pool kernel pools it (corner weights rounded to the map's dtype).
    """
    b, k, t, a = px.shape
    pos = torch.stack([px, py], dim=-1).reshape(b, k * t * a, 2)
    return bilinear_pool_plain(feat_map, pos).reshape(b, k, t, a, -1)


def ioc_refine_plain(p_ioc, p_scf, traj, dec_h, feat_map, live, fut_mask, *,
                     num_refine, delta_scale, social_freeze=False,
                     collect_iters=False):
    """Plain PyTorch version of the IOC kernel: the inputs and outputs of
    :func:`ioc_refine_cuda`, read from the param trees. Under social_freeze
    the social block is pooled once at the initial positions and reused by
    every pass.

    It is differentiable, with the stop-gradients of
    ``models/ioc.ioc_forward``: the final re-score reads detached positions
    (under social_freeze, its social block is pooled at the detached
    initial positions), so the ranking never moves a hypothesis."""
    cd = dec_h.dtype
    b, a, k, t, _ = traj.shape
    d = dec_h.shape[-1]
    c = feat_map.shape[-1]
    w = _split_weights(p_ioc, c, d)
    tau = torch.exp(p_scf["soc_logtau"].float()) + 1e-4

    # (B, K, T, A, ·) layout: a lane's agents at one step are one slab
    x = traj[..., 0].float().permute(0, 2, 3, 1)
    y = traj[..., 1].float().permute(0, 2, 3, 1)
    x0, y0 = x, y
    dec = dec_h.permute(0, 2, 3, 1, 4)
    msg = (_mm(dec, p_scf["soc_msg"]["w"], cd).to(cd)
           + p_scf["soc_msg"]["b"].to(cd)).to(_F32)
    gi_dec = _mm(dec, w["wid"], cd) + w["bi"].float()
    fmask = fut_mask.float().permute(0, 2, 1)[:, None]      # (B, 1, T, A)
    eye = torch.eye(a, dtype=torch.bool, device=traj.device)
    excl = eye | ~(live > 0)[:, None, None, None, :]        # (B,1,1,A,A)
    nb_ok = (~excl).any(dim=-1, keepdim=True).to(_F32)
    wiv = w["wiv"].float()
    heads_b = w["heads_b"].float()

    def attend(px, py):
        sq = px * px + py * py
        d2 = ((sq[..., :, None] + sq[..., None, :])
              - 2.0 * (px[..., :, None] * px[..., None, :]
                       + py[..., :, None] * py[..., None, :]))
        logits = torch.where(excl, torch.full_like(d2, -1e9), -d2 / tau)
        att = torch.softmax(logits, dim=-1) * nb_ok
        return _mm(att, msg, cd)                            # (B,K,T,A,d)

    soc0 = attend(x, y) if social_freeze else None
    scores = None
    iters = []
    for ip in range(num_refine + 1):
        # the re-score reads detached positions: it moves no hypothesis
        px, py = (x, y) if ip < num_refine else (x.detach(), y.detach())
        if not social_freeze:
            soc = attend(px, py)
        elif ip < num_refine:
            soc = soc0
        else:
            soc = attend(x0.detach(), y0.detach())
        vx = px - torch.cat([px[:, :, :1], px[:, :, :-1]], dim=2)
        vy = py - torch.cat([py[:, :, :1], py[:, :, :-1]], dim=2)
        gi = (vx[..., None] * wiv[0] + vy[..., None] * wiv[1] + gi_dec
              + _mm(_scene(feat_map.to(cd), px, py), w["wis"], cd)
              + _mm(soc, w["wio"], cd))
        h = x.new_zeros((b, k, a, d))
        outs = []
        for s in range(t):
            gh = _mm(h, w["wh"], cd) + w["bh"].float()
            i_r, i_z, i_n = gi[:, :, s].chunk(3, dim=-1)
            h_r, h_z, h_n = gh.chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1.0 - z) * n + z * h
            outs.append(_mm(h, w["heads_w"], cd) + heads_b)  # (B,K,A,4)
        out = torch.stack(outs, dim=2)                      # (B,K,T,A,4)
        if ip < num_refine:
            gate = torch.sigmoid(out[..., 1])
            m = fmask * delta_scale
            x = x + torch.tanh(out[..., 2]) * gate * m
            y = y + torch.tanh(out[..., 3]) * gate * m
            if collect_iters:
                iters.append(torch.stack([x, y], dim=-1).permute(0, 3, 1, 2,
                                                                 4))
        else:
            scores = torch.zeros_like(out[:, :, 0, :, 0])
            for s in range(t):
                scores = scores + out[:, :, s, :, 0] * fmask[:, :, s]
    refined = torch.stack([x, y], dim=-1).permute(0, 3, 1, 2, 4)
    out = refined.contiguous(), scores.permute(0, 2, 1).contiguous()
    if collect_iters:
        out += (torch.stack(iters).contiguous(),)
    return out


@dataclasses.dataclass(frozen=True)
class IocWeights:
    """The IOC weights in the layout its kernel reads, on one device, made
    by :func:`pack_ioc` for lanes of at most ``max_agents`` agents. A
    snapshot: later changes to the param trees do not reach it.

    use_mma (bf16, d and C multiples of 16, d at most 64, at most
    ``TC_MAX_AGENTS`` agents) runs the kernel's tensor-core path, which
    takes the matrices transposed, (out, in), with the heads zero-padded to
    8 columns.
    """
    compute_dtype: torch.dtype
    max_agents: int
    use_mma: bool
    d: int
    c: int
    tensors: tuple


def pack_ioc(p_ioc, p_scf, compute_dtype, device, max_agents) -> IocWeights:
    """The IOC and scene param trees -> the kernel's weights: matrices and
    the message bias in the compute dtype, the rest in float32, all
    contiguous on ``device``. The input-gate matrix is stacked as
    [dec d | scene C | social d] (its velocity rows stay apart).

    bf16 at the tensor-core path's widths takes that path up to
    ``TC_MAX_AGENTS`` agents and raises past it: no layout holds more, and
    the CUDA-core path is no silent stand-in."""
    cd = compute_dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16: {cd}")
    gp = p_ioc["gru"][0]
    d = int(gp["wh"].shape[0])
    c = int(gp["wi"].shape[0]) - 2 - 2 * d
    w = _split_weights(p_ioc, c, d)
    use_mma = (cd == torch.bfloat16 and d <= 64 and d % 16 == 0
               and c % 16 == 0)
    if use_mma and max_agents > TC_MAX_AGENTS:
        raise ValueError(
            f"{max_agents} agents a lane: the tensor-core IOC kernel holds "
            f"at most {TC_MAX_AGENTS} (TC_MAX_AGENTS)")
    heads_w = w["heads_w"]
    if use_mma:
        heads_w = torch.cat([heads_w, heads_w.new_zeros((d, 4))], dim=-1)

    def wc(x):
        return x.to(device=device, dtype=cd).contiguous()

    def mat(x):
        return wc(x.t() if use_mma else x)

    def wf(x):
        return x.to(device=device, dtype=_F32).contiguous()

    wx = torch.cat([w["wid"], w["wis"], w["wio"]], dim=0)
    tensors = (wf(w["wiv"]), mat(wx), mat(w["wh"]), wf(w["bi"]),
               wf(w["bh"]), mat(heads_w), wf(w["heads_b"]),
               mat(p_scf["soc_msg"]["w"]), wc(p_scf["soc_msg"]["b"]),
               wf(p_scf["soc_logtau"]))
    return IocWeights(cd, int(max_agents), use_mma, d, c, tensors)


def ioc_refine_cuda(w: IocWeights, traj, dec_h, feat_map, live, fut_mask, *,
                    num_refine, delta_scale, social_freeze=False,
                    collect_iters=False):
    """Launch the IOC kernel (``csrc/ioc_refine.cu``) on CUDA tensors, with
    the weights of :func:`pack_ioc`.

    traj (B, A, K, T, 2) f32; dec_h (B, A, K, T, d) compute dtype (float32
    or bfloat16); feat_map (B, G, G, C) compute dtype; live (B, A) f32;
    fut_mask (B, A, T) f32. Returns (refined (B, A, K, T, 2) f32,
    scores (B, A, K) f32), and with collect_iters every refine pass's
    positions (num_refine, B, A, K, T, 2) f32 (counted as the training
    forward, ``ioc_refine_train``)."""
    if not traj.is_cuda:
        raise ValueError("ioc_refine_cuda needs CUDA tensors")
    cd, dev = w.compute_dtype, traj.device
    b, a, k, t, _ = traj.shape
    g = feat_map.shape[1]
    if a > w.max_agents:
        raise ValueError(f"{a} agents; the weights were packed for at most "
                         f"{w.max_agents}")
    _build.check(traj, "traj", (b, a, k, t, 2), _F32, dev)
    _build.check(dec_h, "dec_h", (b, a, k, t, w.d), cd, dev)
    _build.check(feat_map, "feat_map", (b, g, g, w.c), cd, dev)
    _build.check(live, "live", (b, a), _F32, dev)
    _build.check(fut_mask, "fut_mask", (b, a, t), _F32, dev)
    if w.tensors[0].device != dev:
        raise ValueError(f"weights on {w.tensors[0].device}, inputs on {dev}")
    refined = torch.empty((b, a, k, t, 2), dtype=_F32, device=dev)
    scores = torch.empty((b, a, k), dtype=_F32, device=dev)
    iters = (torch.empty((num_refine, b, a, k, t, 2), dtype=_F32, device=dev)
             if collect_iters else None)
    ptrs = [traj, dec_h, feat_map, live, fut_mask, *w.tensors, refined,
            scores]
    rc = _build.library().ioc_refine_launch(
        int(cd == torch.bfloat16), int(w.use_mma),
        *[x.data_ptr() for x in ptrs],
        None if iters is None else iters.data_ptr(),
        b, a, k, t, w.d, g, w.c, int(num_refine), int(bool(social_freeze)),
        float(delta_scale),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(
            f"ioc_refine kernel launch failed: CUDA error {rc} ({a} agents, "
            f"K {k}, T {t}, d {w.d}, C {w.c}, "
            f"{'tensor-core' if w.use_mma else 'CUDA-core'} path; no "
            f"shared-memory layout fits, or past {TC_MAX_AGENTS} agents)")
    telemetry.count("ioc.agent_tiles", (a + 15) // 16)
    if collect_iters:
        _build.LAUNCHES["ioc_refine_train"] += 1
        return refined, scores, iters
    _build.LAUNCHES["ioc_refine"] += 1
    if w.use_mma:
        telemetry.count("launch.ioc_refine.mma")
    return refined, scores


def tc_block_shape(a, k, t, d, c, social_freeze=False):
    """The tensor-core kernel's block at these shapes: (lanes a block, step
    tiles in its ring, shared-memory bytes), or None where no layout fits
    (past ``TC_MAX_AGENTS`` agents). Asks the kernel library."""
    out = (ctypes.c_longlong * 3)()
    rc = _build.library().ioc_refine_tc_shape(
        int(a), int(k), int(t), int(d), int(c), int(bool(social_freeze)),
        out)
    return None if rc else tuple(int(x) for x in out)


def ioc_refine(p_ioc, p_scf, traj, dec_h, feat_map, live, fut_mask, *,
               num_refine, delta_scale, social_freeze=False, weights=None):
    """Rank-and-refine on the tensors' device: the CUDA kernel for CUDA
    tensors, with ``weights`` from :func:`pack_ioc` (packed from the param
    trees when not given), the plain version for CPU tensors."""
    kw = dict(num_refine=num_refine, delta_scale=delta_scale,
              social_freeze=social_freeze)
    if traj.is_cuda:
        if weights is None:
            weights = pack_ioc(p_ioc, p_scf, dec_h.dtype, traj.device,
                               traj.shape[1])
        return ioc_refine_cuda(weights, traj, dec_h, feat_map, live,
                               fut_mask, **kw)
    if traj.device.type == "cpu":
        return ioc_refine_plain(p_ioc, p_scf, traj, dec_h, feat_map, live,
                                fut_mask, **kw)
    raise ValueError(f"no IOC kernel for device {traj.device}")


def check_rows(traj, **others):
    """Raise unless every tensor of ``others`` holds traj's rows (a
    rank's block under a mesh)."""
    b = traj.shape[0]
    for name, x in others.items():
        if x.shape[0] != b:
            raise ValueError(f"{name} holds {x.shape[0]} rows, traj {b}: "
                             "pass the rank's rows of each")


def ioc_refine_sharded(mesh, p_ioc, p_scf, traj, dec_h, feat_map, live,
                       fut_mask, *, num_refine, delta_scale,
                       social_freeze=False, weights=None):
    """Rank-and-refine on rank ``(d, k)`` of a ``(data, k)`` mesh
    (``parallel/mesh.py``): its launch (:func:`ioc_refine`) on its
    (B/md, A, K/mk) block.

    traj and dec_h are the rank's block, as the sampler's shard gives it
    (``sgm_sample_decode_sharded``); feat_map, live and fut_mask hold its
    B/md rows. Every (row, lane) is independent (the social attention
    pools a lane's own agents), so there are no collectives. The kernel
    projects the social messages itself: the JAX wrapper's explicit
    ``msg`` is the same product. Returns (refined, scores) of the block."""
    check_rows(traj, feat_map=feat_map, live=live, fut_mask=fut_mask,
               dec_h=dec_h)
    return ioc_refine(p_ioc, p_scf, traj, dec_h, feat_map, live, fut_mask,
                      num_refine=num_refine, delta_scale=delta_scale,
                      social_freeze=social_freeze, weights=weights)
