"""The trainable fused IOC rank-and-refine: the training forward (the IOC
kernel with ``collect_iters``) bound to the backward kernel
``csrc/ioc_refine_bwd.cu`` in a ``torch.autograd.Function`` (port of
``desire_tpu/ops/ioc_bwd.py`` and of ``make_trainable_fused_ioc`` in
``desire_tpu/ops/ioc_fused.py``).

The forward kernel saves only every pass's positions; the backward kernel
recomputes each pass from them and returns the cotangents of the
trajectories, dec_h, the social messages, the feature map and soc_logtau,
and the gradients of the score GRU and the three heads. In its tensor-core
variant (bf16, d and C multiples of 16) it is two launches: the backward
kernel logs every reverse step's bf16 operand tiles, and a second kernel
forms the GRU's input and hidden matrices' gradients over the whole log.
The messages are msg = dec_h Wmsg + bmsg; the chain back through that
product into dec_h and the message weights is left to ``torch.matmul``,
as the JAX wrapper leaves it to XLA. live and fut_mask are data and get no
gradient.

Under social_freeze the social block is pooled once, at the initial
positions, and reused by every pass; the backward kernel then runs one
deferred attention adjoint after its passes (the TPU kernel's variant).

Under a ``(data, k)`` mesh, ``ioc_refine_train_sharded`` runs the pair
on a rank's lane block and gathers the outputs to every lane.

On CPU tensors the plain version runs instead: autograd through
``ioc_fused.ioc_refine_plain(collect_iters=True)``, which carries the same
stop-gradients as ``models/ioc.ioc_forward``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from desire_tpu_torch.ops import _build
from desire_tpu_torch.ops.ioc_fused import (check_rows, ioc_refine_cuda,
                                            ioc_refine_plain, pack_ioc)
from desire_tpu_torch.parallel import mesh as mesh_mod

_F32 = torch.float32

# leaf order of the autograd Function's parameter arguments
_IOC_LEAVES = (("gru", "wi"), ("gru", "wh"), ("gru", "bi"), ("gru", "bh"),
               ("score", "w"), ("score", "b"), ("gate", "w"), ("gate", "b"),
               ("delta", "w"), ("delta", "b"))


def _ioc_leaf(p_ioc, path):
    node = p_ioc[path[0]]
    return (node[0] if path[0] == "gru" else node)[path[1]]


def _trees(leaves, msg_w, msg_b, ltau):
    """The leaves back into the (p_ioc, p_scf) trees the kernels read."""
    p_ioc = {"gru": [{}], "score": {}, "gate": {}, "delta": {}}
    for path, v in zip(_IOC_LEAVES, leaves):
        (p_ioc["gru"][0] if path[0] == "gru" else p_ioc[path[0]])[path[1]] = v
    return p_ioc, {"soc_msg": {"w": msg_w, "b": msg_b}, "soc_logtau": ltau}


def social_messages(p_scf, dec_h):
    """msg = dec_h Wmsg + bmsg in dec_h's dtype (scf.social_messages)."""
    return dec_h @ p_scf["soc_msg"]["w"].to(dec_h.dtype) + \
        p_scf["soc_msg"]["b"].to(dec_h.dtype)


# order of the packed weights among the kernel's inputs
_PACK_ORDER = ("wi", "wiT", "wh", "whT", "heads_c", "wiv", "bi", "bh",
               "heads_w", "heads_b", "ltau")


def pack_ioc_bwd(p_ioc, p_scf, compute_dtype, device):
    """The backward kernel's weight operands, built once per training
    forward (not per launch): the score GRU's input and hidden matrices in
    the compute dtype, each also transposed (the kernel reads a product's
    second operand row by row: wi (F, 3d) and wiT (3d, F) with F = 2 + C +
    2d rows [vel | scene | social | dec_h]; wh (d, 3d) and whT (3d, d)),
    the heads [score | gate | dx | dy] (d, 4) in the compute dtype and in
    float32, and in float32 the velocity rows of wi (2, 3d), the biases,
    the heads' bias (4) and soc_logtau (1). All detached and contiguous."""
    gp = p_ioc["gru"][0]

    def wc(x):
        return x.detach().to(device=device, dtype=compute_dtype).contiguous()

    def wf(x):
        return x.detach().to(device=device, dtype=_F32).contiguous()

    heads_w = torch.cat([p_ioc["score"]["w"], p_ioc["gate"]["w"],
                         p_ioc["delta"]["w"]], dim=-1)
    heads_b = torch.cat([p_ioc["score"]["b"], p_ioc["gate"]["b"],
                         p_ioc["delta"]["b"]])
    wi, wh = gp["wi"], gp["wh"]
    return {"wi": wc(wi), "wiT": wc(wi.t()), "wh": wc(wh), "whT": wc(wh.t()),
            "heads_c": wc(heads_w), "wiv": wf(wi[:2]), "bi": wf(gp["bi"]),
            "bh": wf(gp["bh"]), "heads_w": wf(heads_w),
            "heads_b": wf(heads_b),
            "ltau": wf(p_scf["soc_logtau"].reshape(1))}


def bwd_uses_mma(bf16, d, c):
    """Whether the backward kernel takes its tensor-core variant (bf16, d
    and C multiples of 16; ``bwd_mma`` of the kernel source), which logs
    its operand tiles and forms the input and hidden matrices' gradients
    in a second kernel."""
    return bool(bf16) and d % 16 == 0 and c % 16 == 0


def bwd_workspace_words(b, a, k, t, d, c, r, social_freeze, bf16):
    """Float32 words of the backward kernel's device-memory workspace, B * K
    blocks of: the GRU gates r, z, n and the hidden n-gate preactivation
    (T, A, 4d), the GRU states (T, A, d), the scene (T, A, C) and social
    (T, A, d) blocks, the heads' cotangents (T, A, 4) and every pass's
    scene cotangents (R + 1, T, A, C); under social_freeze also the two
    social-cotangent buckets, (T, A, d) each. Then, with the tensor-core
    variant, B * K operand logs: every reverse step's rows, padded to 16
    agents, of bf16 [X (C + 2d + 16) | h (d) | gate cotangents (4d)]
    (``bwd_total_words`` of the kernel source)."""
    per_block = (t * a * (6 * d + c + 4) + (r + 1) * t * a * c
                 + (2 * t * a * d if social_freeze else 0))
    if bwd_uses_mma(bf16, d, c):
        rows = -(-a // 16) * 16
        per_block += (r + 1) * t * rows * (c + 7 * d + 16) // 2
    return b * k * per_block


@functools.lru_cache(maxsize=None)
def check_bwd_agents(a, t, d, c, g, bf16):
    """Raise unless the backward kernel's block layout (``BwdLayout``)
    fits a lane of ``a`` agents in shared memory at these widths (bf16:
    the tensor-core variant where d and C allow it), naming the most
    agents it holds there, as the kernel library counts them."""
    lib = _build.library()
    most = lib.ioc_refine_bwd_max_agents(t, d, c, g, int(bf16))
    if a <= most:
        return
    need = lib.ioc_refine_bwd_smem_bytes(a, t, d, c, g, int(bf16))
    raise ValueError(
        f"{a} agents a lane: the fused IOC backward's shared-memory layout "
        f"(BwdLayout, csrc/ioc_refine_bwd.cu) holds at most {most} agents "
        f"at d {d}, C {c}, T {t}, G {g} ({need} bytes needed); train with "
        f"fewer agents a window")


def ioc_refine_bwd_cuda(p_ioc, p_scf, traj, dec_h, msg, feat_map, live,
                        fut_mask, iters, d_refined, d_scores, d_iters, *,
                        num_refine, delta_scale, social_freeze=False,
                        weights=None):
    """Launch the backward kernel (``csrc/ioc_refine_bwd.cu``) on CUDA
    tensors. Shapes as :func:`ioc_fused.ioc_refine_cuda`; iters is its
    collect_iters output (R, B, A, K, T, 2), made with the same
    social_freeze, and the cotangents are float32. weights:
    :func:`pack_ioc_bwd` of the same parameters, if the caller has it.

    Returns (d_traj f32, d_dec, d_msg (both float32), d_feat_map (B, G, G,
    C) float32, the GRU gradients {wi, wh, bi, bh}, the head gradients
    {score, gate, delta} (each {w, b}), d soc_logtau ()). The weight and
    feature-map gradients are per-block partials summed here in a fixed
    order: the result is bitwise reproducible. With the tensor-core variant
    a second kernel (``ioc_bwd_wgrad_kernel``, counted as
    ``ioc_bwd_wgrad``) forms wi's and wh's from the operand log that the
    backward kernel writes, one partial a block of its fixed grid."""
    if not traj.is_cuda:
        raise ValueError("ioc_refine_bwd_cuda needs CUDA tensors")
    cd, dev = dec_h.dtype, traj.device
    b, a, k, t, _ = traj.shape
    r = int(num_refine)
    d = int(dec_h.shape[-1])
    g, c = int(feat_map.shape[1]), int(feat_map.shape[-1])
    f = 2 + c + 2 * d
    gp = p_ioc["gru"][0]
    for name, x, shape, dt in (
            ("traj", traj, (b, a, k, t, 2), _F32),
            ("iters", iters, (r, b, a, k, t, 2), _F32),
            ("dec_h", dec_h, (b, a, k, t, d), cd),
            ("msg", msg, (b, a, k, t, d), cd),
            ("feat_map", feat_map, (b, g, g, c), cd),
            ("live", live, (b, a), _F32),
            ("fut_mask", fut_mask, (b, a, t), _F32),
            ("d_refined", d_refined, (b, a, k, t, 2), _F32),
            ("d_scores", d_scores, (b, a, k), _F32),
            ("d_iters", d_iters, (r, b, a, k, t, 2), _F32)):
        _build.check(x, name, shape, dt, dev)
    if tuple(gp["wi"].shape) != (f, 3 * d):
        raise ValueError(f"gru wi {tuple(gp['wi'].shape)}, expected "
                         f"{(f, 3 * d)}")
    w = weights if weights is not None else pack_ioc_bwd(p_ioc, p_scf, cd,
                                                         dev)
    _build.check(w["wiT"], "packed wiT", (3 * d, f), cd, dev)
    ins = [traj, iters, dec_h, msg, feat_map, live, fut_mask,
           *(w[name] for name in _PACK_ORDER), d_refined, d_scores, d_iters]
    nb = b * k
    lib = _build.library()
    freeze = int(bool(social_freeze))
    bf16 = int(cd == torch.bfloat16)
    # the input and hidden matrices' partials: the product kernel's (with
    # the tensor-core variant), else one a backward block
    parts = lib.ioc_refine_bwd_wgrad_ctas(b, a, k, t, d, c, r, bf16) or nb
    z = lambda *shape: torch.empty(shape, dtype=_F32, device=dev)
    outs = [z(b, a, k, t, 2), z(b, a, k, t, d), z(b, a, k, t, d),
            z(nb, g * g * c), z(parts, f, 3 * d), z(parts, d, 3 * d),
            z(nb, 3 * d), z(nb, 3 * d), z(nb, d, 4), z(nb, 4), z(nb)]
    words = bwd_workspace_words(b, a, k, t, d, c, r, freeze, bf16)
    if words != lib.ioc_refine_bwd_ws_words(b, a, k, t, d, c, r, freeze,
                                            bf16):
        raise RuntimeError("the workspace size disagrees with the kernel's")
    ws = z(words)
    ptr_in = (ctypes.c_void_p * len(ins))(*[x.data_ptr() for x in ins])
    ptr_out = (ctypes.c_void_p * len(outs))(*[x.data_ptr() for x in outs])
    rc = lib.ioc_refine_bwd_launch(
        bf16, ptr_in, ptr_out, ws.data_ptr(), b, a, k, t, d, g, c, r, freeze,
        float(delta_scale),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"ioc_refine_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    _build.LAUNCHES["ioc_refine_bwd"] += 1
    if bwd_uses_mma(bf16, d, c):
        _build.LAUNCHES["ioc_bwd_wgrad"] += 1
    d_traj, d_dec, d_msg, fm_p, wi_p, wh_p, bi_p, bh_p, hw_p, hb_p, lt_p = outs
    hw, hb = hw_p.sum(0), hb_p.sum(0)
    grads_gru = {"wi": wi_p.sum(0), "wh": wh_p.sum(0), "bi": bi_p.sum(0),
                 "bh": bh_p.sum(0)}
    grads_heads = {"score": {"w": hw[:, 0:1], "b": hb[0:1]},
                   "gate": {"w": hw[:, 1:2], "b": hb[1:2]},
                   "delta": {"w": hw[:, 2:4], "b": hb[2:4]}}
    d_fmap = fm_p.reshape(b, k, g, g, c).sum(1)
    return (d_traj, d_dec, d_msg, d_fmap, grads_gru, grads_heads,
            lt_p.sum())


class _TrainableIoc(torch.autograd.Function):
    """Forward: the IOC kernel with collect_iters. Backward: the backward
    kernel, then the message product's chain rule."""

    @staticmethod
    def forward(ctx, num_refine, delta_scale, social_freeze, traj, dec_h,
                feat_map, live, fut_mask, msg_w, msg_b, ltau, *leaves):
        p_ioc, p_scf = _trees(leaves, msg_w, msg_b, ltau)
        w = pack_ioc(p_ioc, p_scf, dec_h.dtype, traj.device, traj.shape[1])
        kw = dict(num_refine=num_refine, delta_scale=delta_scale,
                  social_freeze=social_freeze)
        refined, scores, iters = ioc_refine_cuda(
            w, traj, dec_h, feat_map, live, fut_mask, collect_iters=True,
            **kw)
        ctx.save_for_backward(traj, dec_h, feat_map, live, fut_mask, iters,
                              msg_w, msg_b, ltau, *leaves)
        ctx.kw = kw
        # the backward's weight operands, packed here once: the parameters
        # cannot change between this forward and its backward
        ctx.bwd_weights = pack_ioc_bwd(p_ioc, p_scf, dec_h.dtype, traj.device)
        # scores reach the loss in the compute dtype, as the plain path
        # gives them (ioc_fused.py:979 of the JAX package)
        return refined, scores.to(dec_h.dtype), iters

    @staticmethod
    def backward(ctx, d_refined, d_scores, d_iters):
        (traj, dec_h, feat_map, live, fut_mask, iters, msg_w, msg_b, ltau,
         *leaves) = ctx.saved_tensors
        p_ioc, p_scf = _trees(leaves, msg_w, msg_b, ltau)

        def ct(x, shape):       # an output autograd saw unused gets None
            return (torch.zeros(shape, dtype=_F32, device=traj.device)
                    if x is None else x.float().contiguous())

        msg = social_messages(p_scf, dec_h).contiguous()
        (d_traj, d_dec, d_msg, d_fmap, g_gru, g_heads,
         d_ltau) = ioc_refine_bwd_cuda(
            p_ioc, p_scf, traj, dec_h, msg, feat_map, live, fut_mask, iters,
            ct(d_refined, traj.shape), ct(d_scores, traj.shape[:3]),
            ct(d_iters, iters.shape), weights=ctx.bwd_weights, **ctx.kw)
        cd = dec_h.dtype
        # chain msg = dec_h Wmsg + bmsg into dec_h and the message weights
        d_msg = d_msg.to(cd).float()
        d_dec = d_dec.to(cd) + (d_msg @ msg_w.float().t()).to(cd)
        d_wmsg = torch.einsum("baktd,bakto->do", dec_h.float(), d_msg)
        d_bmsg = d_msg.sum(dim=(0, 1, 2, 3))
        grads = {("gru", n): g_gru[n] for n in ("wi", "wh", "bi", "bh")}
        for h in ("score", "gate", "delta"):
            for n in ("w", "b"):
                grads[(h, n)] = g_heads[h][n]
        leaf_grads = [grads[path].to(v.dtype)
                      for path, v in zip(_IOC_LEAVES, leaves)]
        return (None, None, None, d_traj, d_dec, d_fmap.to(feat_map.dtype),
                None, None, d_wmsg.to(msg_w.dtype), d_bmsg.to(msg_b.dtype),
                d_ltau.to(ltau.dtype).reshape(ltau.shape), *leaf_grads)


def ioc_refine_train(p_ioc, p_scf, traj, dec_h, feat_map, live, fut_mask, *,
                     num_refine, delta_scale, social_freeze=False):
    """The trainable rank-and-refine on the tensors' device: (refined
    (B, A, K, T, 2) f32, scores (B, A, K) in dec_h's dtype, per-pass
    positions (R, B, A, K, T, 2) f32), differentiable in traj, dec_h,
    feat_map and the IOC and message parameters.

    CUDA tensors run the training forward kernel and the backward kernel;
    CPU tensors the plain version under autograd. On CUDA tensors it
    raises before any launch where the backward kernel cannot hold the
    lane's agents (``check_bwd_agents``)."""
    if traj.is_cuda:
        check_bwd_agents(*(int(x) for x in (
            traj.shape[1], traj.shape[3], dec_h.shape[-1], feat_map.shape[-1],
            feat_map.shape[1])), dec_h.dtype == torch.bfloat16)
        leaves = [_ioc_leaf(p_ioc, path) for path in _IOC_LEAVES]
        return _TrainableIoc.apply(
            int(num_refine), float(delta_scale), bool(social_freeze),
            traj.float().contiguous(), dec_h.contiguous(),
            feat_map.contiguous(),
            live.float().contiguous(), fut_mask.float().contiguous(),
            p_scf["soc_msg"]["w"], p_scf["soc_msg"]["b"],
            p_scf["soc_logtau"], *leaves)
    if traj.device.type == "cpu":
        refined, scores, iters = ioc_refine_plain(
            p_ioc, p_scf, traj, dec_h, feat_map, live, fut_mask,
            num_refine=num_refine, delta_scale=delta_scale,
            social_freeze=social_freeze, collect_iters=True)
        return refined, scores.to(dec_h.dtype), iters
    raise ValueError(f"no IOC kernel for device {traj.device}")


def ioc_refine_train_sharded(mesh, p_ioc, p_scf, traj, dec_h, feat_map,
                             live, fut_mask, *, num_refine, delta_scale,
                             social_freeze=False):
    """The trainable rank-and-refine on rank ``(d, k)`` of a ``(data, k)``
    mesh (port of ``make_trainable_fused_ioc_sharded``): the training
    forward and backward kernels (:func:`ioc_refine_train`) on the rank's
    (B/md, A, K/mk) block, its outputs gathered to the K lanes of its rows
    (``parallel.mesh.on_lanes``).

    traj (B/md, A, K, T, 2) and dec_h hold every lane of the rank's rows
    (the training sampler runs all of them); feat_map, live and fut_mask
    hold the same rows. Returns (refined, scores, iters) of the rows, with
    all K lanes, on every rank of the ``k`` group. Every (row, lane) is
    independent, so the forward needs no other collective. The gradients
    that reach traj, dec_h, feat_map and the parameters are mk times the
    rank's lanes' share (the gather's backward); the training step's one
    all-reduce over the mesh, divided by mk, sums them, where the JAX
    package sums the parameter gradients over both axes and d_feat_map
    over ``k`` inside its backward."""
    check_rows(traj, feat_map=feat_map, live=live, fut_mask=fut_mask,
               dec_h=dec_h)
    def refine(traj, dec_h):
        return ioc_refine_train(
            p_ioc, p_scf, traj, dec_h, feat_map, live, fut_mask,
            num_refine=num_refine, delta_scale=delta_scale,
            social_freeze=social_freeze)
    return tuple(mesh_mod.on_lanes(mesh, refine, traj, dec_h, (2, 2, 3)))
