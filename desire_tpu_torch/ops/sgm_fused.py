"""The fused inference CVAE sampler: CUDA kernel wrapper and its plain
PyTorch version (port of ``desire_tpu/ops/sgm_fused.py``).

For a block of agent rows it computes the whole inference SGM:

    masked past-GRU encode over To steps        -> hx (N, d)
    prior head: mu_p, sigma_p = exp(2 tanh(./4)) (zero weights = N(0, I))
    z = mu_p + sigma_p * eps                    for K lanes
    mask MLP: elu(z W1 + b1) -> sigmoid(. W2 + b2) -> softmax(. Wpv + bpv
              + z Wzg + bzg) * d                 -> beta
    seed = beta * hx + z Wzs + bzs + rho_seed
    K-lane GRU decode over T with constant input seed and h0 = hx

and returns the decoder hiddens (N, K, T, d) float32 and hx (N, d) float32.

Numerics follow the TPU kernel: every product rounds its operands to the
compute dtype and accumulates in float32; biases and the element-wise math
stay float32; the per-agent vectors hx, mu_p, sigma_p and rho_seed are
rounded to the compute dtype where they are replicated over the K lanes.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from desire_tpu_torch.ops import _build

_F32 = torch.float32


def _mm(a, b, cd):
    """Product with operands rounded to cd and float32 accumulation."""
    return a.to(cd).to(_F32) @ b.to(cd).to(_F32)


def _rnd(x, cd):
    return x.to(cd).to(_F32)


def _gru(gi, gh, h):
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def _prior(p, d, lat, device):
    if "prior" in p:
        return p["prior"]["w"], p["prior"]["b"]
    return (torch.zeros((d, 2 * lat), dtype=_F32, device=device),
            torch.zeros((2 * lat,), dtype=_F32, device=device))


def sgm_sample_decode_plain(p, feats, obs_mask, rho_seed, eps, pred_len, *,
                            compute_dtype=torch.float32):
    """Plain PyTorch version of the sampler kernel: the inputs and outputs
    of :func:`sgm_sample_decode_cuda`, read from the param tree ``p``."""
    cd = compute_dtype
    n, to, _ = feats.shape
    _, k, lat = eps.shape
    d = rho_seed.shape[-1]
    enc, dec = p["enc_x"][0], p["dec"][0]

    gie = _mm(feats, enc["wi"], cd) + enc["bi"].float()      # (N, To, 3d)
    h = feats.new_zeros((n, d), dtype=_F32)
    for t in range(to):
        gh = _mm(h, enc["wh"], cd) + enc["bh"].float()
        h_new = _gru(gie[:, t], gh, h)
        h = torch.where(obs_mask[:, t, None] > 0, h_new, h)
    hx = h

    prw, prb = _prior(p, d, lat, feats.device)
    pr = _mm(hx, prw, cd) + prb.float()
    mu_p = pr[:, :lat]
    sig_p = torch.exp(0.5 * (4.0 * torch.tanh(pr[:, lat:] / 4.0)))

    # per-agent vectors replicated over the K lanes (rounded to cd)
    hx_rep = _rnd(hx, cd).repeat_interleave(k, dim=0)      # (N*K, d)
    mu_rep = _rnd(mu_p, cd).repeat_interleave(k, dim=0)
    sig_rep = _rnd(sig_p, cd).repeat_interleave(k, dim=0)
    rho_rep = _rnd(rho_seed, cd).repeat_interleave(k, dim=0)
    z = mu_rep + sig_rep * eps.reshape(n * k, lat).float()

    pre1 = _mm(z, p["vdec_fc1"]["w"], cd) + p["vdec_fc1"]["b"].float()
    h1 = torch.where(pre1 > 0, pre1, torch.exp(pre1) - 1.0)
    recon = torch.sigmoid(_mm(h1, p["vdec_fc"]["w"], cd)
                          + p["vdec_fc"]["b"].float())
    logits = (_mm(recon, p["post_vae"]["w"], cd) + p["post_vae"]["b"].float()
              + _mm(z, p["z_gate"]["w"], cd) + p["z_gate"]["b"].float())
    beta = torch.softmax(logits, dim=-1) * float(d)
    seed = (beta * hx_rep + _mm(z, p["z_skip"]["w"], cd)
            + p["z_skip"]["b"].float() + rho_rep)

    gi_d = _mm(seed, dec["wi"], cd) + dec["bi"].float()
    h = hx_rep
    hs = []
    for _ in range(pred_len):
        gh = _mm(h, dec["wh"], cd) + dec["bh"].float()
        h = _gru(gi_d, gh, h)
        hs.append(h)
    dec_h = torch.stack(hs, dim=1).reshape(n, k, pred_len, d)
    return dec_h, hx


@dataclasses.dataclass(frozen=True)
class SamplerWeights:
    """The sampler's weights in the layout its kernel reads, on one device,
    made by :func:`pack_sampler`. A snapshot: later changes to the param
    tree do not reach it.

    use_mma (bf16; lat and hid multiples of 16 up to 128 and 512, d a
    multiple of 16 up to 64, side^2 a multiple of 64: the widths the
    kernel's register tiles are built for) runs the sampler's products on
    the tensor cores, which take the sampler matrices transposed, (out,
    in); the encoder and prior matrices stay (in, out).
    """
    compute_dtype: torch.dtype
    use_mma: bool
    emb: int
    d: int
    lat: int
    hid: int
    side2: int
    tensors: tuple


def pack_sampler(p, compute_dtype, device) -> SamplerWeights:
    """The SGM param tree -> the kernel's weights: matrices in the compute
    dtype, biases in float32, all contiguous on ``device``. A model without
    a prior head gets zero prior weights."""
    cd = compute_dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16: {cd}")
    enc, dec = p["enc_x"][0], p["dec"][0]
    emb, d = int(enc["wi"].shape[0]), int(enc["wh"].shape[0])
    lat = int(p["z_gate"]["w"].shape[0])
    prw, prb = _prior(p, d, lat, device)
    w1, w2 = p["vdec_fc1"]["w"], p["vdec_fc"]["w"]
    hid, side2 = int(w1.shape[1]), int(w2.shape[1])
    use_mma = (cd == torch.bfloat16 and lat % 16 == 0 and lat <= 128
               and hid % 16 == 0 and hid <= 512 and side2 % 64 == 0
               and d % 16 == 0 and d <= 64)

    def w(t):
        return t.to(device=device, dtype=cd).contiguous()

    def m(t):
        return w(t.t() if use_mma else t)

    def b(t):
        return t.to(device=device, dtype=_F32).contiguous()

    tensors = (w(enc["wi"]), w(enc["wh"]), b(enc["bi"]), b(enc["bh"]),
               w(prw), b(prb),
               m(w1), b(p["vdec_fc1"]["b"]), m(w2), b(p["vdec_fc"]["b"]),
               m(p["post_vae"]["w"]), b(p["post_vae"]["b"]),
               m(p["z_gate"]["w"]), b(p["z_gate"]["b"]),
               m(p["z_skip"]["w"]), b(p["z_skip"]["b"]),
               m(dec["wi"]), m(dec["wh"]), b(dec["bi"]), b(dec["bh"]))
    return SamplerWeights(cd, use_mma, emb, d, lat, hid, side2, tensors)


def sgm_sample_decode_cuda(w: SamplerWeights, feats, obs_mask, rho_seed, eps,
                           pred_len):
    """Launch the sampler kernel (``csrc/sgm_sample.cu``) on CUDA tensors,
    with the weights of :func:`pack_sampler`.

    feats (N, To, emb) compute dtype — relu(dense(embed_x, traj feats));
    obs_mask (N, To) float32; rho_seed (N, d) float32; eps (N, K, lat)
    compute dtype. Returns (dec_h (N, K, pred_len, d) f32, hx (N, d) f32).
    """
    if not feats.is_cuda:
        raise ValueError("sgm_sample_decode_cuda needs CUDA tensors")
    cd, dev = w.compute_dtype, feats.device
    n, to = feats.shape[0], feats.shape[1]
    if eps.dim() != 3 or eps.shape[0] != n:
        raise ValueError(f"eps must be (N={n}, K, lat): {tuple(eps.shape)}")
    k = eps.shape[1]
    _build.check(feats, "feats", (n, to, w.emb), cd, dev)
    _build.check(obs_mask, "obs_mask", (n, to), _F32, dev)
    _build.check(rho_seed, "rho_seed", (n, w.d), _F32, dev)
    _build.check(eps, "eps", (n, k, w.lat), cd, dev)
    if w.tensors[0].device != dev:
        raise ValueError(f"weights on {w.tensors[0].device}, inputs on {dev}")
    musig = torch.empty((n, 2 * w.lat), dtype=_F32, device=dev)
    dec_h = torch.empty((n, k, pred_len, w.d), dtype=_F32, device=dev)
    hx = torch.empty((n, w.d), dtype=_F32, device=dev)
    ptrs = [feats, obs_mask, rho_seed, eps, *w.tensors, musig, dec_h, hx]
    rc = _build.library().sgm_sample_launch(
        int(cd == torch.bfloat16), int(w.use_mma),
        *[t.data_ptr() for t in ptrs],
        n, to, w.emb, w.d, w.lat, w.hid, w.side2, k, int(pred_len),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"sgm_sample kernel launch failed: CUDA error {rc}")
    _build.LAUNCHES["sgm_sample"] += 1
    return dec_h, hx


def sgm_sample_decode(p, feats, obs_mask, rho_seed, eps, pred_len, *,
                      compute_dtype=torch.float32, weights=None):
    """The sampler on the tensors' device: the CUDA kernel for CUDA
    tensors, with ``weights`` from :func:`pack_sampler` (packed from ``p``
    when not given), the plain version for CPU tensors."""
    if feats.is_cuda:
        if weights is None:
            weights = pack_sampler(p, compute_dtype, feats.device)
        return sgm_sample_decode_cuda(weights, feats, obs_mask, rho_seed, eps,
                                      pred_len)
    if feats.device.type == "cpu":
        return sgm_sample_decode_plain(p, feats, obs_mask, rho_seed, eps,
                                       pred_len, compute_dtype=compute_dtype)
    raise ValueError(f"no sampler for device {feats.device}")


def sgm_sample_decode_sharded(mesh, p, feats, obs_mask, rho_seed, eps,
                              pred_len, *, compute_dtype=torch.float32,
                              weights=None):
    """The sampler on rank ``(d, k)`` of a ``(data, k)`` mesh
    (``parallel/mesh.py``): its launch (:func:`sgm_sample_decode`) on its
    block of the N agent rows and K lanes.

    feats, obs_mask, rho_seed and eps hold the rank's rows, block d of the
    global batch's (``mesh.rows(N)``, cut by the caller where the batch
    enters, so that the encoders before the kernel run on them alone); eps
    holds every lane, and the rank launches on its block k
    (``mesh.lanes(K)``). Every (row, lane) is independent and each lane
    block recomputes its rows' encoder (a d-wide GRU over To steps, small
    beside the K-lane decode), so there are no collectives. Returns
    (dec_h (N/md, K/mk, pred_len, d) f32, hx (N/md, d) f32)."""
    lanes = eps[:, mesh.lanes(eps.shape[1])].contiguous()
    return sgm_sample_decode(p, feats, obs_mask, rho_seed, lanes, pred_len,
                             compute_dtype=compute_dtype, weights=weights)
