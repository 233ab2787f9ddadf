"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``cuda``; they skip where no CUDA device is visible).

This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)
"""

import os
import sys

import numpy as np
import pytest
import torch

from desire_tpu_torch import DesireConfig
from desire_tpu_torch.models.ioc import _DELTA_SCALE
from desire_tpu_torch.ops import _build, ioc_fused, sgm_fused
from desire_tpu_torch.params import init_desire, to_device
from desire_tpu_torch.train.state import tree_leaves

# f32: the kernel and the plain version differ only in the order of float32
# sums and in fused multiply-adds (the JAX kernel suite's tolerances)
TOL = dict(rtol=2e-4, atol=2e-5)
SCORE_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # float32 means float32: no TF32 in cuBLAS or in cuDNN's convolutions
    # (the scene CNN), as chip_smoke.py sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _params(cfg, device):
    g = torch.Generator().manual_seed(0)
    p = init_desire(cfg, g, "cpu")
    for path, scale in ((("sgm", "prior"), 0.1), (("ioc", "delta"), 0.3),
                        (("ioc", "gate"), 0.3)):
        w = p[path[0]][path[1]]["w"]
        p[path[0]][path[1]]["w"] = scale * torch.randn(w.shape, generator=g)
    return to_device(p, device)


def _cfg(**kw):
    base = dict(obs_len=5, pred_len=6, num_samples=3, d_dim=16,
                latent_size=8, embedding_size=8, channel_multiplier=10,
                rnn_size=128, scene_grid=8, scene_channels=8, num_refine=2,
                max_num_obj=5, compute_dtype="float32")
    base.update(kw)
    return DesireConfig(**base)


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype,lat", [
    (7, "float32", 8), (40, "float32", 8), (40, "bfloat16", 8),
    (40, "bfloat16", 16)])
def test_sampler_kernel_matches_plain(cuda_device, n, dtype, lat):
    """bf16 with lat 16 takes the tensor-core path, lat 8 the CUDA-core
    one. In bf16 a sum taken in another order can flip an operand's
    rounding by one bf16 step (2^-8), so single elements may differ by a
    few 1e-2 while the mean error stays near float32 level."""
    cfg = _cfg(latent_size=lat, compute_dtype=dtype)
    cd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    p = _params(cfg, cuda_device)["sgm"]
    rng = np.random.default_rng(n)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                  device=cuda_device)
    mask = np.ones((n, cfg.obs_len))
    mask[0, 0] = 0.0
    args = (t(np.maximum(rng.standard_normal(
                (n, cfg.obs_len, cfg.embedding_size)), 0)),
            t(mask),
            t(np.maximum(rng.standard_normal((n, cfg.d_dim)), 0)),
            t(rng.standard_normal((n, cfg.num_samples, cfg.latent_size))))
    args = (args[0].to(cd), args[1], args[2], args[3].to(cd))
    before = _build.LAUNCHES["sgm_sample"]
    w = sgm_fused.pack_sampler(p, cd, cuda_device)
    assert w.use_mma == (dtype == "bfloat16" and lat == 16)
    got = sgm_fused.sgm_sample_decode_cuda(w, *args, cfg.pred_len)
    assert _build.LAUNCHES["sgm_sample"] == before + 1
    ref = sgm_fused.sgm_sample_decode_plain(p, *args, cfg.pred_len,
                                            compute_dtype=cd)
    for g, r in zip(got, ref):
        g, r = g.cpu().numpy(), r.cpu().numpy()
        if cd == torch.float32:
            np.testing.assert_allclose(g, r, **TOL)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=5e-2)
            assert np.abs(g - r).mean() < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,a,social_freeze", [
    ("float32", 8, 5, False), ("float32", 8, 5, True),
    ("bfloat16", 8, 5, False), ("bfloat16", 16, 5, False),
    ("bfloat16", 16, 5, True), ("bfloat16", 16, 70, False)])
def test_ioc_kernel_matches_plain(cuda_device, dtype, c, a, social_freeze):
    """bf16 with C = 16 (A <= 128) takes the tensor-core path, A = 70
    with one lane a block; C = 8 the CUDA-core one. bf16 tolerances as in
    chip_smoke.py: rare rounding flips move single elements, the mean
    error stays small."""
    cfg = _cfg(scene_channels=c, compute_dtype=dtype)
    cd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    p = _params(cfg, cuda_device)
    b, k, t, d = 2, 3, 6, 16
    rng = np.random.default_rng(1)
    f = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x, np.float32), device=cuda_device).to(dt)
    live = (rng.random((b, a)) > 0.3).astype(np.float32)
    live[:, 0] = 1.0
    fut = np.ones((b, a, t))
    fut[:, :, -1] = 0.0
    args = (f(rng.uniform(0.2, 0.8, (b, a, k, t, 2))),
            f(np.tanh(rng.standard_normal((b, a, k, t, d))), cd),
            f(rng.standard_normal((b, 8, 8, c)), cd), f(live), f(fut))
    kw = dict(num_refine=2, delta_scale=_DELTA_SCALE,
              social_freeze=social_freeze)
    before = _build.LAUNCHES["ioc_refine"]
    w = ioc_fused.pack_ioc(p["ioc"], p["scf"], cd, cuda_device, a)
    assert w.use_mma == (dtype == "bfloat16" and c == 16 and a <= 128)
    got = ioc_fused.ioc_refine_cuda(w, *args, **kw)
    assert _build.LAUNCHES["ioc_refine"] == before + 1
    ref = ioc_fused.ioc_refine_plain(p["ioc"], p["scf"], *args, **kw)
    g_traj, r_traj = got[0].cpu().numpy(), ref[0].cpu().numpy()
    g_sc, r_sc = got[1].cpu().numpy(), ref[1].cpu().numpy()
    if cd == torch.float32:
        np.testing.assert_allclose(g_traj, r_traj, **TOL)
        np.testing.assert_allclose(g_sc, r_sc, **SCORE_TOL)
    else:
        np.testing.assert_allclose(g_traj, r_traj, rtol=0, atol=5e-3)
        np.testing.assert_allclose(g_sc, r_sc, rtol=0, atol=0.1)
        assert np.abs(g_traj - r_traj).mean() < 2e-4
        assert np.abs(g_sc - r_sc).mean() < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,lat,d", [
    (7, 3, 16, 16), (40, 20, 16, 16), (7, 3, 128, 16), (40, 20, 128, 16),
    (7, 3, 16, 64), (40, 20, 128, 32)])
def test_sampler_tensor_core_path_matches_plain(cuda_device, n, k, lat, d):
    """The sampler's tensor-core path (64 lane rows a block) on row counts
    N * K = 21 and 800 that are not multiples of 64, at lat 16 and 128
    (hid 128 and 512) and d 16, 32 and 64, against the plain version in
    bf16."""
    cfg = _cfg(latent_size=lat, num_samples=k, compute_dtype="bfloat16",
               d_dim=d)
    p = _params(cfg, cuda_device)["sgm"]
    rng = np.random.default_rng(n + lat)
    t = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x, np.float32), device=cuda_device).to(dt)
    mask = np.ones((n, cfg.obs_len))
    mask[rng.random(n) < 0.3, :2] = 0.0
    args = (t(np.maximum(rng.standard_normal(
                (n, cfg.obs_len, cfg.embedding_size)), 0), torch.bfloat16),
            t(mask), t(np.maximum(rng.standard_normal((n, cfg.d_dim)), 0)),
            t(rng.standard_normal((n, k, lat)), torch.bfloat16))
    w = sgm_fused.pack_sampler(p, torch.bfloat16, cuda_device)
    assert w.use_mma
    got = sgm_fused.sgm_sample_decode_cuda(w, *args, cfg.pred_len)
    ref = sgm_fused.sgm_sample_decode_plain(p, *args, cfg.pred_len,
                                            compute_dtype=torch.bfloat16)
    for g, r in zip(got, ref):
        g, r = g.cpu().numpy(), r.cpu().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0, atol=5e-2)
        assert np.abs(g - r).mean() < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("a,k,live_mode,social_freeze,d,t", [
    (5, 3, "dead", False, 16, 6), (20, 7, "dead", True, 16, 6),
    (60, 50, "dead", False, 16, 6), (1, 7, "all", False, 16, 6),
    (40, 7, "lone", True, 16, 6), (64, 5, "lone", False, 16, 6),
    (20, 5, "dead", False, 64, 6), (12, 5, "dead", False, 32, 1),
    (12, 5, "dead", True, 16, 2), (30, 3, "dead", False, 64, 2)])
@pytest.mark.parametrize("collect_iters", [False, True])
def test_ioc_tensor_core_path_matches_plain(cuda_device, a, k, live_mode,
                                            social_freeze, d, t,
                                            collect_iters):
    """The IOC kernel's tensor-core path (several lanes a block) against the
    plain version in bf16: K = 3, 7 and 50, which the lanes a block do not
    all divide; A = 1; dead agents; a batch row whose one live agent has no
    live neighbour; social_freeze; d = 16, 32 and 64; T = 1 and 2, where a
    ring slot goes back to the producers only after the step's deltas; with
    collect_iters every refine pass's positions. bf16 tolerances as in
    chip_smoke.py."""
    cfg = _cfg(scene_channels=16, compute_dtype="bfloat16", max_num_obj=a,
               num_samples=k, d_dim=d, pred_len=t)
    p = _params(cfg, cuda_device)
    b = 2
    rng = np.random.default_rng(a * k)
    f = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x, np.float32), device=cuda_device).to(dt)
    live = np.ones((b, a), np.float32)
    if live_mode in ("dead", "lone"):
        live = (rng.random((b, a)) > 0.3).astype(np.float32)
        live[:, 0] = 1.0
    if live_mode == "lone":
        live[0, 1:] = 0.0
    fut = np.ones((b, a, t)) * live[..., None]
    fut[:, :, -1] = 0.0
    args = (f(rng.uniform(0.2, 0.8, (b, a, k, t, 2))),
            f(np.tanh(rng.standard_normal((b, a, k, t, d))), torch.bfloat16),
            f(rng.standard_normal((b, 8, 8, 16)), torch.bfloat16), f(live),
            f(fut))
    kw = dict(num_refine=2, delta_scale=_DELTA_SCALE,
              social_freeze=social_freeze, collect_iters=collect_iters)
    w = ioc_fused.pack_ioc(p["ioc"], p["scf"], torch.bfloat16, cuda_device,
                           a)
    assert w.use_mma
    got = ioc_fused.ioc_refine_cuda(w, *args, **kw)
    ref = ioc_fused.ioc_refine_plain(p["ioc"], p["scf"], *args, **kw)
    assert len(got) == len(ref) == (3 if collect_iters else 2)
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.cpu().numpy(), r.cpu().numpy()
        assert g.shape == r.shape and np.isfinite(g).all()
        atol, mean = (0.1, 5e-3) if i == 1 else (5e-3, 2e-4)
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)
        assert np.abs(g - r).mean() < mean


def _crowd_case(cuda_device, a, k=20, b=4, seed=0):
    """IOC kernel inputs at the flagship's widths (d 48, C 32, G 32, T 12,
    4 refine passes) with ``a`` agents, every one live."""
    cfg = _cfg(scene_channels=32, scene_grid=32, d_dim=48, pred_len=12,
               num_refine=4, compute_dtype="bfloat16", max_num_obj=a,
               num_samples=k)
    p = _params(cfg, cuda_device)
    rng = np.random.default_rng(seed + a)
    f = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x, np.float32), device=cuda_device).to(dt)
    fut = np.ones((b, a, 12), np.float32)
    fut[:, :, -1] = 0.0
    args = (f(rng.uniform(0.2, 0.8, (b, a, k, 12, 2))),
            f(np.tanh(rng.standard_normal((b, a, k, 12, 48))),
              torch.bfloat16),
            f(np.maximum(rng.standard_normal((b, 32, 32, 32)), 0.0),
              torch.bfloat16),
            f(np.ones((b, a))), f(fut))
    return cfg, p, args


def _tile_from_next_lane(dec_h):
    """dec_h with lane 0 of row 0 reading lane 1's last agent tile (one
    lane's producer loading another lane's rows)."""
    bad = dec_h.clone()
    a = bad.shape[1]
    lo = (a - 1) // 16 * 16
    bad[0, lo:, 0] = bad[0, lo:, 1]
    return bad


def _within_bf16(got, ref):
    """The bf16 kernel tolerances of chip_smoke.py (BF16_TOL, BF16_MEAN_TOL)
    for (refined, scores[, iters])."""
    for i, (g, r) in enumerate(zip(got, ref)):
        err = (g.float() - r.float()).abs()
        mx, mean = (0.1, 5e-3) if i == 1 else (5e-3, 2e-4)
        if not (bool(torch.isfinite(g).all()) and float(err.max()) <= mx
                and float(err.mean()) < mean):
            return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("a,social_freeze,collect_iters,block", [
    (60, False, False, (2, 2)), (65, False, False, (1, 2)),
    (96, False, False, (1, 2)), (128, False, False, (1, 2)),
    (128, True, False, (1, 1)), (128, False, True, (1, 2))])
def test_ioc_tensor_core_path_past_64_agents(cuda_device, a, social_freeze,
                                             collect_iters, block):
    """The tensor-core IOC kernel at the flagship's widths, K = 20, with 60
    agents (two lanes a block, a ring of two step tiles) and 65, 96 and
    128 (one lane a block: 8 lanes an attention row); at 128 under
    social_freeze the initial positions leave room for one step tile
    only. Against the plain version in bf16 within chip_smoke.py's kernel
    tolerances; a lane that reads the next lane's last agent tile fails
    them."""
    cfg, p, args = _crowd_case(cuda_device, a)
    kw = dict(num_refine=4, delta_scale=_DELTA_SCALE,
              social_freeze=social_freeze, collect_iters=collect_iters)
    shape = ioc_fused.tc_block_shape(a, 20, 12, 48, 32, social_freeze)
    assert shape[:2] == block and shape[2] <= 232448
    w = ioc_fused.pack_ioc(p["ioc"], p["scf"], torch.bfloat16, cuda_device,
                           a)
    assert w.use_mma
    from desire_tpu_torch.utils import telemetry
    before = telemetry.snapshot()["counters"]
    got = ioc_fused.ioc_refine_cuda(w, *args, **kw)
    after = telemetry.snapshot()["counters"]
    assert after.get("ioc.agent_tiles", 0) - before.get(
        "ioc.agent_tiles", 0) == (a + 15) // 16
    assert after.get("launch.ioc_refine.mma", 0) - before.get(
        "launch.ioc_refine.mma", 0) == (0 if collect_iters else 1)
    ref = ioc_fused.ioc_refine_plain(p["ioc"], p["scf"], *args, **kw)
    assert _within_bf16(got, ref)
    bad = (args[0], _tile_from_next_lane(args[1]), *args[2:])
    assert not _within_bf16(ioc_fused.ioc_refine_cuda(w, *bad, **kw), ref)


@pytest.mark.cuda
def test_ioc_tensor_core_path_refuses_past_128_agents(cuda_device):
    """No tensor-core layout past 128 agents: the kernel library says so,
    and pack_ioc refuses rather than fall back."""
    assert ioc_fused.tc_block_shape(129, 20, 12, 48, 32) is None
    assert ioc_fused.tc_block_shape(128, 20, 12, 48, 32) is not None
    cfg, p, _ = _crowd_case(cuda_device, 8)
    with pytest.raises(ValueError, match="at most 128"):
        ioc_fused.pack_ioc(p["ioc"], p["scf"], torch.bfloat16, cuda_device,
                           129)


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,c,g,bf16", [
    (6, 16, 8, 8, 0), (12, 48, 32, 32, 1), (6, 16, 8, 8, 1),
    (12, 48, 32, 32, 0)])
def test_ioc_backward_agent_limit(cuda_device, t, d, c, g, bf16):
    """The library's most agents a lane is the last whose BwdLayout fits
    a block: the check passes it and names it one agent past it (64 at
    the flagship's widths)."""
    from desire_tpu_torch.ops import ioc_bwd
    lib = _build.library()
    most = lib.ioc_refine_bwd_max_agents(t, d, c, g, bf16)
    assert 0 < most < 4096
    if (t, d, c, g, bf16) == (12, 48, 32, 32, 1):
        assert most == 64
    sizes = [lib.ioc_refine_bwd_smem_bytes(a, t, d, c, g, bf16)
             for a in (1, most, most + 1)]
    assert sizes == sorted(sizes)
    ioc_bwd.check_bwd_agents(most, t, d, c, g, bool(bf16))
    with pytest.raises(ValueError, match=f"at most {most} agents"):
        ioc_bwd.check_bwd_agents(most + 1, t, d, c, g, bool(bf16))


@pytest.mark.cuda
def test_train_step_past_the_backward_limit_raises_before_any_launch(
        cuda_device):
    """A training step at 128 agents, flagship widths: the fused IOC
    backward's layout does not fit, and the step says so before it
    launches anything."""
    from desire_tpu_torch.train.state import create_train_state
    from desire_tpu_torch.train.trainer import make_train_step
    cfg = _cfg(scene_channels=32, scene_grid=32, d_dim=48, pred_len=12,
               num_refine=4, compute_dtype="bfloat16", max_num_obj=128,
               batch_size=2)
    state = create_train_state(cfg, _params(cfg, cuda_device), seed=0)
    step_fn = make_train_step(cfg, steps_per_epoch=10)
    b, t, a = 2, cfg.total_len, cfg.max_num_obj
    xy = torch.full((b, t, a, 2), 0.5, device=cuda_device)
    mask = torch.ones((b, t, a), device=cuda_device)
    ids = torch.arange(1, a + 1, device=cuda_device).float().repeat(b, 1)
    launched = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="BwdLayout.*at most 64 agents"):
        step_fn(state, xy, mask, ids)
    assert dict(_build.LAUNCHES) == launched


def _ioc_train_case(cuda_device, dtype, c, a, d=16, seed=1, t=6):
    cfg = _cfg(scene_channels=c, compute_dtype=dtype, max_num_obj=a,
               d_dim=d, pred_len=t)
    cd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    p = _params(cfg, cuda_device)
    b, k = 2, 3
    rng = np.random.default_rng(seed)
    f = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x, np.float32), device=cuda_device).to(dt)
    live = (rng.random((b, a)) > 0.3).astype(np.float32)
    live[:, 0] = 1.0
    fut = np.ones((b, a, t))
    if t > 1:
        fut[:, :, -1] = 0.0
    args = (f(rng.uniform(0.2, 0.8, (b, a, k, t, 2))),
            f(np.tanh(rng.standard_normal((b, a, k, t, d))), cd),
            f(rng.standard_normal((b, 8, 8, c)), cd), f(live), f(fut))
    wts = f(rng.standard_normal((b, a, k)))
    return cfg, p, args, wts


def _ioc_train_grads(p, args, wts, kernel, social_freeze=False,
                     num_refine=2):
    """Gradients of the JAX kernel suite's IOC test loss for the inputs and
    every IOC and message parameter, through the kernels or autograd
    through the plain version."""
    from desire_tpu_torch.ops import ioc_bwd
    from desire_tpu_torch.train.state import tree_leaves, tree_unflatten
    traj, dec_h, fmap, live, fut = args
    trees = {"ioc": p["ioc"], "scf": {"soc_msg": p["scf"]["soc_msg"],
                                      "soc_logtau": p["scf"]["soc_logtau"]}}
    leaves = [x.detach().clone().requires_grad_(True)
              for x in tree_leaves(trees)]
    trees = tree_unflatten(trees, leaves)
    ins = [x.detach().clone().requires_grad_(True)
           for x in (traj, dec_h, fmap)]
    kw = dict(num_refine=num_refine, delta_scale=_DELTA_SCALE,
              social_freeze=social_freeze)
    if kernel:
        refined, scores, iters = ioc_bwd.ioc_refine_train(
            trees["ioc"], trees["scf"], *ins, live, fut, **kw)
    else:
        refined, scores, iters = ioc_fused.ioc_refine_plain(
            trees["ioc"], trees["scf"], *ins, live, fut, collect_iters=True,
            **kw)
    loss = ((refined ** 2).sum() + (scores.float() * wts).sum()
            + (iters ** 2).sum() + torch.sin(refined).sum())
    return torch.autograd.grad(loss, leaves + ins)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,a,d,social_freeze", [
    ("float32", 8, 5, 16, False), ("bfloat16", 16, 5, 16, False),
    ("bfloat16", 8, 70, 16, False), ("float32", 8, 5, 16, True),
    ("bfloat16", 16, 5, 16, True), ("bfloat16", 8, 70, 16, True),
    ("bfloat16", 32, 60, 48, False), ("bfloat16", 32, 60, 48, True),
    ("bfloat16", 16, 20, 16, False), ("bfloat16", 16, 20, 16, True),
    ("bfloat16", 32, 5, 48, False), ("float32", 32, 20, 48, False),
    ("float32", 32, 20, 48, True)])
def test_ioc_training_kernels_match_autograd(cuda_device, dtype, c, a, d,
                                             social_freeze):
    """The training forward (collect_iters) and the backward kernel against
    autograd through the plain version, every input and parameter leaf,
    with and without social_freeze (its deferred attention adjoint).
    bf16 with d and C multiples of 16 takes the backward's tensor-core
    variant (operand tiles padded to 16 agent rows: A = 5, 20 and 60 are
    not multiples of 16), the others its CUDA-core variant.
    f32: the JAX kernel suite's gradient tolerances. bf16: relative L2
    error of each leaf (the kernel keeps cotangents in float32 where
    autograd rounds them to bf16 at every cast)."""
    cfg, p, args, wts = _ioc_train_case(cuda_device, dtype, c, a, d)
    before = {n: _build.LAUNCHES[n] for n in ("ioc_refine_train",
                                              "ioc_refine_bwd")}
    got = _ioc_train_grads(p, args, wts, kernel=True,
                           social_freeze=social_freeze)
    assert all(_build.LAUNCHES[n] == before[n] + 1 for n in before)
    ref = _ioc_train_grads(p, args, wts, kernel=False,
                           social_freeze=social_freeze)
    for g, r in zip(got, ref):
        g, r = g.float().cpu(), r.float().cpu()
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-3,
                                       atol=2e-4)
        else:
            assert float((g - r).norm() / max(float(r.norm()), 1e-30)) \
                < 0.05
    w = ioc_fused.pack_ioc(p["ioc"], p["scf"], args[1].dtype, cuda_device,
                           a)
    kw = dict(num_refine=2, delta_scale=_DELTA_SCALE,
              social_freeze=social_freeze, collect_iters=True)
    outs = ioc_fused.ioc_refine_cuda(w, *args, **kw)
    plain = ioc_fused.ioc_refine_plain(p["ioc"], p["scf"], *args, **kw)
    np.testing.assert_allclose(outs[2].cpu().numpy(),
                               plain[2].cpu().numpy(), rtol=0,
                               atol=2e-5 if dtype == "float32" else 5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("c,a,d", [(16, 5, 16), (32, 60, 48), (8, 5, 16)])
@pytest.mark.parametrize("social_freeze", [False, True])
def test_ioc_backward_kernel_is_deterministic(cuda_device, social_freeze, c,
                                              a, d):
    """Two runs on the same inputs give bitwise-equal gradients (the
    tensor-core variant at two sizes, and the CUDA-core one). The
    tensor-core variant launches the weight-gradient product once a call,
    the CUDA-core one never."""
    cfg, p, args, wts = _ioc_train_case(cuda_device, "bfloat16", c, a, d)
    before = dict(_build.LAUNCHES)
    first = _ioc_train_grads(p, args, wts, kernel=True,
                             social_freeze=social_freeze)
    second = _ioc_train_grads(p, args, wts, kernel=True,
                              social_freeze=social_freeze)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    calls = _build.LAUNCHES["ioc_refine_bwd"] - before["ioc_refine_bwd"]
    assert calls == 2
    assert _build.LAUNCHES["ioc_bwd_wgrad"] - before["ioc_bwd_wgrad"] \
        == (calls if c % 16 == 0 and d % 16 == 0 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("c,a,d,t,r", [
    (32, 60, 48, 12, 4),   # the flagship's widths, agents, steps and passes
    (16, 37, 16, 6, 2),    # agents not a multiple of 16
    (32, 5, 48, 1, 2),     # one step (and a last chunk of the log half full)
    (16, 20, 32, 6, 1),    # one refine pass
    (32, 20, 64, 6, 2)])   # more output tiles than the product has warps
@pytest.mark.parametrize("social_freeze", [False, True])
def test_ioc_backward_deferred_weight_gradients(cuda_device, c, a, d, t, r,
                                                social_freeze):
    """The tensor-core variant, whose input and hidden matrices' gradients
    the product kernel forms after the passes from the operand log (one
    launch a call), against autograd through the plain version, every
    input and parameter leaf: the relative L2 error of
    test_ioc_training_kernels_match_autograd."""
    cfg, p, args, wts = _ioc_train_case(cuda_device, "bfloat16", c, a, d,
                                        t=t)
    before = dict(_build.LAUNCHES)
    got = _ioc_train_grads(p, args, wts, kernel=True,
                           social_freeze=social_freeze, num_refine=r)
    assert all(_build.LAUNCHES[n] == before[n] + 1
               for n in ("ioc_refine_bwd", "ioc_bwd_wgrad"))
    ref = _ioc_train_grads(p, args, wts, kernel=False,
                           social_freeze=social_freeze, num_refine=r)
    for g, x in zip(got, ref):
        g, x = g.float().cpu(), x.float().cpu()
        assert torch.isfinite(g).all()
        assert float((g - x).norm() / max(float(x.norm()), 1e-30)) < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 5, 3, 6, 16, 8, 2), (64, 60, 20, 12, 48, 32, 4),
    (3, 20, 7, 12, 32, 16, 1)])
@pytest.mark.parametrize("social_freeze", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_ioc_backward_workspace_size(cuda_device, shape, social_freeze,
                                     bf16):
    """The workspace the wrapper allocates is what the kernel source
    computes for itself (bf16 at widths multiples of 16: with the operand
    log; C = 8: the CUDA-core variant, without)."""
    from desire_tpu_torch.ops import ioc_bwd
    want = _build.library().ioc_refine_bwd_ws_words(
        *shape, int(social_freeze), int(bf16))
    assert ioc_bwd.bwd_workspace_words(*shape, social_freeze, bf16) == want


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,t", [(9, 3, 6), (300, 20, 12), (7, 5, 11)])
def test_nll_kernels_match_plain(cuda_device, n, k, t):
    """The NLL forward and backward kernels against the plain version and
    its autograd, with rows where the log-density floor is active (zero
    gradient there). The backward's blocks take 256 items: 162, 72,000 and
    385 items leave a partial last block."""
    from desire_tpu_torch.ops import nll
    rng = np.random.default_rng(n)
    raw5 = rng.standard_normal((n, k, t, 5)) * 0.5
    tgt = rng.uniform(0.2, 0.8, (n, t, 2))
    raw5[..., :2] += tgt[:, None]
    raw5[::7, ..., :2] = tgt[::7, None] + 5.0
    raw5[::7, ..., 2:4] = -8.0
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                  device=cuda_device)
    raw5, tgt = f(raw5), f(tgt)
    mask = f(rng.random((n, t)) > 0.1)
    r = raw5.clone().requires_grad_(True)
    before = (_build.LAUNCHES["nll_fwd"], _build.LAUNCHES["nll_bwd"])
    got = nll.bivariate_nll_sum(r, tgt, mask)
    ref = nll.bivariate_nll_plain(raw5, tgt, mask)
    np.testing.assert_allclose(got.detach().cpu().numpy(),
                               ref.cpu().numpy(), rtol=1e-5, atol=1e-5)
    g = f(rng.standard_normal((n, k)))
    g_got, = torch.autograd.grad((got * g).sum(), [r])
    assert (_build.LAUNCHES["nll_fwd"], _build.LAUNCHES["nll_bwd"]) == (
        before[0] + 1, before[1] + 1)
    r2 = raw5.clone().requires_grad_(True)
    g_ref, = torch.autograd.grad(
        (nll.bivariate_nll_plain(r2, tgt, mask) * g).sum(), [r2])
    np.testing.assert_allclose(g_got.cpu().numpy(), g_ref.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert float(g_got[::7].abs().max()) == 0.0


def _scene_pool_case(device, b, g, c, p, dtype, seed=0):
    """Map, positions (a quarter on grid nodes, a quarter outside [0, 1],
    the last six on the borders and corners) and a cotangent."""
    rng = np.random.default_rng(seed)
    cd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    pos = rng.uniform(0.0, 1.0, (b, p, 2))
    q = p // 4
    pos[:, :q] = rng.integers(0, g, (b, q, 2)) / (g - 1)
    pos[:, q:2 * q] = rng.uniform(-0.5, 1.5, (b, q, 2))
    pos[:, -6:] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.3],
                   [0.7, 0.0], [1.0, 0.0]]
    f = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x, np.float32), device=device).to(dt)
    return (f(rng.standard_normal((b, g, g, c)), cd), f(pos),
            f(rng.standard_normal((b, p, c)), cd))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,p", [
    ("float32", 32, 700), ("float32", 8, 700), ("bfloat16", 32, 700),
    ("bfloat16", 8, 1000), ("bfloat16", 32, 14400), ("bfloat16", 12, 701),
    ("float32", 12, 701), ("bfloat16", 32, 701), ("float32", 6, 33)])
def test_scene_pool_kernels_match_plain(cuda_device, dtype, c, p):
    """Forward, d_map and d_pos against the plain versions on the card (P
    not a multiple of the kernels' chunk nor of the forward's points per
    warp; C = 32 and 8 take the forward's vector path in both dtypes, C =
    12 only in float32, C = 6 the channel loop in both), and d_map bitwise
    equal in two runs. f32: the same products summed in
    another order (d_map sums up to hundreds of points per node; d_pos sums
    C terms of up to ~(G - 1) * 4 each, whose float32 rounding reaches
    ~1e-4 where they cancel). bf16: a result rounded to bf16 may land one
    step (2^-7 relative at most) away."""
    from desire_tpu_torch.ops import scene_pool
    fm, pos, g = _scene_pool_case(cuda_device, 3, 32, c, p, dtype)
    before = (_build.LAUNCHES["scene_pool_fwd"],
              _build.LAUNCHES["scene_pool_bwd"])
    got = scene_pool.scene_pool_fwd_cuda(fm, pos)
    d_map, d_pos = scene_pool.scene_pool_bwd_cuda(fm, pos, g)
    assert (_build.LAUNCHES["scene_pool_fwd"],
            _build.LAUNCHES["scene_pool_bwd"]) == (before[0] + 1,
                                                   before[1] + 1)
    ref = scene_pool.bilinear_pool_plain(fm, pos)
    r_map, r_pos = scene_pool.bilinear_pool_plain_bwd(fm, pos, g)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2.0 ** -7, atol=1e-6))
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)
    np.testing.assert_allclose(d_map.float().cpu().numpy(),
                               r_map.float().cpu().numpy(),
                               rtol=1e-4 if dtype == "float32" else 2.0 ** -7,
                               atol=1e-4)
    np.testing.assert_allclose(d_pos.cpu().numpy(), r_pos.cpu().numpy(),
                               rtol=1e-4, atol=1e-3)
    assert float(d_pos[:, p // 4: p // 2][
        (pos[:, p // 4: p // 2] < 0) | (pos[:, p // 4: p // 2] > 1)]
        .abs().max()) == 0.0
    again = scene_pool.scene_pool_bwd_cuda(fm, pos, g)
    assert torch.equal(again[0], d_map) and torch.equal(again[1], d_pos)


def _scene_pool_piles(device, b, g, c, p, dtype, seed=0):
    """Positions that pile up: 3,000 beyond (1, 1) (the far corner cell,
    whose four corners coincide), 2,000 inside cell (0, 0), 3,000 below
    the first grid row (clamped onto the border row's cells), 64 and 65 in
    two cells (a bucket of exactly one segment and of just over one), the
    rest uniform in [0, 1]; a map and a cotangent."""
    rng = np.random.default_rng(seed)
    cd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    h = 1.0 / (g - 1)
    pos = rng.uniform(0.0, 1.0, (b, p, 2))
    pos[:, :3000] = rng.uniform(1.0, 1.3, (b, 3000, 2))
    pos[:, 3000:5000] = rng.uniform(0.0, h, (b, 2000, 2)) * 0.999
    pos[:, 5000:8000, 1] = rng.uniform(-0.4, 0.0, (b, 3000))
    pos[:, 8000:8064] = (np.asarray([3, 5]) + rng.uniform(
        0.01, 0.99, (b, 64, 2))) * h
    pos[:, 8064:8129] = (np.asarray([6, 2]) + rng.uniform(
        0.01, 0.99, (b, 65, 2))) * h
    f = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x, np.float32), device=device).to(dt)
    return (f(rng.standard_normal((b, g, g, c)), cd), f(pos),
            f(rng.standard_normal((b, p, c)), cd))


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype,g,c,p", [
    ("piles", "bfloat16", 32, 32, 14400), ("piles", "float32", 32, 32, 14400),
    ("piles", "float32", 32, 12, 14400), ("spread", "bfloat16", 27, 32, 2000),
    ("spread", "float32", 27, 12, 2001), ("piles", "bfloat16", 27, 8, 9000),
    ("spread", "bfloat16", 32, 32, 60000)])
def test_scene_pool_gradient_piles_and_odd_grids(cuda_device, case, dtype, g,
                                                 c, p):
    """The gradient against its plain version where thousands of points
    share a bucket (long buckets summed by segments), on a grid whose side
    is not a power of two (27), and at P = 60,000 (too many points a row
    to stage the bucketing's scatter in shared memory), with the
    tolerances of test_scene_pool_kernels_match_plain (f32 d_map sums up
    to ~3,000 points a node here); d_map and d_pos bitwise equal in two
    calls."""
    from desire_tpu_torch.ops import scene_pool
    make = _scene_pool_piles if case == "piles" else _scene_pool_case
    fm, pos, gct = make(cuda_device, 2, g, c, p, dtype)
    d_map, d_pos = scene_pool.scene_pool_bwd_cuda(fm, pos, gct)
    r_map, r_pos = scene_pool.bilinear_pool_plain_bwd(fm, pos, gct)
    np.testing.assert_allclose(d_map.float().cpu().numpy(),
                               r_map.float().cpu().numpy(),
                               rtol=1e-4 if dtype == "float32" else 2.0 ** -7,
                               atol=1e-4)
    np.testing.assert_allclose(d_pos.cpu().numpy(), r_pos.cpu().numpy(),
                               rtol=1e-4, atol=1e-3)
    outside = (pos < 0) | (pos > 1)
    assert float(d_pos[outside].abs().max()) == 0.0
    for _ in range(2):
        again = scene_pool.scene_pool_bwd_cuda(fm, pos, gct)
        assert torch.equal(again[0], d_map) and torch.equal(again[1], d_pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c", [("bfloat16", 32), ("bfloat16", 8),
                                     ("float32", 32), ("float32", 12)])
def test_scene_pool_forward_paths_give_the_same_bits(cuda_device, dtype, c):
    """The forward's vector path and its channel loop, asked for directly,
    agree bitwise with each other (the same four fused multiply-adds per
    channel, in corner order) and, in bf16, with the plain version."""
    import ctypes
    from desire_tpu_torch.ops import scene_pool
    fm, pos, _ = _scene_pool_case(cuda_device, 3, 32, c, 701, dtype)
    lib = _build.library()
    outs = []
    for want_vec in (True, False):
        out = torch.empty((3, 701, c), dtype=fm.dtype, device=cuda_device)
        vec = scene_pool.fwd_vector_width(c, fm.dtype, fm.data_ptr(),
                                          pos.data_ptr(), out.data_ptr())
        assert vec == (8 if dtype == "bfloat16" else 4)
        rc = lib.scene_pool_fwd_launch(
            int(dtype == "bfloat16"), fm.data_ptr(), pos.data_ptr(),
            out.data_ptr(), 3, 701, 32, c, vec if want_vec else 0,
            ctypes.c_void_p(torch.cuda.current_stream(
                cuda_device).cuda_stream))
        assert rc == 0
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    if dtype == "bfloat16":
        assert torch.equal(outs[0], scene_pool.bilinear_pool_plain(fm, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,p", [(2, 0), (0, 5)])
def test_scene_pool_forward_of_no_points(cuda_device, dtype, b, p):
    """B * P = 0: an empty result, no launch fault."""
    from desire_tpu_torch.ops import scene_pool
    cd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    out = scene_pool.scene_pool_fwd_cuda(
        torch.zeros((b, 8, 8, 32), dtype=cd, device=cuda_device),
        torch.zeros((b, p, 2), device=cuda_device))
    torch.cuda.synchronize()
    assert out.shape == (b, p, 32) and out.dtype == cd


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,t,offset", [
    (37, 7, 1, 0), (50, 13, 20, 0), (40, 5, 8, 0), (11, 3, 6, 0),
    (10, 9, 100, 0), (1, 1, 4, 0), (33, 20, 12, 1), (40, 1, 400, 0),
    (12, 20, 400, 0), (9, 5, 37, 0), (6, 3, 400, 3)])
def test_nll_forward_kernel_odd_shapes(cuda_device, n, k, t, offset):
    """The NLL forward's staging at shapes off the flagship's: K not a
    multiple of a block's 32 lanes (blocks straddle rows n), T = 1 and 6
    (rows read float by float), T = 20 (16-byte pieces), T = 8 (a row of
    10 pieces padded to 11), T = 100 and 400 (the steps staged in chunks of
    32, the last one partial; at K = 1 a block covers 33 rows n), T = 37
    (float by float in chunks), and raw5 not 16-byte aligned (offset:
    floats into its buffer)."""
    from desire_tpu_torch.ops import nll
    rng = np.random.default_rng(t)
    raw5 = rng.standard_normal((n, k, t, 5)) * 0.5
    tgt = rng.uniform(0.2, 0.8, (n, t, 2))
    raw5[..., :2] += tgt[:, None]
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                  device=cuda_device)
    buf = torch.zeros(raw5.size + offset, device=cuda_device)
    buf[offset:] = f(raw5).reshape(-1)
    r = buf[offset:].view(n, k, t, 5)
    tgt, mask = f(tgt), f(rng.random((n, t)) > 0.1)
    before = _build.LAUNCHES["nll_fwd"]
    got = nll.nll_fwd_cuda(r, tgt, mask)
    assert _build.LAUNCHES["nll_fwd"] == before + 1
    np.testing.assert_allclose(
        got.cpu().numpy(), nll.bivariate_nll_plain(r, tgt, mask).cpu().numpy(),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_short_eval_batch_through_serving_kernels(cuda_device):
    """A short last eval batch (B = 3 of a batch size of 8) through
    make_eval_step on the card (the sampler and IOC kernels) against the
    same step on the CPU (their plain versions), float32, the same noise:
    the best-of-K errors agree."""
    from desire_tpu_torch.eval.sampler import make_eval_step
    cfg = _cfg(batch_size=8)
    p = _params(cfg, "cpu")
    rng = np.random.default_rng(0)
    b, a, tt = 3, cfg.max_num_obj, cfg.total_len
    xy = (np.cumsum(rng.normal(0, 0.02, (b, tt, a, 2)), 1) + 0.5)
    mask = np.ones((b, tt, a))
    mask[:, :, -1] = 0.0
    ids = np.tile(np.arange(1, a + 1), (b, 1)) * (mask[:, 0] > 0)
    scale = np.array([300.0, 500.0, 800.0])
    eps = rng.standard_normal((b * a, cfg.num_samples, cfg.latent_size))
    step = make_eval_step(cfg, horizon_steps=(3.0,))
    res = {}
    for dev in ("cpu", cuda_device):
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        before = (_build.LAUNCHES["sgm_sample"], _build.LAUNCHES["ioc_refine"])
        res[str(dev)] = step(to_device(p, dev), f(xy), f(mask), f(ids),
                             f(scale), eps=f(eps))
    assert (_build.LAUNCHES["sgm_sample"], _build.LAUNCHES["ioc_refine"]) \
        == (before[0] + 1, before[1] + 1)
    card, cpu = res[str(cuda_device)], res["cpu"]
    np.testing.assert_array_equal(card["valid"], cpu["valid"])
    for name in ("ade", "fde", "sgm_ade", "sgm_fde", "speed"):
        # positions within 2e-4 relative, times scales of a few hundred px
        np.testing.assert_allclose(card[name], cpu[name], rtol=1e-3,
                                   atol=1e-2, err_msg=name)


@pytest.mark.cuda
def test_checkpoint_roundtrip_of_a_cuda_generator(cuda_device, tmp_path):
    """A CUDA training generator's state restores onto a CUDA generator
    (the same draws after the restore as after the save), with the params
    and Adam moments bit for bit; a CPU template refuses it."""
    from desire_tpu_torch.data.loader import LoaderState
    from desire_tpu_torch.train.checkpoint import CheckpointManager
    from desire_tpu_torch.train.state import create_train_state, tree_leaves
    cfg = _cfg()
    st = create_train_state(cfg, _params(cfg, cuda_device))
    st.mu = to_device(st.params, cuda_device)
    torch.randn(7, generator=st.generator, device=cuda_device)
    st.step, st.count = 3, 3
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(st, LoaderState(1, 2), cfg)
    want = torch.randn(5, generator=st.generator, device=cuda_device)
    tmpl = create_train_state(cfg, _params(cfg, cuda_device), seed=9)
    got, lst = mgr.restore(tmpl)
    assert got.generator.device.type == "cuda"
    assert torch.equal(torch.randn(5, generator=got.generator,
                                   device=cuda_device), want)
    for x, y in zip(tree_leaves(st.params) + tree_leaves(st.mu),
                    tree_leaves(got.params) + tree_leaves(got.mu)):
        assert y.is_cuda and torch.equal(x, y)
    assert (got.step, got.count, lst.epoch, lst.batch_index) == (3, 3, 1, 2)
    with pytest.raises(ValueError):
        mgr.restore(create_train_state(cfg, _params(cfg, "cpu")))


@pytest.mark.cuda
def test_sampler_and_rollout_through_serving_kernels(cuda_device):
    """make_sampler (stochastic) and a two-chunk make_rollout on the card
    (the sampler and IOC kernels) against the same on the CPU (their plain
    versions), float32, the same latent noise and draws."""
    from desire_tpu_torch.eval.sampler import make_rollout, make_sampler
    cfg = _cfg()
    p = _params(cfg, "cpu")
    rng = np.random.default_rng(3)
    b, a, to, k = 2, cfg.max_num_obj, cfg.obs_len, cfg.num_samples
    xy = np.cumsum(rng.normal(0, 0.02, (b, cfg.total_len, a, 2)), 1) + 0.5
    mask = np.ones((b, cfg.total_len, a))
    ids = np.tile(np.arange(1, a + 1), (b, 1))
    eps = rng.standard_normal((2, b * a, k, cfg.latent_size))
    draws = rng.standard_normal((2, b, a, k, cfg.pred_len))
    res, roll = {}, {}
    for dev in ("cpu", cuda_device):
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        pd = to_device(p, dev)
        res[str(dev)] = make_sampler(cfg, stochastic=True)(
            pd, f(xy), f(mask), f(ids), eps=f(eps[0]),
            draws=(f(draws[0]), f(draws[1])))
        roll[str(dev)] = make_rollout(cfg)(
            pd, f(xy[:, :to]).transpose(1, 2), f(mask[:, :to]).transpose(
                1, 2), f(ids), num_chunks=2, eps=[f(e) for e in eps])
    card, cpu = res[str(cuda_device)], res["cpu"]
    for name in ("traj", "best", "sgm_traj"):
        np.testing.assert_allclose(card[name].cpu().numpy(),
                                   cpu[name].numpy(), err_msg=name, **TOL)
    np.testing.assert_allclose(card["scores"].cpu().numpy(),
                               cpu["scores"].numpy(), **SCORE_TOL)
    np.testing.assert_allclose(roll[str(cuda_device)].cpu().numpy(),
                               roll["cpu"].numpy(), **TOL)


@pytest.mark.cuda
def test_predictor_with_a_raster_on_the_card(cuda_device):
    """A Predictor of an imagery model (scene_image_channels=1) on the card
    against the same on the CPU, with its raster and a per-call one."""
    from desire_tpu_torch.serve import Predictor
    cfg = _cfg(scene_image_channels=1)
    p = _params(cfg, "cpu")
    rng = np.random.default_rng(4)
    g = cfg.scene_grid
    imgs = rng.uniform(0, 1, (2, g, g, 1)).astype(np.float32)
    eps = rng.standard_normal((2 * cfg.max_num_obj, cfg.num_samples,
                               cfg.latent_size)).astype(np.float32)
    oxy = rng.uniform(20, 60, (3, cfg.obs_len, 2)).astype(np.float32)
    win = (oxy, np.ones((3, cfg.obs_len), np.float32), np.arange(1, 4))
    out = {}
    for dev in ("cpu", cuda_device):
        pred = Predictor(p, cfg, device=dev, max_windows=2,
                         scene_image=imgs[0])
        out[str(dev)] = [pred.predict(*win, scale=100.0, eps=eps,
                                      scene_image=si)
                         for si in (None, imgs[1])]
    for got, ref in zip(out[str(cuda_device)], out["cpu"]):
        np.testing.assert_allclose(got["traj"], ref["traj"], rtol=2e-4,
                                   atol=2e-3)
        np.testing.assert_allclose(got["scores"], ref["scores"],
                                   **SCORE_TOL)
    assert not np.allclose(out["cpu"][0]["scores"], out["cpu"][1]["scores"])


def _sharded_rank(rank, port, workdir):
    """A rank of test_sharded_kernels_two_ranks_on_one_card: the sharded
    sampler and IOC wrappers on its block of a (1, 2) and a (2, 1) mesh on
    cuda:0 (gloo), the blocks gathered, rank 0's written."""
    from desire_tpu_torch.parallel import mesh as mesh_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh_mod.init_multihost(f"localhost:{port}", 2, rank, "cuda", 120.0)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    cfg = _cfg()
    p = _params(cfg, "cuda")
    out = {}
    for shape in ((1, 2), (2, 1)):
        m = mesh_mod.make_mesh(*shape, device="cuda", timeout_s=120.0)
        s = [x.to(m.device) for x in inp["sampler"]]
        n, k = s[3].shape[:2]
        r = m.rows(n)
        dec_h, hx = sgm_fused.sgm_sample_decode_sharded(
            m, p["sgm"], *(x[r] for x in s), cfg.pred_len)
        i = [x.to(m.device) for x in inp["ioc"]]
        b = i[0].shape[0]
        rb, ln = m.rows(b), m.lanes(k)
        refined, scores = ioc_fused.ioc_refine_sharded(
            m, p["ioc"], p["scf"], i[0][rb][:, :, ln].contiguous(),
            i[1][rb][:, :, ln].contiguous(), *(x[rb] for x in i[2:]),
            num_refine=cfg.num_refine, delta_scale=_DELTA_SCALE)
        got = mesh_mod.assemble(m, [(dec_h, (n, k) + dec_h.shape[2:])], 1)
        got += mesh_mod.assemble(m, [(hx, (n,) + hx.shape[1:])])
        got += mesh_mod.assemble(
            m, [(refined, (b,) + refined.shape[1:2] + (k,)
                 + refined.shape[3:]),
                (scores, (b,) + scores.shape[1:2] + (k,))], 2)
        out[shape] = [x.cpu() for x in got]
    if rank == 0:
        torch.save(out, os.path.join(workdir, "out.pt"))
    mesh_mod.barrier(m)
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_sharded_kernels_two_ranks_on_one_card(cuda_device, tmp_path):
    """The sharded sampler and IOC wrappers, two ranks on one card joined by
    gloo, on (1, 2) and (2, 1) meshes: the gathered blocks against the
    unsharded kernels on the same inputs (float32)."""
    from test_torch_parallel import _free_port, spawn
    cfg = _cfg()
    p = _params(cfg, cuda_device)
    rng = np.random.default_rng(6)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    n, b, a, k, t = 8, 2, cfg.max_num_obj, 4, cfg.pred_len
    obs = np.ones((n, cfg.obs_len))
    obs[3, :2] = 0.0
    sampler = [f(np.abs(rng.standard_normal((n, cfg.obs_len,
                                             cfg.embedding_size)))),
               f(obs), f(np.abs(rng.standard_normal((n, cfg.d_dim)))),
               f(rng.standard_normal((n, k, cfg.latent_size)))]
    live = np.ones((b, a))
    live[:, -1] = 0.0
    ioc = [f(rng.uniform(0.2, 0.8, (b, a, k, t, 2))),
           f(np.tanh(rng.standard_normal((b, a, k, t, cfg.d_dim)))),
           f(rng.standard_normal((b, cfg.scene_grid, cfg.scene_grid,
                                  cfg.scene_channels))),
           f(live), f(np.ones((b, a, t)))]
    torch.save(dict(sampler=sampler, ioc=ioc), tmp_path / "inputs.pt")
    port = _free_port()
    spawn(__file__, lambda r: [str(r), str(port), str(tmp_path)], 2)
    dev = lambda xs: [x.to(cuda_device) for x in xs]
    ref = list(sgm_fused.sgm_sample_decode(p["sgm"], *dev(sampler),
                                           cfg.pred_len))
    ref += ioc_fused.ioc_refine(p["ioc"], p["scf"], *dev(ioc),
                                num_refine=cfg.num_refine,
                                delta_scale=_DELTA_SCALE)
    for shape, got in torch.load(tmp_path / "out.pt").items():
        for name, g, r in zip(("dec_h", "hx", "refined", "scores"), got,
                              ref):
            tol = SCORE_TOL if name == "scores" else TOL
            np.testing.assert_allclose(g.numpy(), r.cpu().numpy(),
                                       err_msg=f"{shape} {name}", **tol)


def _ioc_test_flat(mesh, p, inp, device):
    """tests/test_kernels.py:388's loss of the trainable IOC on ``inp``
    (float32): its value and its gradients (the IOC and message leaves,
    traj, dec_h, feat_map) as one array. mesh None: ``ioc_refine_train``
    on every lane; a mesh: ``ioc_refine_train_sharded`` on this rank's,
    the value and gradients summed over the mesh and divided by mk, as
    the training step reduces them."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.parallel import mesh as mesh_mod
    from desire_tpu_torch.train.state import tree_leaves, tree_unflatten
    trees = {"ioc": p["ioc"], "scf": {"soc_msg": p["scf"]["soc_msg"],
                                      "soc_logtau": p["scf"]["soc_logtau"]}}
    leaves = [x.detach().clone().requires_grad_(True)
              for x in tree_leaves(trees)]
    trees = tree_unflatten(trees, leaves)
    data = [x.to(device).requires_grad_(True) for x in inp["ioc"][:3]]
    args = (trees["ioc"], trees["scf"], *data,
            *(x.to(device) for x in inp["ioc"][3:]))
    kw = dict(num_refine=2, delta_scale=_DELTA_SCALE)
    if mesh is None:
        refined, scores, iters = ops.ioc_refine_train(*args, **kw)
    else:
        refined, scores, iters = ops.ioc_refine_train_sharded(mesh, *args,
                                                              **kw)
    value = ((refined ** 2).sum() + (scores * inp["wts"].to(device)).sum()
             + (iters ** 2).sum())
    grads = torch.autograd.grad(value, leaves + data)
    flat = torch.cat([value.detach().reshape(1)]
                     + [g.reshape(-1) for g in grads])
    if mesh is not None:
        flat = mesh_mod.all_sum(mesh, flat, axis=mesh_mod.MESH) / \
            mesh.shape[1]
    return flat.cpu()


def _lane_rank(rank, port, workdir):
    """A rank of test_lane_training_two_ranks_on_one_card: the trainable
    IOC on its half of the lanes of a (1, 2) mesh on cuda:0 (gloo)."""
    from desire_tpu_torch.parallel import mesh as mesh_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh_mod.init_multihost(f"localhost:{port}", 2, rank, "cuda", 120.0)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    m = mesh_mod.make_mesh(1, 2, device="cuda", timeout_s=120.0)
    flat = _ioc_test_flat(m, _params(_cfg(), m.device), inp, m.device)
    if rank == 0:
        torch.save(flat, os.path.join(workdir, "out.pt"))
    mesh_mod.barrier(m)
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_lane_training_two_ranks_on_one_card(cuda_device, tmp_path):
    """ioc_refine_train_sharded, two ranks on one card joined by gloo on a
    (1, 2) mesh, each launching the IOC training forward and backward
    kernels on 2 of the 4 lanes: the value and every gradient, reduced as
    the training step reduces them, against the unsharded kernel pair on
    the same inputs (float32; the weight gradients' block partials are
    summed in another grouping)."""
    from test_torch_parallel import _free_port, spawn
    cfg = _cfg()
    rng = np.random.default_rng(8)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    b, a, k, t = 2, cfg.max_num_obj, 4, cfg.pred_len
    live = np.ones((b, a))
    live[:, -1] = 0.0
    fut = np.ones((b, a, t))
    fut[0, 1, 3:] = 0.0
    inp = {"ioc": [f(rng.uniform(0.2, 0.8, (b, a, k, t, 2))),
                   f(np.tanh(rng.standard_normal((b, a, k, t, cfg.d_dim)))),
                   f(rng.standard_normal((b, cfg.scene_grid, cfg.scene_grid,
                                          cfg.scene_channels))),
                   f(live), f(fut)],
           "wts": f(rng.standard_normal((b, a, k)))}
    torch.save(inp, tmp_path / "inputs.pt")
    port = _free_port()
    spawn(__file__, lambda r: ["lanes", str(r), str(port), str(tmp_path)],
          2)
    got = torch.load(tmp_path / "out.pt").numpy()
    ref = _ioc_test_flat(None, _params(cfg, cuda_device), inp,
                         cuda_device).numpy()
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-4)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=2e-4,
                               atol=2e-5 * np.abs(ref[1:]).max())


@pytest.mark.cuda
def test_conv_decoder_on_the_card(cuda_device):
    """The deconv mask decoder (vae_dec='conv', side 32) on the card
    against the same function on the CPU, float32 (cuDNN's transposed
    convolutions and the CPU's, TF32 off)."""
    from desire_tpu_torch.models import sgm
    cfg = _cfg(rnn_size=512, vae_dec="conv", latent_size=16)
    p = sgm.init_sgm(torch.Generator().manual_seed(0), cfg, "cpu")
    z = torch.randn((64, cfg.latent_size),
                    generator=torch.Generator().manual_seed(1))
    ref = sgm.vae_decode_mask(p, z, cfg.vae_side)
    got = sgm.vae_decode_mask(to_device(p, cuda_device), z.to(cuda_device),
                              cfg.vae_side)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), **TOL)


# The optimizer kernels (csrc/adam.cu) against ops.adam's plain version on
# the same card. Neither side contracts a product and a sum into a fused
# multiply-add (the kernel rounds each operation as the plain version's
# separate launches do), so given the same norm the two agree bit for bit.
# The norms themselves differ by the order of their float32 sums (the
# kernel's fixed block partials against the plain version's leaf by leaf
# sums), a few ulps at 1.6 M values: NORM_RTOL. With its own norm the
# plain version differs through the clip's scale g / norm alone (a clipped
# step), which m and v carry relatively and the params, times lr, within a
# rounding step of their own size: ADAM_TOL (atol for m near zero, where
# (1 - b1) g and b1 m cancel).
NORM_RTOL = 1e-5
ADAM_TOL = dict(rtol=1e-5, atol=1e-7)


def _adam_trees(kind, dev, seed):
    """A leaf-list maker for (params, grads, mu, nu): "flagship" the
    flagship's 77 leaves; "ragged" leaves of 1, 3, 5, 4097 and 524,288
    values and three views of a flat buffer at offsets the tree ``role``
    shifts, so that some leaves take 16-byte accesses in neither kernel
    and some in the norm's alone."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if kind == "flagship":
        shapes = [x.shape for x in tree_leaves(init_desire(
            DesireConfig(), torch.Generator().manual_seed(0), "cpu"))]
        assert len(shapes) == 77

        def make(scale, role):
            return [scale * torch.randn(s, generator=gen, device=dev)
                    for s in shapes]
        return make

    def make(scale, role):
        fresh = [scale * torch.randn(n, generator=gen, device=dev)
                 for n in (1, 3, 5, 4097, 524288)]
        flat = scale * torch.randn(4500, generator=gen, device=dev)
        shift = 1 if role == "params" else 0
        views = [flat[o + shift:o + shift + n]
                 for o, n in ((0, 5), (8, 4097), (4106, 300))]
        views[1] = views[1].view(17, 241)
        return fresh + views
    return make


def _bits(xs):
    return [x.view(torch.int32).clone() for x in xs]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unclipped", "clipped", "nan_norm",
                                  "chained"])
@pytest.mark.parametrize("kind", ["flagship", "ragged"])
def test_optimizer_kernels_match_plain(cuda_device, kind, case):
    """global_norm and apply_updates through grad_sumsq and clip_adam
    against the plain norm and update: an unclipped step, a clipped one
    (norm >= grad_clip), a NaN norm (every output NaN, as optax's), and
    three chained steps (count-dependent bias correction; steps_per_epoch
    2 puts the staircase decay before the third). Each step launches one
    of each kernel, leaves its inputs as they were, and gives the same
    bits run twice."""
    from desire_tpu_torch.ops import adam
    from desire_tpu_torch.train import state as tstate
    cfg = DesireConfig()
    make = _adam_trees(kind, cuda_device, seed=7)
    params = make(1.0, "params")
    mu = make(1e-2, "mu")
    nu = [x.abs() for x in make(1e-4, "nu")]
    scales = {"unclipped": [1e-3], "clipped": [1.0], "nan_norm": [1e-3],
              "chained": [1e-3, 1.0, 3e-3]}[case]
    st = tstate.TrainState(step=0, params=params, mu=mu, nu=nu,
                           count=0 if case == "chained" else 5,
                           generator=None)
    for scale in scales:
        grads = make(scale, "grads")
        if case == "nan_norm":
            grads[3].view(-1)[2] = float("nan")
        ins = st.params + grads + st.mu + st.nu
        before = _bits(ins)
        launched = dict(_build.LAUNCHES)
        norm = tstate.global_norm(grads)
        p, m, v, count = tstate.apply_updates(cfg, 2, st, grads, g_norm=norm)
        assert (_build.LAUNCHES["grad_sumsq"], _build.LAUNCHES["clip_adam"]) \
            == (launched["grad_sumsq"] + 1, launched["clip_adam"] + 1)
        outs = p + m + v
        again = tstate.apply_updates(cfg, 2, st, grads,
                                     g_norm=tstate.global_norm(grads))
        assert all(torch.equal(a, b) for a, b in zip(
            _bits(outs), _bits(again[0] + again[1] + again[2])))
        assert all(torch.equal(a, b) for a, b in zip(before, _bits(ins)))
        plain_norm = adam.global_norm_plain(grads)
        lr = tstate.learning_rate(cfg, 2, st.count)
        bc1 = 1.0 - torch.tensor(tstate.B1, dtype=torch.float32) ** count
        bc2 = 1.0 - torch.tensor(tstate.B2, dtype=torch.float32) ** count
        args = (st.params, grads, st.mu, st.nu)
        if case == "nan_norm":
            assert torch.isnan(norm) and torch.isnan(plain_norm)
            assert all(torch.isnan(x).all() for x in outs)
        else:
            np.testing.assert_allclose(float(norm), float(plain_norm),
                                       rtol=NORM_RTOL)
            assert (float(norm) >= cfg.grad_clip) == (scale == 1.0)
            plain = adam.clip_adam_plain(*args, plain_norm, cfg.grad_clip,
                                         lr, bc1, bc2)
            for a, b in zip(outs, plain[0] + plain[1] + plain[2]):
                torch.testing.assert_close(a, b, **ADAM_TOL)
        same_norm = adam.clip_adam_plain(*args, norm, cfg.grad_clip, lr, bc1,
                                         bc2)
        for a, b in zip(outs, same_norm[0] + same_norm[1] + same_norm[2]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        st = tstate.TrainState(st.step + 1, p, m, v, count, None)


@pytest.mark.cuda
def test_train_step_launches_each_optimizer_kernel_once(cuda_device):
    """Every step_fn call on the card launches one grad_sumsq and one
    clip_adam, and its grad_norm is finite."""
    from desire_tpu_torch.train.state import create_train_state
    from desire_tpu_torch.train.trainer import make_train_step
    cfg = _cfg(batch_size=2)
    state = create_train_state(cfg, _params(cfg, cuda_device), seed=0)
    step_fn = make_train_step(cfg, steps_per_epoch=10)
    rng = np.random.default_rng(0)
    b, t, a = 2, cfg.total_len, cfg.max_num_obj
    xy = torch.as_tensor(rng.uniform(0.3, 0.7, (b, t, a, 2)).astype(
        np.float32), device=cuda_device)
    mask = torch.ones((b, t, a), device=cuda_device)
    ids = torch.arange(1, a + 1, device=cuda_device).float().repeat(b, 1)
    for _ in range(2):
        launched = dict(_build.LAUNCHES)
        state, metrics = step_fn(state, xy, mask, ids)
        assert (_build.LAUNCHES["grad_sumsq"], _build.LAUNCHES["clip_adam"]) \
            == (launched["grad_sumsq"] + 1, launched["clip_adam"] + 1)
        assert np.isfinite(float(metrics["grad_norm"]))


# the flagship's toy widths (as the benchmark's toy runs cut them) on an
# 8 x 8 x 8 scene map: the IOC backward kernel refuses the toy's 16 x 16 x
# 16 map at 8 agents (its feature-map staging outgrows the block's layout)
FLAGSHIP_TOY = dict(batch_size=4, max_num_obj=8, num_samples=4, d_dim=16,
                    latent_size=16, embedding_size=16, channel_multiplier=8,
                    scene_grid=8, scene_channels=8, compute_dtype="float32")


def _graphed_run(cfg, params, batches, noises, graphs, monkeypatch):
    """Three step_fn calls from one fresh state, the graphed loss allowed
    or not (``train.graphed.engages``). Returns (the final state, per step
    {metrics, the gradients handed to the optimizer, launches, IOC
    backward calls}, the step_fn)."""
    from desire_tpu_torch.ops import ioc_bwd
    from desire_tpu_torch.train import graphed, trainer
    from desire_tpu_torch.train.state import create_train_state
    seen = {"grads": None, "bwd": 0}
    apply, bwd = trainer.apply_updates, ioc_bwd.ioc_refine_bwd_cuda

    def recorded_apply(cfg_, spe, st, grads, **kw):
        # a copy: the graphed step's gradients are the graph's buffers
        seen["grads"] = [g.clone() for g in tree_leaves(grads)]
        return apply(cfg_, spe, st, grads, **kw)

    def counted_bwd(*a, **kw):
        seen["bwd"] += 1
        return bwd(*a, **kw)
    with monkeypatch.context() as m:
        m.setattr(trainer, "apply_updates", recorded_apply)
        m.setattr(ioc_bwd, "ioc_refine_bwd_cuda", counted_bwd)
        if not graphs:
            m.setattr(graphed, "engages", lambda *a, **kw: False)
        step_fn = trainer.make_train_step(cfg, steps_per_epoch=10)
        state = create_train_state(cfg, params, seed=0)
        steps = []
        for batch, noise in zip(batches, noises):
            launched, calls = dict(_build.LAUNCHES), seen["bwd"]
            state, metrics = step_fn(state, *batch, noise=noise)
            steps.append(dict(
                metrics=metrics, grads=seen["grads"], bwd=seen["bwd"] - calls,
                launches={k: _build.LAUNCHES[k] - v
                          for k, v in launched.items()}))
        torch.cuda.synchronize()
    return state, steps, step_fn


def _groups(state, steps):
    """Every number of a run in groups, each one flat vector: each step's
    metrics and its gradients, the final params and moments."""
    flat = lambda xs: torch.cat([x.reshape(-1).double() for x in xs])
    out = {}
    for i, st in enumerate(steps):
        out[f"step{i}.metrics"] = flat(st["metrics"][k]
                                       for k in sorted(st["metrics"]))
        out[f"step{i}.grads"] = flat(st["grads"])
    for name in ("params", "mu", "nu"):
        out[name] = flat(tree_leaves(getattr(state, name)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("widths", ["toy", "flagship"])
def test_graphed_step_matches_the_eager_step(cuda_device, widths,
                                             monkeypatch):
    """Three graphed steps against three eager ones from the same state,
    batches and draws: each step's metrics and gradients and the final
    params and moments bit for bit where three eager runs repeat them bit
    for bit, elsewhere within twice the eager runs' own largest difference
    (L2 over the group) of the eager run nearest; the launches and the IOC
    backward's calls (one) of each step as the eager step's; the steps'
    metrics distinct (run_epoch keeps them without a copy); a batch of
    another shape then runs eagerly and is counted so."""
    from desire_tpu_torch import bench
    from desire_tpu_torch.train import trainer
    from desire_tpu_torch.utils import telemetry
    cfg = bench.flagship_cfg().replace(social_freeze=False)
    if widths == "toy":
        cfg = cfg.replace(**FLAGSHIP_TOY)
    params = _params(cfg, cuda_device)
    b, t, a = cfg.batch_size, cfg.total_len, cfg.max_num_obj
    rng = np.random.default_rng(5)
    batches, noises = [], []
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    for _ in range(3):
        xy = rng.uniform(0.2, 0.8, (b, t, a, 2)) + 0.01 * np.arange(
            t)[None, :, None, None]
        ids = np.tile(np.arange(1, a + 1), (b, 1)).astype(np.float32)
        ids[rng.random((b, a)) < 0.1] = 0.0
        mask = np.ones((b, t, a), np.float32) * (ids[:, None] > 0)
        batches.append(tuple(torch.as_tensor(np.asarray(x, np.float32),
                                             device=cuda_device)
                             for x in (xy, mask, ids)))
        noises.append(trainer.step_noise(cfg, gen, (b, t, a, 2),
                                         cuda_device))
    eager = [_graphed_run(cfg, params, batches, noises, False, monkeypatch)
             for _ in range(3)]
    before = telemetry.tally()
    state, steps, step_fn = _graphed_run(cfg, params, batches, noises, True,
                                         monkeypatch)
    after = telemetry.tally()
    assert after["train.loss_graphed"] - before.get("train.loss_graphed",
                                                    0) == 3
    ref = [_groups(s, st) for s, st, _ in eager]
    got = _groups(state, steps)
    assert set(got) == set(ref[0])
    for name, x in got.items():
        spread = max(float((r1[name] - r2[name]).norm())
                     for i, r1 in enumerate(ref) for r2 in ref[i + 1:])
        off = min(float((x - r[name]).norm()) for r in ref)
        assert off <= 2 * spread, (name, off, spread)
    for i, st in enumerate(steps):
        assert st["bwd"] == 1 and eager[0][1][i]["bwd"] == 1
        assert st["launches"] == eager[0][1][i]["launches"], i
    losses = [st["metrics"]["loss"] for st in steps]
    assert len({float(x) for x in losses}) == 3
    # another batch shape: eager, counted as a call and not as a replay
    before = telemetry.tally()
    _, metrics = step_fn(state, *(x[:b - 1] for x in batches[0]))
    after = telemetry.tally()
    assert np.isfinite(float(metrics["loss"]))
    assert after["train.loss_calls"] - before["train.loss_calls"] == 1
    assert after["train.loss_graphed"] == before["train.loss_graphed"]


def _check_flat(st):
    """The state's params, mu and nu are views of one buffer each of its
    ``flat``, at the layout's starts; the three buffers are distinct."""
    flat = st.flat
    bufs = (flat.params, flat.mu, flat.nu)
    assert len({b.data_ptr() for b in bufs}) == 3
    for name, buf in zip(("params", "mu", "nu"), bufs):
        leaves = tree_leaves(getattr(st, name))
        assert buf.numel() == flat.layout.total
        assert [x.data_ptr() for x in leaves] == [
            buf.data_ptr() + 4 * s for s in flat.layout.starts], name
        assert all(x.untyped_storage().data_ptr()
                   == buf.untyped_storage().data_ptr() for x in leaves), name


@pytest.mark.cuda
def test_train_state_is_flat_on_the_card(cuda_device, tmp_path,
                                         monkeypatch):
    """After create_train_state, three steps and a checkpoint restore, the
    state's params, mu and nu are views of one buffer each, its values
    restored bit for bit; adam_layout is asked once for the tree's shape,
    not once a launch."""
    from desire_tpu_torch.data.loader import LoaderState
    from desire_tpu_torch.ops import adam
    from desire_tpu_torch.train.checkpoint import CheckpointManager
    from desire_tpu_torch.train.state import create_train_state
    from desire_tpu_torch.train.trainer import make_train_step
    lib = _build.library()
    asked = []
    real = lib.adam_layout

    def counted(*a):
        asked.append(a[0])
        return real(*a)
    monkeypatch.setattr(lib, "adam_layout", counted)
    adam.layout.cache_clear()
    try:
        cfg = _cfg(batch_size=2)
        state = create_train_state(cfg, _params(cfg, cuda_device), seed=0)
        _check_flat(state)
        step_fn = make_train_step(cfg, steps_per_epoch=10)
        rng = np.random.default_rng(0)
        b, t, a = 2, cfg.total_len, cfg.max_num_obj
        xy = torch.as_tensor(rng.uniform(0.3, 0.7, (b, t, a, 2)).astype(
            np.float32), device=cuda_device)
        mask = torch.ones((b, t, a), device=cuda_device)
        ids = torch.arange(1, a + 1, device=cuda_device).float().repeat(b, 1)
        for _ in range(3):
            state, _ = step_fn(state, xy, mask, ids)
            _check_flat(state)
        mgr = CheckpointManager(str(tmp_path / "ck"))
        assert mgr.save(state, LoaderState(0, 3), cfg)
        got, _ = mgr.restore(create_train_state(
            cfg, _params(cfg, cuda_device), seed=1))
        _check_flat(got)
        for name in ("params", "mu", "nu"):
            assert all(torch.equal(x, y) for x, y in zip(
                tree_leaves(getattr(state, name)),
                tree_leaves(getattr(got, name)))), name
        assert len(asked) == 1
    finally:
        adam.layout.cache_clear()


@pytest.mark.cuda
def test_graphed_step_copies_the_params_in_one_copy(cuda_device,
                                                     monkeypatch):
    """From its first step (the capture's warm-up and the step itself),
    the graphed loss copies the state's params into its static params in
    one copy of the state's flat buffer; its other copies are the batch
    and the draws."""
    from torch.overrides import TorchFunctionMode

    from desire_tpu_torch import bench
    from desire_tpu_torch.train import graphed, trainer
    from desire_tpu_torch.train.state import create_train_state
    from desire_tpu_torch.utils import telemetry
    cfg = bench.flagship_cfg().replace(social_freeze=False, **FLAGSHIP_TOY)
    calls = []

    class Copies(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.copy_:
                calls[-1][1].append(args)
            return func(*args, **(kwargs or {}))
    copy_in = graphed.GraphedLoss._copy_in

    def recorded(self, state, *a):
        calls.append((self, [], state))
        with Copies():
            return copy_in(self, state, *a)
    monkeypatch.setattr(graphed.GraphedLoss, "_copy_in", recorded)
    state = create_train_state(cfg, _params(cfg, cuda_device), seed=0)
    step_fn = trainer.make_train_step(cfg, steps_per_epoch=10)
    b, t, a = cfg.batch_size, cfg.total_len, cfg.max_num_obj
    rng = np.random.default_rng(2)
    xy = torch.as_tensor(rng.uniform(0.3, 0.7, (b, t, a, 2)).astype(
        np.float32), device=cuda_device)
    mask = torch.ones((b, t, a), device=cuda_device)
    ids = torch.arange(1, a + 1, device=cuda_device).float().repeat(b, 1)
    before = telemetry.tally()
    for _ in range(2):
        state, _ = step_fn(state, xy, mask, ids)
    after = telemetry.tally()
    assert after["train.loss_graphed"] - before.get("train.loss_graphed",
                                                    0) == 2
    # the first step's warm-up and forward, then the second step's forward
    assert len(calls) == 3
    for loss, copies, st in calls:
        params = [c for c in copies if c[0] is loss.flat]
        assert len(params) == 1 and params[0][1] is st.flat.params
        assert len(copies) == 1 + len(loss.inputs)


if __name__ == "__main__":
    if sys.argv[1] == "lanes":
        _lane_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        _sharded_rank(int(sys.argv[1]), sys.argv[2], sys.argv[3])
