"""The port's parameter trees and package boundary: conversion from and to
the JAX trees, the port's own init against the JAX init's structure, no
JAX in the port's imports, and device dispatch of the kernel ops."""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desire_tpu.config import DesireConfig
from desire_tpu.models.desire import init_desire as jax_init_desire
from desire_tpu_torch import ops
from desire_tpu_torch.ops import ioc_fused, sgm_fused
from desire_tpu_torch.params import from_jax, init_desire, to_numpy

TINY = dict(obs_len=4, pred_len=3, num_samples=3, d_dim=16, latent_size=8,
            embedding_size=8, channel_multiplier=10, scene_grid=8,
            scene_channels=4, num_refine=2, compute_dtype="float32",
            max_num_obj=4, batch_size=2)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def test_from_jax_to_numpy_round_trip():
    """JAX arrays in the JAX init's tree (its shapes and dtypes, random
    values from numpy: JAX's op-by-op init is slow on the CPU)."""
    cfg = DesireConfig(rnn_size=128, **TINY)
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype),
        jax.eval_shape(lambda k: jax_init_desire(k, cfg),
                       jax.random.PRNGKey(0)))
    tp = from_jax(jp)
    back = to_numpy(tp)
    ref, got = _leaves(jax.tree_util.tree_map(np.asarray, jp)), _leaves(back)
    assert ref.keys() == got.keys()
    for k in ref:
        assert isinstance(_leaves(tp)[k], torch.Tensor)
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("variant", [
    dict(rnn_size=128), dict(), dict(rnn_size=128, vae_dec="conv"),
    dict(vae_dec="conv"), dict(aniso_bound=True, pace_range=0.3),
    dict(rnn_size=128, cond_prior=False, z_temp_learn=False,
         learn_bound=False, input_norm=False),
    dict(rnn_size=128, num_layers=2, use_ioc=False),
    dict(rnn_size=128, scene_image_channels=3)])
def test_init_desire_matches_jax_structure(variant):
    cfg = DesireConfig(**{**TINY, **variant})
    ref = _leaves(jax.eval_shape(
        lambda k: jax_init_desire(k, cfg), jax.random.PRNGKey(0)))
    got = _leaves(init_desire(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert ref.keys() == got.keys()
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        assert got[k].dtype == torch.float32, k


def test_port_imports_no_jax():
    """A CPU forward through the port leaves JAX and the JAX package out of
    the process: the port keeps its own DesireConfig."""
    code = textwrap.dedent("""
        import sys, torch
        from desire_tpu_torch import DesireConfig
        from desire_tpu_torch.models.desire import desire_forward
        from desire_tpu_torch.params import init_desire
        from desire_tpu_torch import serve
        cfg = DesireConfig(obs_len=4, pred_len=3, num_samples=3, d_dim=16,
                           latent_size=8, embedding_size=8,
                           channel_multiplier=10, scene_grid=8,
                           scene_channels=4, num_refine=2, rnn_size=128,
                           compute_dtype="float32", max_num_obj=4)
        p = init_desire(cfg, torch.Generator().manual_seed(0), "cpu")
        xy = torch.rand(2, 7, 4, 2)
        out = desire_forward(p, cfg, xy, torch.ones(2, 7, 4),
                             torch.ones(2, 4),
                             generator=torch.Generator().manual_seed(1))
        assert torch.isfinite(out["refined_traj"]).all()
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "desire_tpu" or m.startswith("desire_tpu."))
        print("BAD", bad)
        assert not bad, bad
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout


def test_cpu_dispatch_takes_plain_versions():
    cfg = DesireConfig(rnn_size=128, **TINY)
    p = init_desire(cfg, torch.Generator().manual_seed(0), "cpu")
    from desire_tpu_torch.models.desire import desire_forward
    ops.reset_launch_counts()
    out = desire_forward(p, cfg, torch.rand(2, 7, 4, 2), torch.ones(2, 7, 4),
                         torch.ones(2, 4),
                         generator=torch.Generator().manual_seed(1))
    assert out["scores"].shape == (2, 4, 3)
    assert {"sgm_sample", "ioc_refine"} <= set(ops.LAUNCHES)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


def test_kernel_wrappers_refuse_cpu_tensors():
    cfg = DesireConfig(rnn_size=128, **TINY)
    p = init_desire(cfg, torch.Generator().manual_seed(0), "cpu")
    n, k, t = 3, 3, 3
    f32 = torch.float32
    with pytest.raises(ValueError, match="CUDA"):
        sgm_fused.sgm_sample_decode_cuda(
            ops.pack_sampler(p["sgm"], f32, "cpu"), torch.zeros(n, 4, 8),
            torch.ones(n, 4), torch.zeros(n, 16), torch.zeros(n, k, 8), t)
    with pytest.raises(ValueError, match="CUDA"):
        ioc_fused.ioc_refine_cuda(
            ops.pack_ioc(p["ioc"], p["scf"], f32, "cpu", 4),
            torch.zeros(1, 4, k, t, 2), torch.zeros(1, 4, k, t, 16),
            torch.zeros(1, 8, 8, 4), torch.ones(1, 4), torch.ones(1, 4, t),
            num_refine=2, delta_scale=0.1)
    from desire_tpu_torch.ops import ioc_bwd, nll
    raw5, tgt, m = torch.zeros(n, k, t, 5), torch.zeros(n, t, 2), \
        torch.ones(n, t)
    with pytest.raises(ValueError, match="CUDA"):
        nll.nll_fwd_cuda(raw5, tgt, m)
    with pytest.raises(ValueError, match="CUDA"):
        nll.nll_bwd_cuda(raw5, tgt, m, torch.ones(n, k))
    z = torch.zeros(1, 4, k, t, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ioc_bwd.ioc_refine_bwd_cuda(
            p["ioc"], p["scf"], z, torch.zeros(1, 4, k, t, 16),
            torch.zeros(1, 4, k, t, 16), torch.zeros(1, 8, 8, 4),
            torch.ones(1, 4), torch.ones(1, 4, t), z[None].repeat(2, 1, 1, 1,
                                                               1, 1),
            z, torch.zeros(1, 4, k), z[None].repeat(2, 1, 1, 1, 1, 1),
            num_refine=2, delta_scale=0.1)
    assert {"sgm_sample", "ioc_refine", "ioc_refine_train", "ioc_refine_bwd",
            "nll_fwd", "nll_bwd"} <= set(ops.LAUNCHES)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


@pytest.mark.parametrize("dtype,agents,mma", [
    (torch.float32, 4, False), (torch.bfloat16, 4, True),
    (torch.bfloat16, 65, True), (torch.bfloat16, 128, True)])
def test_kernel_weight_packs(dtype, agents, mma):
    """The packs hold the kernels' layouts: the tensor-core path (bf16,
    widths multiples of 16, at most 128 agents for IOC) takes its matrices
    transposed, (out, in), and the IOC heads padded to 8 columns; all else
    takes them (in, out). The Predictor packs only for CUDA."""
    cfg = DesireConfig(**{**TINY, "d_dim": 16, "latent_size": 16,
                          "scene_channels": 16, "rnn_size": 128})
    p = init_desire(cfg, torch.Generator().manual_seed(0), "cpu")
    sw = ops.pack_sampler(p["sgm"], dtype, "cpu")
    iw = ops.pack_ioc(p["ioc"], p["scf"], dtype, "cpu", agents)
    assert sw.use_mma == (dtype == torch.bfloat16)
    assert iw.use_mma == mma
    assert (sw.emb, sw.d, sw.lat) == (8, 16, 16)
    assert (iw.d, iw.c, iw.max_agents) == (16, 16, agents)
    w1 = p["sgm"]["vdec_fc1"]["w"]
    assert torch.equal(sw.tensors[6].float(),
                       (w1.t() if sw.use_mma else w1).to(dtype).float())
    heads = iw.tensors[5]
    assert tuple(heads.shape) == ((8, 16) if mma else (16, 4))
    assert all(t.is_contiguous() for t in sw.tensors + iw.tensors)
    from desire_tpu_torch.serve import Predictor
    assert Predictor(p, cfg, device="cpu").kernel_weights == {}


@pytest.mark.parametrize("d,mma", [(64, True), (80, False)])
def test_kernel_weight_packs_tensor_core_widths(d, mma):
    """bf16 packs take the kernels' tensor-core paths only up to d = 64 (the
    widths their register tiles are built for); d = 80 keeps the (in, out)
    layouts of the CUDA-core paths."""
    cfg = DesireConfig(**{**TINY, "d_dim": d, "latent_size": 16,
                          "scene_channels": 16, "rnn_size": 128})
    p = init_desire(cfg, torch.Generator().manual_seed(0), "cpu")
    sw = ops.pack_sampler(p["sgm"], torch.bfloat16, "cpu")
    iw = ops.pack_ioc(p["ioc"], p["scf"], torch.bfloat16, "cpu", 8)
    assert sw.use_mma == mma and iw.use_mma == mma
    w1 = p["sgm"]["vdec_fc1"]["w"]
    assert torch.equal(sw.tensors[6], (w1.t() if mma else w1).to(
        torch.bfloat16).contiguous())
    assert tuple(iw.tensors[5].shape) == ((8, d) if mma else (d, 4))


def test_predictor_cuda_without_card_raises(monkeypatch):
    from desire_tpu_torch.serve import Predictor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DesireConfig(rnn_size=128, **TINY)
    p = init_desire(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(p, cfg, device="cuda")
