"""Port parity of the inference SGM: the sampler's plain version against
the JAX Pallas sampler (interpret mode), and the port's sgm_forward against
the JAX sgm_forward, on the same parameters and latent noise (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desire_tpu.config import DesireConfig
from desire_tpu.models import layers as JL
from desire_tpu.models import sgm as jsgm
from desire_tpu.ops.sgm_fused import sgm_sample_decode_fused
from desire_tpu_torch.models import sgm as tsgm
from desire_tpu_torch.ops import sgm_fused as tops
from desire_tpu_torch.models.sgm import init_sgm
from desire_tpu_torch.params import from_jax, to_numpy

# the JAX kernel suite's f32 tolerance (tests/test_kernels.py)
TOL = dict(rtol=2e-4, atol=2e-5)


def _cfg(input_norm, **kw):
    return DesireConfig(obs_len=5, pred_len=6, num_samples=4, d_dim=16,
                        latent_size=8, embedding_size=8,
                        channel_multiplier=10, compute_dtype="float32",
                        rnn_size=128, input_norm=input_norm, **kw)


def _env(input_norm, **kw):
    """Config, JAX params (prior and temperature heads made non-zero),
    odd-N observations with one masked step, and the forward's PRNG key.
    The params are drawn by the port's init, whose tree is the JAX init's
    (tests/test_torch_params.py), which is much quicker on the CPU than
    JAX's op-by-op init."""
    cfg = _cfg(input_norm, **kw)
    p = to_numpy(init_sgm(torch.Generator().manual_seed(0), cfg, "cpu"))
    rng = np.random.default_rng(1)
    for name in ("prior", "ztemp_fc2"):
        p[name]["w"] = 0.3 * rng.standard_normal(p[name]["w"].shape)
    p = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), p)
    n = 7
    obs = jnp.asarray(rng.uniform(size=(n, cfg.obs_len, 2)) * 0.5 + 0.2,
                      jnp.float32)
    m_o = jnp.ones((n, cfg.obs_len)).at[0, 0].set(0.0)
    return cfg, p, obs, m_o, jax.random.PRNGKey(5)


def _eps(cfg, key, n):
    """The latent draw of JAX sgm_forward(train=False)."""
    return jax.random.normal(jax.random.split(key, 3)[0],
                             (n, cfg.num_samples, cfg.latent_size))


@pytest.mark.parametrize("input_norm", [False, True])
def test_sampler_plain_matches_pallas_interpret(input_norm):
    cfg, p, obs, m_o, key = _env(input_norm)
    n = obs.shape[0]
    origin = obs[:, -1]
    rel = (obs - origin[:, None]) * m_o[..., None]
    enc_rel, extra = rel, None
    if input_norm:
        s_obs = jsgm.observed_speed(rel, m_o)
        enc_rel = rel * (1.0 / (s_obs + cfg.vel_floor))[:, None]
        extra = jnp.log1p(s_obs / cfg.vel_floor)
    feats = jax.nn.relu(JL.dense(p["embed_x"],
                                 jsgm._traj_feats(enc_rel, m_o, extra=extra)))
    rho_seed = jax.nn.relu(JL.dense(p["rho_proj"],
                                    jsgm.temporal_features(p, enc_rel, m_o)))
    eps = _eps(cfg, key, n)
    ref_h, ref_hx = sgm_sample_decode_fused(
        p, feats, m_o, rho_seed, eps, cfg.pred_len, block_rows=8,
        interpret=True)
    t = lambda x: torch.from_numpy(np.array(x, np.float32))
    got_h, got_hx = tops.sgm_sample_decode_plain(
        from_jax(p), t(feats), t(m_o), t(rho_seed), t(eps), cfg.pred_len)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(got_hx.numpy(), np.asarray(ref_hx), **TOL)


@pytest.mark.parametrize("input_norm,use_pallas", [
    (False, True), (True, True), (True, False)])
def test_sgm_forward_matches_jax(input_norm, use_pallas):
    """use_pallas=True takes the port's fused-sampler path (its plain
    version on the CPU); False the layer-by-layer path. JAX on the CPU
    runs its XLA path either way."""
    cfg, p, obs, m_o, key = _env(input_norm, use_pallas=use_pallas)
    ref = jsgm.sgm_forward(p, cfg, obs, m_o, key=key, train=False)
    t = lambda x: torch.from_numpy(np.array(x, np.float32))
    got = tsgm.sgm_forward(from_jax(p), cfg, t(obs), t(m_o),
                           eps=t(_eps(cfg, key, obs.shape[0])))
    for name in ("raw5", "dec_h", "hx", "zp_mu", "zp_logvar", "rho"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   err_msg=name, **TOL)
