"""Port parity of the training losses (models/losses.py) and of the fused
NLL op's plain version (ops/nll.py), values and gradients, against the JAX
package on the CPU (f32). The CUDA NLL kernels are held against the plain
version in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desire_tpu.models import losses as jl
from desire_tpu.ops.nll import bivariate_nll_pallas
from desire_tpu_torch.models import losses as tl
from desire_tpu_torch.ops import nll as tnll

# f32, the same formulas term by term: only the order of sums and the
# libm of exp/log/tanh differ
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _raw(rng, shape, far_every=None):
    """Gaussian heads (..., 5) near targets (..., 2); every far_every-th
    row far off target with tiny sigmas, where the log-density floor is
    active."""
    tgt = rng.uniform(0.2, 0.8, shape + (2,)).astype(np.float32)
    raw = (rng.standard_normal(shape + (5,)) * 0.7).astype(np.float32)
    raw[..., :2] += tgt
    if far_every:
        raw[::far_every, ..., :2] = tgt[::far_every] + 5.0
        raw[::far_every, ..., 2:4] = -8.0
    return raw, tgt


def _parity(jfn, tfn, *arrays, wrt=(0,)):
    """Value of fn(*arrays) and the gradient of sum(fn * w) w.r.t. the
    arguments in wrt, JAX against the port."""
    ref = jfn(*map(jnp.asarray, arrays))
    targs = [torch.tensor(a, requires_grad=i in wrt)
             for i, a in enumerate(arrays)]
    got = tfn(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    w = np.random.default_rng(9).standard_normal(np.shape(ref)).astype(
        np.float32)
    g_ref = jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=wrt)(
        *map(jnp.asarray, arrays))
    g_got = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                [targs[i] for i in wrt], allow_unused=True)
    for gr, gg, i in zip(g_ref, g_got, wrt):
        # a detached argument (a stop-gradient in JAX) gets no gradient
        gg = np.zeros(arrays[i].shape, np.float32) if gg is None else gg
        np.testing.assert_allclose(np.asarray(gg), np.asarray(gr),
                                   **GRAD_TOL)


def test_get_coef_and_log_pdf():
    rng = np.random.default_rng(0)
    raw, tgt = _raw(rng, (4, 6))
    raw[0, :, 2:4] = 9.0                    # clamped log sigma
    for i in range(5):
        _parity(lambda r: jl.get_coef(r)[i], lambda r: tl.get_coef(r)[i],
                raw)
    _parity(lambda r, t: jl.bivariate_gaussian_log_pdf(
                t[..., 0], t[..., 1], *jl.get_coef(r)),
            lambda r, t: tl.bivariate_gaussian_log_pdf(
                t[..., 0], t[..., 1], *tl.get_coef(r)), raw, tgt,
            wrt=(0, 1))


@pytest.mark.parametrize("floor,masked", [(True, True), (True, False),
                                          (False, True)])
def test_bivariate_nll(floor, masked):
    rng = np.random.default_rng(1)
    raw, tgt = _raw(rng, (6, 5), far_every=3 if floor else None)
    m = (rng.random((6, 5)) > 0.3).astype(np.float32)
    if masked:
        _parity(lambda r, t, mm: jl.bivariate_nll(r, t, step_mask=mm,
                                                  floor=floor),
                lambda r, t, mm: tl.bivariate_nll(r, t, step_mask=mm,
                                                  floor=floor), raw, tgt, m)
    else:
        _parity(lambda r, t: jl.bivariate_nll(r, t, floor=floor),
                lambda r, t: tl.bivariate_nll(r, t, floor=floor), raw, tgt)


@pytest.mark.parametrize("free_bits", [0.0, 0.05])
def test_kld(free_bits):
    rng = np.random.default_rng(2)
    mq, lq, mp, lp = (rng.standard_normal((5, 8)).astype(np.float32) * 0.5
                      for _ in range(4))
    _parity(lambda m, l: jl.kld_normal(m, l, free_bits=free_bits),
            lambda m, l: tl.kld_normal(m, l, free_bits=free_bits), mq, lq,
            wrt=(0, 1))
    _parity(lambda *a: jl.kld_gaussians(*a, free_bits=free_bits),
            lambda *a: tl.kld_gaussians(*a, free_bits=free_bits),
            mq, lq, mp, lp, wrt=(0, 1, 2, 3))


def test_masked_mean():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((3, 4)).astype(np.float32)
    m = (rng.random((3, 4)) > 0.5).astype(np.float32)
    _parity(jl.masked_mean, tl.masked_mean, v, m)
    _parity(jl.masked_mean, tl.masked_mean, v, np.zeros_like(m))


@pytest.mark.parametrize("standardize,stepped", [(True, True),
                                                 (False, False)])
def test_ioc_cross_entropy(standardize, stepped):
    """Gradients reach the scores only: the distance target is detached."""
    rng = np.random.default_rng(4)
    b, a, k, t = 2, 3, 5, 4
    scores = rng.standard_normal((b, a, k)).astype(np.float32)
    hyp = rng.uniform(0, 1, (b, a, k, t, 2)).astype(np.float32)
    gt = rng.uniform(0, 1, (b, a, t, 2)).astype(np.float32)
    live = np.array([[1, 1, 0], [1, 0.5, 1]], np.float32)
    sm = (rng.random((b, a, t)) > 0.2).astype(np.float32)
    kw = dict(temperature=0.5, standardize=standardize)
    if stepped:
        _parity(lambda s, h, g, l, m: jl.ioc_cross_entropy(
                    s, h, g, l, step_mask=m, **kw),
                lambda s, h, g, l, m: tl.ioc_cross_entropy(
                    s, h, g, l, step_mask=m, **kw),
                scores, hyp, gt, live, sm, wrt=(0, 1))
    else:
        _parity(lambda s, h, g, l: jl.ioc_cross_entropy(s, h, g, l, **kw),
                lambda s, h, g, l: tl.ioc_cross_entropy(s, h, g, l, **kw),
                scores, hyp, gt, live, wrt=(0, 1))


@pytest.mark.parametrize("agg,penalty", [("min", True), ("min", False),
                                         ("mean", False)])
def test_refine_regression_loss(agg, penalty):
    rng = np.random.default_rng(5)
    b, a, k, t = 2, 3, 4, 5
    ref = rng.uniform(0, 1, (b, a, k, t, 2)).astype(np.float32)
    gt = rng.uniform(0, 1, (b, a, t, 2)).astype(np.float32)
    live = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    sm = (rng.random((b, a, t)) > 0.2).astype(np.float32)
    pen = np.where(rng.random((b, a, k)) > 0.5, 0.0, 1e9).astype(np.float32)
    pen[..., 0] = 0.0
    if penalty:
        _parity(lambda r, g, l, m, p: jl.refine_regression_loss(
                    r, g, l, step_mask=m, agg=agg, lane_penalty=p),
                lambda r, g, l, m, p: tl.refine_regression_loss(
                    r, g, l, step_mask=m, agg=agg, lane_penalty=p),
                ref, gt, live, sm, pen)
    else:
        _parity(lambda r, g, l, m: jl.refine_regression_loss(
                    r, g, l, step_mask=m, agg=agg),
                lambda r, g, l, m: tl.refine_regression_loss(
                    r, g, l, step_mask=m, agg=agg), ref, gt, live, sm)


@pytest.mark.parametrize("n,k,t", [(7, 3, 4), (20, 5, 12)])
def test_nll_op_plain_matches_pallas_interpret(n, k, t):
    """The NLL op's plain version against the Pallas kernels (interpret
    mode) and their custom VJP, with floor-active rows (zero gradient)."""
    rng = np.random.default_rng(6)
    raw, tgt = _raw(rng, (n, k, t), far_every=4)
    tgt = tgt[:, 0]                                   # (N, T, 2)
    raw[:, :, :, :2] = raw[:, :, :, :2] - raw[:, :1, :, :2] + tgt[:, None]
    raw[::4, :, :, :2] = tgt[::4, None] + 5.0
    m = (rng.random((n, t)) > 0.2).astype(np.float32)
    ref = bivariate_nll_pallas(jnp.asarray(raw), jnp.asarray(tgt),
                               jnp.asarray(m), True)
    r = torch.tensor(raw, requires_grad=True)
    got = tnll.bivariate_nll_sum(r, torch.from_numpy(tgt),
                                 torch.from_numpy(m))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **TOL)
    assert float(got.detach()[::4].min()) > 46.0              # the floor is active
    g = rng.standard_normal((n, k)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: bivariate_nll_pallas(
        x, jnp.asarray(tgt), jnp.asarray(m), True), jnp.asarray(raw))
    g_ref, = vjp(jnp.asarray(g))
    g_got, = torch.autograd.grad((got * torch.from_numpy(g)).sum(), [r])
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_ref), **GRAD_TOL)
    assert float(g_got[::4].abs().max()) == 0.0
