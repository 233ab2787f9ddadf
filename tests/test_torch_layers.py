"""Port parity: desire_tpu_torch.models.layers against
desire_tpu.models.layers on the same numpy inputs and parameters (f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desire_tpu.models import layers as JL
from desire_tpu_torch.models import layers as TL

# the JAX kernel suite's f32 tolerance for hiddens and positions
TOL = dict(rtol=2e-4, atol=2e-5)


def _gru(rng, in_dim, hidden):
    s = 1.0 / np.sqrt(hidden)
    return {"wi": rng.uniform(-s, s, (in_dim, 3 * hidden)),
            "wh": rng.uniform(-s, s, (hidden, 3 * hidden)),
            "bi": rng.uniform(-s, s, (3 * hidden,)),
            "bh": rng.uniform(-s, s, (3 * hidden,))}


def _case(name, rng):
    """(jax fn, torch fn, args as numpy) of one layer."""
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    if name == "dense":
        p = {"w": f(6, 5), "b": f(5)}
        return (JL.dense, TL.dense, (p, f(3, 4, 6)))
    if name == "gru_scan_masked":
        p = _gru(rng, 6, 5)
        mask = (rng.random((7, 3)) > 0.3).astype(np.float32)
        return (lambda p, h, x, m: JL.gru_scan(p, h, x, mask=m),
                lambda p, h, x, m: TL.gru_scan(p, h, x, mask=m),
                (p, f(3, 5), f(7, 3, 6), mask))
    if name == "gru_scan_const_x":
        p = _gru(rng, 6, 5)
        return (lambda p, h, x: JL.gru_scan_const_x(p, h, x, 4),
                lambda p, h, x: TL.gru_scan_const_x(p, h, x, 4),
                (p, f(3, 5), f(3, 6)))
    if name == "gru_stack_scan":
        stack = [_gru(rng, 6, 5), _gru(rng, 5, 5)]
        mask = (rng.random((7, 3)) > 0.3).astype(np.float32)
        return (lambda s, h, x, m: JL.gru_stack_scan(s, h, x, mask=m),
                lambda s, h, x, m: TL.gru_stack_scan(s, h, x, mask=m),
                (stack, f(2, 3, 5), f(7, 3, 6), mask))
    if name == "conv2d_same":
        p = {"w": f(3, 3, 2, 4), "b": f(4)}
        return (JL.conv2d, TL.conv2d, (p, f(2, 8, 8, 2)))
    if name == "groupnorm":
        p = {"scale": f(16), "bias": f(16)}
        return (JL.groupnorm, TL.groupnorm, (p, f(2, 8, 8, 16) * 3 + 1))
    raise KeyError(name)


def _to(tree, conv):
    if isinstance(tree, dict):
        return {k: _to(v, conv) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, conv) for v in tree]
    return conv(np.asarray(tree, np.float32))


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [np.asarray(o) for o in out]
    return [np.asarray(out)]


@pytest.mark.parametrize("name", ["dense", "gru_scan_masked",
                                  "gru_scan_const_x", "gru_stack_scan",
                                  "conv2d_same", "groupnorm"])
def test_layer_matches_jax(name):
    jfn, tfn, args = _case(name, np.random.default_rng(0))
    ref = jfn(*[_to(a, jnp.asarray) for a in args])
    got = tfn(*[_to(a, torch.from_numpy) for a in args])
    ref, got = _flat(ref), [g.numpy() for g in (
        got if isinstance(got, (tuple, list)) else [got])]
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert r.shape == g.shape
        np.testing.assert_allclose(g, r, **TOL)
