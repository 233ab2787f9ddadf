"""The port's headline bench (``python -m desire_tpu_torch.bench``) on the
CPU at toy shapes: its configurations against the repository's
``bench.py`` (loaded from its path, unedited), its measurements and its
line's keys, and the FLOP count its MFU rests on."""

import ast
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from desire_tpu_torch import bench
from desire_tpu_torch.config import DesireConfig
from desire_tpu_torch.models.desire import desire_forward

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(ROOT, "bench.py")

_TOY = dict(batch_size=2, max_num_obj=5, obs_len=4, pred_len=4,
            num_samples=3, d_dim=16, latent_size=8, embedding_size=8,
            channel_multiplier=10, scene_grid=8, scene_channels=4,
            num_refine=2, compute_dtype="float32")
# the keys of bench.py's line that the port leaves out (TPU/XLA tooling)
_NOT_PORTED = ("hbm_", "mfu_ref_geom_", "cost_model")
_PORT_KEYS = {"fwd_ms_p90", "train_busy_ms", "train_peak_gib", "device"}


def _toy(**kw):
    return DesireConfig(**dict(_TOY, **kw))


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", BENCH_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _function(name):
    tree = ast.parse(open(BENCH_PY).read())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _jax_variants():
    """bench.py breakdown's (name, overrides) list, read from its source."""
    for node in ast.walk(_function("breakdown")):
        if isinstance(node, ast.Assign) and node.targets[0].id == "variants":
            return eval(compile(ast.Expression(node.value), BENCH_PY,
                                "eval"), {"dict": dict})
    raise AssertionError("no variants list in bench.py breakdown")


def _jax_line_keys():
    """The keys bench.py main puts on its line (its rec dict)."""
    keys = set()
    for node in ast.walk(_function("main")):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and node.targets[0].id == "rec":
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Assign) \
                and isinstance(node.targets[0], ast.Subscript) \
                and node.targets[0].value.id == "rec":
            keys.add(node.targets[0].slice.value)
    return keys


@pytest.mark.parametrize("freeze", [None, "1"])
def test_flagship_cfg_matches_bench_py(freeze, monkeypatch):
    if freeze is None:
        monkeypatch.delenv("DESIRE_SOCIAL_FREEZE", raising=False)
    else:
        monkeypatch.setenv("DESIRE_SOCIAL_FREEZE", freeze)
    jb = _jax_bench()
    for k in (20, 50):
        assert bench.flagship_cfg(K=k).to_json() \
            == jb.flagship_cfg(K=k).to_json()
    assert bench.flagship_cfg().social_freeze == (freeze == "1")


def test_breakdown_variants_match_bench_py():
    jb = _jax_bench()
    want = [(name, jb.flagship_cfg().replace(**kw).to_json())
            for name, kw in _jax_variants()]
    got = [(name, cfg.to_json()) for name, cfg in bench.variant_cfgs()]
    assert len(got) == 6 and got == want


def test_make_batch():
    cfg = _toy()
    xy, mask, ids = bench.make_batch(cfg, seed=3, device="cpu")
    b, a, t = cfg.batch_size, cfg.max_num_obj, cfg.total_len
    assert xy.shape == (b, t, a, 2) and xy.dtype == torch.float32
    assert float(xy.min()) >= 0.2 and float(xy.max()) <= 0.8
    assert bool((mask == 1).all()) and mask.shape == (b, t, a)
    assert ids.tolist() == [list(range(1, a + 1))] * b
    assert torch.equal(xy, bench.make_batch(cfg, seed=3, device="cpu")[0])
    assert not torch.equal(xy, bench.make_batch(cfg, seed=4,
                                                device="cpu")[0])


@pytest.mark.parametrize("train", [False, True])
def test_model_flops_counts_the_plain_path(train):
    """model_flops is FlopCounterMode's total of the use_pallas=False
    forward (or step), whatever cfg.use_pallas says; a step counts its
    backward too."""
    cfg = _toy()
    count = bench.model_flops(cfg, train, "cpu")
    assert count == bench.model_flops(cfg.replace(use_pallas=False), train,
                                      "cpu")
    if train:
        assert count > 2 * bench.model_flops(cfg, False, "cpu")
        return
    plain = cfg.replace(use_pallas=False)
    params = bench.init_params(plain, "cpu")
    xy, mask, ids = bench.make_batch(plain, device="cpu")
    with FlopCounterMode(display=False) as counter:
        desire_forward(params, plain, xy, mask, ids,
                       generator=torch.Generator().manual_seed(0))
    assert count == counter.get_total_flops() > 0


def _jax_flops(jaxpr, once=False, mult=1, out=None):
    """{"dot", "conv"}: the FLOPs of a jaxpr's dot_general and
    conv_general_dilated equations, 2 x the output's elements x the
    contracted size (a convolution's: its input channels times its window,
    padding taps included, as FlopCounterMode counts a convolution of an
    explicitly padded input), each scan body counted once per step
    (once=True: once, however many steps its scan takes)."""
    from jax._src import core
    out = {"dot": 0, "conv": 0} if out is None else out
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim in ("dot_general", "conv_general_dilated"):
            o = eqn.outvars[0].aval.shape
        if prim == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            out["dot"] += mult * 2 * math.prod(o) * math.prod(
                lhs[i] for i in lc)
        elif prim == "conv_general_dilated":
            rhs, spec = (eqn.invars[1].aval.shape,
                         eqn.params["dimension_numbers"].rhs_spec)
            out["conv"] += mult * 2 * math.prod(o) * rhs[spec[1]] \
                * math.prod(rhs[i] for i in spec[2:])
        steps = eqn.params["length"] if prim == "scan" and not once else 1
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                if isinstance(sub, core.ClosedJaxpr):
                    sub = sub.jaxpr
                if isinstance(sub, core.Jaxpr):
                    _jax_flops(sub, once, mult * steps, out)
    return out


def _jax_setup(cfg):
    """The JAX package's plain-path config, params and make_batch's batch
    for the port's cfg."""
    import jax
    import jax.numpy as jnp
    from desire_tpu.config import DesireConfig as JaxConfig
    from desire_tpu.models import desire as jdesire
    jcfg = JaxConfig.from_json(cfg.replace(use_pallas=False).to_json())
    params = jdesire.init_desire(jax.random.PRNGKey(0), jcfg)
    batch = [jnp.asarray(x.numpy())
             for x in bench.make_batch(cfg, device="cpu")]
    return jax, jdesire, jcfg, params, batch


@pytest.mark.parametrize("variant", [n for n, _ in bench.VARIANTS])
def test_model_flops_of_the_forward_against_the_jax_model(variant):
    """model_flops of each sweep variant's forward equals the matmul and
    convolution FLOPs of the JAX package's plain forward, read from its
    jaxpr with each GRU scan's body counted once per step."""
    cfg = dict(bench.variant_cfgs(_toy()))[variant]
    jax, jdesire, jcfg, params, (xy, mask, ids) = _jax_setup(cfg)
    jaxpr = jax.make_jaxpr(lambda p: jdesire.desire_forward(
        p, jcfg, xy, mask, ids, key=jax.random.PRNGKey(1),
        train=False))(params)
    want = _jax_flops(jaxpr.jaxpr)
    assert bench.model_flops(cfg, False, "cpu") == want["dot"] \
        + want["conv"] > 0


def test_model_flops_of_a_step_against_the_jax_gradient():
    """model_flops of a training step equals the FLOPs of the JAX loss's
    gradient, read from its jaxpr, less the work autograd has no need of:
    JAX's scan transpose also takes the cotangent of a GRU scan's constant
    zero initial state (one h @ wh^T a scan: the observed and the future
    encoders' layers over B*A rows, each IOC pass's over B*A*K rows), and
    JAX's convolution transposes count the holes and padding of their
    dilated inputs, so the convolutions are counted as autograd runs them:
    each forward convolution, its weight gradient, and its input gradient
    where the input needs one (all but the scene CNN's first, which reads
    the raster). Adam adds no matmul."""
    cfg = _toy()
    jax, jdesire, jcfg, params, (xy, mask, ids) = _jax_setup(cfg)

    def loss(p):
        return jdesire.desire_loss(p, jcfg, xy, mask, ids,
                                   key=jax.random.PRNGKey(1), step=0)[0]
    fwd = _jax_flops(jax.make_jaxpr(loss)(params).jaxpr)
    grad = _jax_flops(jax.make_jaxpr(jax.grad(loss))(params).jaxpr)
    n, d = cfg.batch_size * cfg.max_num_obj, cfg.d_dim
    zero_h0 = 2 * d * 3 * d * (2 * cfg.num_layers * n + (
        max(cfg.num_refine, 1) + 1) * n * cfg.num_samples)
    conv1 = (2 * cfg.batch_size * cfg.scene_grid ** 2 * 9
             * (2 + cfg.scene_image_channels) * cfg.scene_channels)
    assert bench.model_flops(cfg, True, "cpu") == (
        grad["dot"] - zero_h0 + 3 * fwd["conv"] - conv1)


@pytest.mark.parametrize("shape", ["toy", "B2_A8_K5"])
def test_xla_cost_analysis_counts_each_scan_body_once(shape, monkeypatch,
                                                      capsys):
    """Why bench.py's MFU does not carry over: XLA's cost analysis of the
    JAX plain forward counts each scan's body once. Its count lies above
    the matmul and convolution FLOPs with each body counted once (it also
    counts element-wise work) and below model_flops; with the scans
    unrolled it lies above model_flops. At the toy and at flagship widths
    with B=2, A=8, K=5."""
    cfg = _toy() if shape == "toy" else bench.flagship_cfg(K=5).replace(
        batch_size=2, max_num_obj=8, compute_dtype="float32",
        social_freeze=False)
    jax, jdesire, jcfg, params, (xy, mask, ids) = _jax_setup(cfg)

    def fwd(p):
        return jdesire.desire_forward(p, jcfg, xy, mask, ids,
                                      key=jax.random.PRNGKey(1), train=False)

    def xla_flops():
        # a new function each time: jit would reuse the traced scans
        lowered = jax.jit(lambda p: fwd(p)).lower(params)
        ca = lowered.compile().cost_analysis()
        return float((ca[0] if isinstance(ca, (list, tuple)) else ca)[
            "flops"])
    once = sum(_jax_flops(jax.make_jaxpr(fwd)(params).jaxpr,
                          once=True).values())
    rolled = xla_flops()
    scan = jax.lax.scan
    monkeypatch.setattr(jax.lax, "scan", lambda *a, **kw: scan(
        *a, **dict(kw, unroll=True)))
    unrolled = xla_flops()
    ours = bench.model_flops(cfg, False, "cpu")
    with capsys.disabled():
        print(f"\nFLOPs of the {shape} forward: matmul and convolution with "
              f"each scan body once {once}, XLA {rolled}, XLA unrolled "
              f"{unrolled}, model_flops {ours}")
    assert once <= rolled < ours <= unrolled


def test_bench_and_bench_train_on_the_cpu():
    cfg = _toy()
    fwd = bench.bench(cfg, iters=2, warmup=1, device="cpu")
    assert set(fwd) == {"traj_per_sec", "fwd_ms", "fwd_ms_p90", "mfu_fwd",
                        "gflops"}
    assert fwd["mfu_fwd"] is None and fwd["fwd_ms"] > 0
    assert fwd["fwd_ms_p90"] >= fwd["fwd_ms"]
    assert math.isclose(fwd["traj_per_sec"], cfg.batch_size
                        * cfg.max_num_obj * cfg.num_samples
                        / (fwd["fwd_ms"] / 1e3))
    assert fwd["gflops"] == bench.model_flops(cfg, False, "cpu") / 1e9
    tr = bench.bench_train(cfg, iters=2, warmup=1, device="cpu")
    assert set(tr) == {"train_steps_per_sec", "train_step_ms",
                       "train_step_ms_p90", "mfu_train", "train_busy_ms",
                       "train_peak_gib"}
    assert math.isclose(tr["train_steps_per_sec"], 1e3 / tr["train_step_ms"])
    assert tr["mfu_train"] is tr["train_busy_ms"] is tr["train_peak_gib"] \
        is None


def test_breakdown_on_the_cpu(monkeypatch, capsys):
    """--breakdown through main: six rows on stdout (and stderr), one a
    variant, flagship_cfg cut to a toy."""
    monkeypatch.setattr(bench, "flagship_cfg",
                        lambda K=20: _toy(num_samples=K))
    rows = bench.main(["--breakdown", "--device", "cpu"])
    out = capsys.readouterr()
    lines = [json.loads(x) for x in out.out.strip().splitlines()]
    assert lines == rows == [json.loads(x)
                             for x in out.err.strip().splitlines()]
    assert [r["variant"] for r in rows] == [n for n, _ in bench.VARIANTS]
    for r in rows:
        assert set(r) == {"variant", "ms", "ms_p90", "traj_per_sec",
                          "gflops", "mfu"}
        assert r["mfu"] is None and r["ms"] > 0 and r["gflops"] > 0
    k = {r["variant"]: r["gflops"] for r in rows}
    assert k["full_K12"] < k["full_K50"]
    assert k["full_refine4"] == k["full_refine4_unfused_ioc"]


def test_main_line_has_bench_py_keys(monkeypatch, capsys):
    monkeypatch.setattr(bench, "flagship_cfg",
                        lambda K=20: _toy(num_samples=K))
    rec = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    jax_keys = _jax_line_keys()
    assert {"metric", "value", "mfu_fwd", "mfu_train"} <= jax_keys
    want = {k for k in jax_keys if not k.startswith(_NOT_PORTED)}
    assert set(rec) == want | _PORT_KEYS
    assert rec["metric"] == "sampled_trajectories_per_sec_per_chip_K20"
    assert rec["vs_baseline"] is None and rec["device"] == "cpu"
    assert rec["mfu_fwd"] is None and rec["mfu_train"] is None
    toy = _toy(num_samples=20)
    assert math.isclose(rec["value"], toy.batch_size * toy.max_num_obj
                        * 20 / (rec["fwd_ms"] / 1e3), rel_tol=1e-3)
    for k in ("value", "fwd_ms", "fwd_ms_p90", "train_steps_per_sec_K20",
              "train_step_ms"):
        assert np.isfinite(rec[k]) and rec[k] > 0, k
