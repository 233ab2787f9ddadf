"""Batch serving: one client in a closed loop sends requests of
``windows`` observation windows to ``serve.Predictor.predict_windows`` and
waits for each answer on the host.

Traffic (the cell's ``traffic``): a pool of ``pool`` requests of walking
agents drawn from the seed (``traffic.walk_windows``) and a pool of
``eps_pool`` latent-noise draws on the card; request i sends pool entry
i mod ``pool`` with noise i mod ``eps_pool``, so every seed sends the same
sizes. ``traj_per_s``: live agents x K hypotheses answered in the window
over its seconds; ``request_p95_ms``: over every request of the window,
from the call to its return with the answer on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark_torch import common, traffic
from benchmark_torch.reference import compare
from benchmark_torch.reference import params as ref_params
from benchmark_torch.trace import Tracer


def make_pools(h, cfg, k):
    t = h.traffic
    rng = np.random.default_rng(h.seed)
    pool = traffic.walk_windows(rng, t["pool"], t["windows"],
                                cfg.max_num_obj, cfg.obs_len,
                                t["speed_px"], t["turn_rad"], t["scale"])
    gen = torch.Generator(device=h.device)
    gen.manual_seed((h.seed + 1) % 2 ** 63)
    rows = t["windows"] * cfg.max_num_obj
    eps = [torch.randn((rows, k, cfg.latent_size), generator=gen,
                       device=h.device) for _ in range(t["eps_pool"])]
    return pool, eps


def trace_predictor(pred):
    """Ranges around the request's layers: the call, the host's window
    assembly, the forward, the sampler and IOC kernels' ops."""
    from desire_tpu_torch import ops
    from desire_tpu_torch.models import desire
    tr = Tracer()
    tr.wrap(pred, "predict_windows", "request")
    tr.wrap(pred, "_assemble", "assemble")
    tr.wrap(desire, "desire_forward", "forward")
    tr.wrap(ops, "sgm_sample_decode", "sgm_sample")
    tr.wrap(ops, "ioc_refine", "ioc_refine")
    return tr


def setup(h):
    """The Predictor on the seed's parameters, the request pools, and a
    function that sends request i and returns the answers."""
    from desire_tpu_torch.serve import Predictor
    t = h.traffic
    cfg = h.desire_config()
    params = ref_params.make_params(h.model, h.seed, h.device)
    pred = Predictor(params, cfg, device=h.device, k_samples=t["k"],
                     max_windows=t["windows"], seed=h.seed % 2 ** 63)
    pool, eps = make_pools(h, cfg, t["k"])

    def request(i):
        return pred.predict_windows(pool[i % len(pool)], scales=t["scale"],
                                    eps=eps[i % len(eps)])
    return pred, cfg, pool, eps, request


def run(h):
    t = h.traffic
    k = t["k"]
    pred, cfg, pool, eps, request = setup(h)
    for i in range(t["warmup"]):
        request(i)
    sample = common.Reservoir(t["check_requests"], h.seed)
    lat, ends, traj = [], [], 0
    i = 0
    start = h.start_window()
    deadline = start + h.seconds
    while True:
        t0 = time.perf_counter()
        out = request(i)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        ends.append(t1)
        traj += k * sum(int(o["live"].sum()) for o in out)
        sample.offer((i, out))
        i += 1
        if t1 >= deadline:
            break
    window_s = t1 - start
    peak = common.memory_peak(h.device)
    h.log_chunks(start, ends, "requests")
    h.log(f"window: {i} requests in {window_s:.4f} s, p50 "
          f"{1e3 * float(np.median(lat)):.4f} ms, p95 "
          f"{1e3 * common.p95(lat):.4f} ms, peak {peak} B")
    result = common.Outcome(
        e2e={"traj_per_s": traj / window_s,
             "request_p95_ms": 1e3 * common.p95(lat)},
        attempted=i, failed=0, memory_peak_bytes=peak,
        ctx={"requests_per_s": i / window_s, "batch": t["windows"],
             "agents": cfg.max_num_obj, "k": k})
    if h.trace:
        tr = trace_predictor(pred)
        with tr.window():
            for j in range(t["trace_requests"]):
                request(i + j)
        h.log(tr.result.summary())
        result.trace = tr.result
    del pred, request
    common.release(h.device)
    if h.control:
        got = gaps(h, pool, eps, [(i, None) for i, _ in sample.items],
                   prec="fp8")
    else:
        got = gaps(h, pool, eps, sample.items)
    for name, limit in h.limits().items():
        h.check(name, got[name], limit)
    return result


def gaps(h, pool, eps, sample, prec="f32"):
    """The serving numbers of the sampled (i, answers) against the
    reference; with answers None, the reference at ``prec`` stands in the
    program's place (the control)."""
    common.reference_precision()
    params = ref_params.make_params(h.model, h.seed, h.device)
    scale = h.traffic["scale"]
    block = h.traffic["ref_block"]
    t0 = time.perf_counter()
    out = {}
    for i, answers in sample:
        args = (params, h.model, pool[i % len(pool)], scale,
                eps[i % len(eps)], block)
        refined, scores, ids = compare.reference_answers(*args)
        if answers is None:
            answers = compare.as_answers(
                *compare.reference_answers(*args, prec)[:2], ids, scale)
        compare.merge(out, compare.serving_gaps(answers, refined, scores,
                                                ids, scale))
    h.log(f"reference: {len(sample)} requests in "
          f"{time.perf_counter() - t0:.3f} s")
    return out


FAULTS = ("answer", "half", "unrefined")


def plant(fault, request):
    """(a request function with one fault of the timed path, a function
    that takes the fault out): ``answer`` one agent's hypotheses swapped
    for another's where produced; ``half`` half of the windows left out,
    their answers copied from the others; ``unrefined`` the IOC's refine
    passes return their input unchanged."""
    if fault == "unrefined":
        from desire_tpu_torch import ops
        orig = ops.ioc_refine

        def skipped(p_ioc, p_scf, traj, *a, **kw):
            _, scores = orig(p_ioc, p_scf, traj, *a, **kw)
            return traj.float().clone(), scores
        ops.ioc_refine = skipped
        return request, lambda: setattr(ops, "ioc_refine", orig)

    def faulty(i):
        out = request(i)
        if fault == "answer":
            a = out[0]
            a["traj"][[0, 1]] = a["traj"][[1, 0]]
        elif fault == "half":
            half = len(out) // 2
            for j in range(half, len(out)):
                out[j] = dict(out[j - half], ids=out[j]["ids"],
                              live=out[j]["live"])
        return out
    return faulty, lambda: None


def readings(h, requests, fault=None):
    """The program's numbers (with ``fault`` planted) on ``requests``
    requests after one untimed one, and the float8 control's on the same
    requests."""
    pred, cfg, pool, eps, request = setup(h)
    request(0)
    undo = lambda: None  # noqa: E731
    if fault:
        request, undo = plant(fault, request)
    try:
        sample = [(i, request(i)) for i in range(requests)]
    finally:
        undo()
    del pred, request
    common.release(h.device)
    program = gaps(h, pool, eps, sample)
    control = gaps(h, pool, eps, [(i, None) for i, _ in sample], prec="fp8")
    return program, control
