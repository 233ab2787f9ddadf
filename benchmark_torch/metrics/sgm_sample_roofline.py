"""The fused sampler call's bound (``work.sampler_work``) over the card's
time of the kernels launched inside the call into
``ops.sgm_sample_decode``, in %."""

from benchmark_torch import work


def read(ctx):
    s = ctx["trace"].device_s_per_call("sgm_sample")
    if s is None:
        return None
    w = work.sampler_work(ctx["model"], ctx["batch"] * ctx["agents"],
                          ctx["k"])
    return work.roofline_pct(w, ctx["model"], 1e3 * s)
