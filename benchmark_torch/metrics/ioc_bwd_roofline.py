"""The IOC backward call's bound (``work.ioc_bwd_work``) over the card's
time of the kernels launched inside the call into
``ops.ioc_bwd.ioc_refine_bwd_cuda``, in %."""

from benchmark_torch import work


def read(ctx):
    s = ctx["trace"].device_s_per_call("ioc_bwd")
    if s is None:
        return None
    w = work.ioc_bwd_work(ctx["model"], ctx["batch"], ctx["agents"],
                          ctx["k"])
    return work.roofline_pct(w, ctx["model"], 1e3 * s)
