"""The IOC refine call's bound (``work.ioc_fwd_work``) over the card's
time of the kernels launched inside the call into ``ops.ioc_refine``, in
%."""

from benchmark_torch import work


def read(ctx):
    s = ctx["trace"].device_s_per_call("ioc_refine")
    if s is None:
        return None
    w = work.ioc_fwd_work(ctx["model"], ctx["batch"], ctx["agents"],
                          ctx["k"])
    return work.roofline_pct(w, ctx["model"], 1e3 * s)
