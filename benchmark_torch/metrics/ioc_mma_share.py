"""The share of the IOC refine kernel's serving calls that took its
tensor-core path, in %: the program's counters ``launch.ioc_refine.mma``
over ``launch.ioc_refine``. 100 % where every call's layout fits that
path; a call that fell back to the CUDA-core kernel lowers it. A program
that does not count such calls (no ``ops.ioc_fused.TC_MAX_AGENTS``)
reads as nothing."""

from benchmark_torch import program_spans


def read(ctx):
    try:
        from desire_tpu_torch.ops import ioc_fused
    except ImportError:
        return None
    if not hasattr(ioc_fused, "TC_MAX_AGENTS"):
        return None
    return program_spans.share_pct("launch.ioc_refine.mma",
                                   "launch.ioc_refine")
