"""The share of the IOC backward's calls whose input and hidden matrices'
gradients the weight-gradient product kernel formed after the passes, in
%: the program's counters ``launch.ioc_bwd_wgrad`` over
``launch.ioc_refine_bwd``. 100 % where every call takes the backward's
tensor-core variant; a call on its CUDA-core variant, which sums them
inside the reverse steps, lowers it. A program that does not count that
kernel (no ``ioc_bwd_wgrad`` among ``telemetry.LAUNCHES``) reads as
nothing."""

from benchmark_torch import program_spans


def read(ctx):
    try:
        from desire_tpu_torch.utils import telemetry
    except ImportError:
        return None
    if "ioc_bwd_wgrad" not in getattr(telemetry, "LAUNCHES", {}):
        return None
    return program_spans.share_pct("launch.ioc_bwd_wgrad",
                                   "launch.ioc_refine_bwd")
