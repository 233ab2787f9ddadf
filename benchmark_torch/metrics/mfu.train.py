"""The training step's share of the card's bf16 peak over the measured
window, in %: the benchmark's FLOP count of one step's loss, forward and
backward (``flops.py``) x steps a second / 989 TFLOP/s."""

from benchmark_torch import flops, work


def read(ctx):
    f = flops.recorded(ctx["config"], ctx["model"], ctx["batch"],
                       ctx["agents"], ctx["k"], train=True)
    return 100.0 * f * ctx["steps_per_s"] / work.PEAK_FLOP_S["bf16"]
