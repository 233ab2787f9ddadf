"""The host's ms a step in the program's span ``train.forward``:
``desire_loss``'s launches."""

from benchmark_torch import program_spans


def read(ctx):
    return program_spans.span_ms("train.forward")
