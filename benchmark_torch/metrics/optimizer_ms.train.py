"""The host's ms a step in the program's span ``train.optimizer``: the
gradient norm and Adam's update, leaf by leaf."""

from benchmark_torch import program_spans


def read(ctx):
    return program_spans.span_ms("train.optimizer")
