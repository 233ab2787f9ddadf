"""The host's ms a step waiting for the loader's next batch, in the
program's span ``train.loader``."""

from benchmark_torch import program_spans


def read(ctx):
    return program_spans.span_ms("train.loader")
