"""The host's ms a request in the program's span ``serve.copy_in``: the
batch's and the noise's copies to the card."""

from benchmark_torch import program_spans


def read(ctx):
    return program_spans.span_ms("serve.copy_in")
