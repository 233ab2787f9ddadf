"""The host's ms a request in the program's span ``serve.forward``: the
forward's launches and ``best_of_k_by_score``, which return before the
card is done."""

from benchmark_torch import program_spans


def read(ctx):
    return program_spans.span_ms("serve.forward")
