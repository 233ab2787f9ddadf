"""The host's ms a request in the program's span ``serve.copy_back``:
the trajectories, scores and picks copied to the host, the wait for the
card included."""

from benchmark_torch import program_spans


def read(ctx):
    return program_spans.span_ms("serve.copy_back")
