"""The host's ms a request in the program's span ``serve.assemble``:
scaling the windows, padding them into the batch (``Predictor._assemble``)
and the scene raster."""

from benchmark_torch import program_spans


def read(ctx):
    return program_spans.span_ms("serve.assemble")
