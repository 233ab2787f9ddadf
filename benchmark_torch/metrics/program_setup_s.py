"""The seconds of set-up the program itself times, its ``setup.*``
spans: building or loading the kernel library, packing the kernels'
weights, reading the loader's index."""

from benchmark_torch import program_spans


def read(ctx):
    return program_spans.setup_s()
