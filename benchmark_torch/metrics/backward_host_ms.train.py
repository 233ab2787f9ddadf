"""The host's ms a step in the program's span ``train.backward``:
``torch.autograd.grad``, the IOC backward kernel's launch among its
work."""

from benchmark_torch import program_spans


def read(ctx):
    return program_spans.span_ms("train.backward")
