"""The share of the training loss's calls that replayed its CUDA graphs,
in %: the program's counters ``train.loss_graphed`` over
``train.loss_calls`` (every ``step_fn`` call, set-up's included). A
program that does not count them reads as nothing."""

from benchmark_torch import program_spans


def read(ctx):
    return program_spans.share_pct("train.loss_graphed", "train.loss_calls")
