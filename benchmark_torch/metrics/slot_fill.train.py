"""The share of the batches' agent slots that hold an agent, in %: the
program's counters ``train.live_slots`` over ``train.slots``."""

from benchmark_torch import program_spans


def read(ctx):
    return program_spans.share_pct("train.live_slots", "train.slots")
