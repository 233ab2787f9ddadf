"""The share of the forward's agent slots that carry an agent to forecast,
in %: the program's counters ``serve.live_slots`` over ``serve.slots``."""

from benchmark_torch import program_spans


def read(ctx):
    return program_spans.share_pct("serve.live_slots", "serve.slots")
