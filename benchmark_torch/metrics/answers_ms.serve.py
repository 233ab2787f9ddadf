"""The host's ms a request in the program's span ``serve.answers``: the
per-window answer dicts, sliced and scaled back to pixels."""

from benchmark_torch import program_spans


def read(ctx):
    return program_spans.span_ms("serve.answers")
