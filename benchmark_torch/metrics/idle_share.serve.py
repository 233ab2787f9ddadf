"""The share of the traced serving window in which no operation ran on
the card, in %."""


def read(ctx):
    share = ctx["trace"].idle_share()
    return None if share is None else 100.0 * share
