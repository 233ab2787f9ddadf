"""The host's ms a batch inside the loader's iterator over the measured
window (the harness's clock around each batch ``SDDLoader`` yields)."""


def read(ctx):
    return ctx["loader_ms"]
