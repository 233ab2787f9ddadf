"""The share of the traced training window that the card spent in the
gradient all-reduce between the ranks, in %: the device time of the NCCL
kernels (``ncclDevKernel_*``, ``ncclKernel_*``) over the window. The
kernel waits on the card for the slowest rank, so the share holds the
ranks' skew as well as the transfer. Nothing where no NCCL kernel ran
(gloo ranks)."""


def read(ctx):
    trace = ctx["trace"]
    s = sum(t for name, t in trace.device_ops
            if name.startswith(("ncclDevKernel", "ncclKernel")))
    if s <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * s / trace.window_s
