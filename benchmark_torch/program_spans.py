"""What the program's own spans and counters say at the end of a run
(``desire_tpu_torch.utils.telemetry``), for the per-layer metrics that
read them: totals over the whole process, so the measured window's calls
with the warm-up's, the correctness steps' and the traced ones' (a few
in a thousand). A program without the registry reads as nothing."""

from __future__ import annotations


def snapshot():
    try:
        from desire_tpu_torch.utils import telemetry
    except ImportError:
        return None
    return telemetry.snapshot()


def span_ms(name):
    """The span's mean ms a call (host clock, set-up taken out), or None
    where it was never called."""
    snap = snapshot()
    got = snap and snap["spans"].get(name)
    if not got or not got["calls"]:
        return None
    return 1e3 * got["total_s"] / got["calls"]


def share_pct(part, whole):
    """Counter ``part`` over counter ``whole``, in %, or None where
    ``whole`` is zero or missing."""
    snap = snapshot()
    counters = snap and snap["counters"]
    if not counters or not counters.get(whole):
        return None
    return 100.0 * counters.get(part, 0) / counters[whole]


def setup_s():
    """Seconds in the program's ``setup.*`` spans (building or loading
    the kernels, packing their weights, reading the loader's index), or
    None where none ran."""
    snap = snapshot()
    if snap is None:
        return None
    spans = [s for name, s in snap["spans"].items()
             if name.startswith("setup.")]
    return sum(s["total_s"] for s in spans) if spans else None
