"""The traced window: ranges from the benchmark's own files around calls
into the program's layers, one ``torch.profiler`` trace, and what is read
from it.

``Tracer.wrap(module, name, label)`` replaces a module-level function (or
an object's attribute) by one that runs it inside the range
``bench::<label>`` for the traced window only. A kernel belongs to a range
when the host launched it while the range was open on that thread (the
profiler's correlation of each device activity with its launch), so a
call's device time does not depend on its kernels' names.
"""

from __future__ import annotations

import contextlib
import functools
import re
import sys
import time

import torch

PREFIX = "bench::"
# the host's calls that put work on the card (runtime and driver API)
_LAUNCH = re.compile(r"^cu(da)?[A-Z]")


class Tracer:
    """Collects the wrapped calls' ranges while ``window()`` is open and
    turns the trace into a ``TraceResult``."""

    def __init__(self):
        self._patches = []
        self.result = None

    def wrap(self, owner, attr, label):
        orig = getattr(owner, attr)

        @functools.wraps(orig)
        def traced(*args, **kwargs):
            with torch.profiler.record_function(PREFIX + label):
                return orig(*args, **kwargs)
        self._patches.append((owner, attr, orig, traced))

    @contextlib.contextmanager
    def window(self):
        """Profile the block; every wrapped call is ranged inside it."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        for owner, attr, _, traced in self._patches:
            setattr(owner, attr, traced)
        try:
            with profile(activities=acts) as prof:
                with torch.profiler.record_function(PREFIX + "window"):
                    yield
                    if torch.cuda.is_available():
                        torch.cuda.synchronize()
        finally:
            for owner, attr, orig, _ in self._patches:
                setattr(owner, attr, orig)
        t0 = time.perf_counter()
        self.result = TraceResult(prof.profiler.kineto_results.events())
        print(f"trace: read in {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)


def _kernel_name(name):
    m = re.search(r"[A-Za-z_][A-Za-z0-9_]*_kernel", name)
    return m.group(0) if m else name[:60]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceResult:
    """From kineto events: the window, the device's busy intervals, each
    range's calls and device seconds, the device operations by name, and
    the idle gaps labelled by the innermost range open on the host."""

    def __init__(self, events):
        ranges, launches, device = [], {}, []
        cpu = torch.autograd.DeviceType.CPU
        for e in events:
            name = e.name()
            if e.device_type() != cpu:
                # device activity; a range's device-side copy is no work
                if not name.startswith(PREFIX):
                    device.append(e)
            elif name.startswith(PREFIX):
                ranges.append((name[len(PREFIX):], e.start_thread_id(),
                               e.start_ns(), e.start_ns() + e.duration_ns()))
            elif _LAUNCH.match(name):
                launches[e.correlation_id()] = (e.start_thread_id(),
                                                e.start_ns())
        self.launch_calls = len(launches)
        self.sample = sorted({d.name()[:40] for d in device[:200]})[:6]
        win = [r for r in ranges if r[0] == "window"]
        self.window_ns = ((win[0][2], win[0][3]) if win
                          else (min((r[2] for r in ranges), default=0),
                                max((r[3] for r in ranges), default=0)))
        w0, w1 = self.window_ns
        self.window_s = (w1 - w0) / 1e9
        self.ranges = [r for r in ranges if r[0] != "window"]
        spans, by_name, self.range_s, self.calls = [], {}, {}, {}
        for r in self.ranges:
            self.calls[r[0]] = self.calls.get(r[0], 0) + 1
        # each range's open intervals by thread, to find a launch's ranges
        by_tid = {}
        for name, tid, s, e in self.ranges:
            by_tid.setdefault(tid, []).append((s, e, name))
        self.unattributed = 0
        for d in device:
            s = max(d.start_ns(), w0)
            e = min(d.start_ns() + d.duration_ns(), w1)
            if e <= s:
                continue
            spans.append((s, e))
            key = _kernel_name(d.name())
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e9
            launch = (launches.get(d.correlation_id())
                      or launches.get(d.linked_correlation_id()))
            if launch is None:
                self.unattributed += 1
                continue
            tid, t = launch
            for rs, re_, name in by_tid.get(tid, ()):
                if rs <= t <= re_:
                    self.range_s[name] = (self.range_s.get(name, 0.0)
                                          + (e - s) / 1e9)
        busy = _union(spans)
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        # idle gaps, each labelled by the innermost range open at its start
        gaps = []
        edge = w0
        for s, e in busy + [[w1, w1]]:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        idle = {}
        for s, e in gaps:
            label = self._label_at(s)
            idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
        self.idle_by_label = sorted(idle.items(), key=lambda kv: -kv[1])
        self.device_events = len(spans)

    def _label_at(self, t):
        inner = None
        for name, _, s, e in self.ranges:
            if s <= t < e and (inner is None or s >= inner[0]):
                inner = (s, name)
        return inner[1] if inner else "outside"

    def device_s_per_call(self, label):
        """Device seconds a call of the range ``label``, or None where the
        trace attributed no device time to it."""
        n = self.calls.get(label, 0)
        s = self.range_s.get(label, 0.0)
        return s / n if n and s > 0 else None

    def idle_share(self):
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 1.0 - self.busy_s / self.window_s

    def breakdown(self):
        return {"device_ops": [[k, v] for k, v in self.device_ops[:10]],
                "idle_gaps": [[k, v] for k, v in self.idle_by_label[:10]]}

    def summary(self):
        return (f"trace: window {self.window_s:.4f} s, busy {self.busy_s:.4f}"
                f" s, {self.device_events} device events "
                f"({self.unattributed} not matched to a launch), ranges "
                + ", ".join(f"{k} x{v} {self.range_s.get(k, 0.0):.4f} s"
                            for k, v in sorted(self.calls.items()))
                + f"; {self.launch_calls} launch calls; device events such "
                f"as {self.sample}")
