"""The port's spans and counters: host-clock totals kept always, profiler
ranges only while a profiler records.

A span times a piece of the program where the work happens::

    with telemetry.span("serve.request", id=n):
        ...

Each span keeps per-name totals on the host clock: calls, inclusive ns
and self ns (inclusive minus its direct children on the same thread).
The totals are a fixed few numbers per name, so a long-running server
does not grow them. A span opened without an ``id`` takes its enclosing
span's, so every span of one request or step shares that request's.

Set-up is charged to set-up: a span named ``setup.*`` (building or
loading the kernel library, packing weights, reading an index) has its
whole time taken out of every enclosing span's totals, setup spans
included, so the first request that happens to load the kernels does not
carry their build in its mean, and the ``setup.*`` totals add up without
counting a nested one twice.

Only while a ``torch.profiler`` records (``torch.autograd._profiler_enabled``)
does a span also open a profiler range ``desire::<name>`` with its id
as the keyword argument ``id`` (in the trace's args where the profiler
records shapes, ``record_shapes=True``). The range is a function-scope
record (``torch._C._profiler._RecordFunctionFast``), not a user
annotation: a user annotation also puts a copy of itself on the device's
timeline spanning every kernel launched inside it, which a reader of
the device's busy time would count as work. Without a profiler a span
costs one boolean check on top of its totals.

``count(name, n)`` adds to a counter, always. The kernel wrappers' launch
counts are the ``launch`` group (``LAUNCHES``, also ``ops.LAUNCHES``);
``tally`` reads counters and launch counts together and ``add_tally``
adds a difference of two back (a CUDA graph's replay).
``snapshot()`` returns plain numbers, so that callers take the difference
of two (``delta``, ``mean_ms``); ``reset()`` zeroes everything. The
registry is process-wide.

``idle_by_span`` splits the device's idle time over the innermost span
open during it; ``profile_intervals`` reads its inputs from a finished
profile, and ``profile_trace`` captures one.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import os
import threading
import time

import torch

PREFIX = "desire::"
SETUP = "setup."

# Launches of each kernel: every wrapper adds one where it launches its
# kernel, and nowhere else (``ops._build`` and ``ops`` re-export it).
LAUNCHES = {"sgm_sample": 0, "ioc_refine": 0, "ioc_refine_train": 0,
            "ioc_refine_bwd": 0, "ioc_bwd_wgrad": 0, "nll_fwd": 0,
            "nll_bwd": 0, "scene_pool_fwd": 0, "scene_pool_bwd": 0,
            "grad_sumsq": 0, "clip_adam": 0}
COUNTERS: dict[str, int] = {}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# span totals, name -> [calls, inclusive ns, self ns]: each live thread
# adds only to its own, so a span takes no lock; a thread that ends folds
# its totals into _RETIRED
_THREAD_TOTALS: dict[int, dict] = {}
_RETIRED: dict[str, list] = {}
_LOCK = threading.Lock()
_LOCAL = threading.local()
_clock = time.perf_counter_ns
_recording = torch.autograd._profiler_enabled


# the profiler's function-scope record with keyword arguments (spans
# open no range where a torch lacks it)
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def _add(acc, name, tot):
    got = acc.setdefault(name, [0, 0, 0])
    for i in range(3):
        got[i] += tot[i]


class _ThreadState:
    """A thread's stack of open spans and its span totals; when the
    thread ends, its totals go to the retired ones."""

    __slots__ = ("stack", "totals")
    # held by the class: the module's globals may be gone when a thread
    # state is collected at the interpreter's exit
    _lock, _live, _retired = _LOCK, _THREAD_TOTALS, _RETIRED
    _add = staticmethod(_add)

    def __init__(self):
        self.stack: list = []
        self.totals: dict = {}
        with self._lock:
            self._live[id(self)] = self.totals

    def __del__(self):
        with self._lock:
            for name, tot in self._live.pop(id(self), {}).items():
                self._add(self._retired, name, tot)


class span:
    """Context manager (``with span(name, id):``) and decorator
    (``@span(name)``) timing a piece of the program. ``discard = True``
    inside the block drops this call from the totals (a loop's last,
    empty pass). After the block, ``wall_ns`` is its duration on the host
    clock, set-up included."""

    __slots__ = ("name", "id", "discard", "wall_ns", "_t0", "_child",
                 "_setup", "_range", "_state")

    def __init__(self, name: str, id=None):
        self.name = name
        self.id = id
        self.discard = False
        self.wall_ns = self._child = self._setup = 0
        self._range = None

    def __enter__(self):
        try:
            state = _LOCAL.state
        except AttributeError:
            state = _LOCAL.state = _ThreadState()
        self._state = state
        stack = state.stack
        if self.id is None and stack:
            self.id = stack[-1].id
        if _Range is not None and _recording():
            self._range = _Range(PREFIX + self.name, (),
                                 {} if self.id is None else {"id": self.id})
            self._range.__enter__()
        stack.append(self)
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = self.wall_ns = _clock() - self._t0
        state = self._state
        stack = state.stack
        stack.pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        if self.discard:
            return False
        incl = wall - self._setup
        if stack:
            parent = stack[-1]
            if self.name.startswith(SETUP):
                parent._setup += wall
            else:
                parent._child += incl
                parent._setup += self._setup
        tot = state.totals.get(self.name)
        if tot is None:
            tot = state.totals[self.name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += incl
        tot[2] += incl - self._child
        return False

    def __call__(self, fn):
        name, ident = self.name, self.id

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, ident):
                return fn(*args, **kwargs)
        return spanned


def count(name: str, n: int = 1) -> None:
    """Add n to the counter ``name``."""
    with _LOCK:
        COUNTERS[name] = COUNTERS.get(name, 0) + int(n)


def tally() -> dict:
    """Every counter and launch count, {name: n}, the launch counts as
    ``launch.<kernel>`` (``snapshot``'s counters, without the spans)."""
    with _LOCK:
        out = dict(COUNTERS)
    out.update(("launch." + k, v) for k, v in LAUNCHES.items())
    return out


def add_tally(delta: dict) -> None:
    """Add each n of ``delta`` (a difference of two ``tally``) to its
    launch count or counter: a CUDA graph's replay counts what its
    capture counted."""
    for name, n in delta.items():
        kernel = name[len("launch."):] if name.startswith("launch.") else None
        if kernel in LAUNCHES:
            LAUNCHES[kernel] += n
        else:
            count(name, n)


def snapshot() -> dict:
    """{"spans": {name: {"calls", "total_s", "self_s"}}, "counters":
    {name: n}} as plain numbers; the launch counts are the counters
    ``launch.<kernel>``."""
    merged: dict = {}
    with _LOCK:
        for totals in [_RETIRED, *_THREAD_TOTALS.values()]:
            for name, tot in list(totals.items()):
                _add(merged, name, tot)
        counters = dict(COUNTERS)
    spans = {k: {"calls": c, "total_s": t / 1e9, "self_s": s / 1e9}
             for k, (c, t, s) in merged.items()}
    counters.update(("launch." + k, v) for k, v in LAUNCHES.items())
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Zero every span total, counter and launch count."""
    with _LOCK:
        for totals in [_RETIRED, *_THREAD_TOTALS.values()]:
            totals.clear()
        COUNTERS.clear()
    reset_launch_counts()


def delta(before: dict, after: dict) -> dict:
    """The spans of ``after`` minus those of ``before`` (two snapshots),
    for the names called in between."""
    out = {}
    for name, a in after["spans"].items():
        b = before["spans"].get(name, {"calls": 0, "total_s": 0.0,
                                       "self_s": 0.0})
        if a["calls"] > b["calls"]:
            out[name] = {k: a[k] - b[k] for k in a}
    return out


def mean_ms(spans: dict, prefixes=None) -> dict:
    """{name: ms a call} of a snapshot's (or ``delta``'s) spans, those
    whose name starts with one of ``prefixes`` (all by default)."""
    return {name: 1e3 * s["total_s"] / s["calls"]
            for name, s in sorted(spans.items())
            if s["calls"] and (prefixes is None
                               or name.startswith(tuple(prefixes)))}


def idle_by_span(busy, spans, window) -> dict:
    """Seconds of device idle time by the innermost span open during it.

    busy: (start, end) intervals in which the device worked, in ns;
    spans: (name, start, end) in ns on the same clock (a span opened later
    than another that is still open is the inner one); window: (start,
    end). Each idle interval of the window is split at every span
    boundary inside it, by time and not by where the gap began; what no
    span covers goes under ``outside``."""
    w0, w1 = window
    idle, edge = [], w0
    for s, e in sorted(busy):
        if s > edge:
            idle.append((edge, min(s, w1)))
        edge = max(edge, e)
        if edge >= w1:
            break
    if edge < w1:
        idle.append((edge, w1))
    idle = [(s, e) for s, e in idle if e > s]
    # span boundaries as events: (time, 1 opens / 0 closes, index)
    events = []
    for i, (_, s, e) in enumerate(spans):
        events.append((s, 1, i))
        events.append((e, 0, i))
    events.sort()
    out: dict[str, float] = {}
    opened: list = []      # (start, index) of the open spans, by start
    k = 0

    def add(s, e):
        if e <= s:
            return
        name = spans[opened[-1][1]][0] if opened else "outside"
        out[name] = out.get(name, 0.0) + (e - s) / 1e9

    for s, e in idle:
        # bring the open set up to the idle interval's start
        while k < len(events) and events[k][0] <= s:
            _apply(opened, spans, events[k])
            k += 1
        t = s
        while k < len(events) and events[k][0] < e:
            add(t, events[k][0])
            t = events[k][0]
            _apply(opened, spans, events[k])
            k += 1
        add(t, e)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _apply(opened, spans, event):
    _, opens, i = event
    item = (spans[i][1], i)
    if opens:
        bisect.insort(opened, item)
    else:
        opened.remove(item)


def profile_intervals(prof):
    """(busy, spans, window) of a finished ``torch.profiler.profile`` for
    ``idle_by_span``: the device's activities (the device's copies of user
    annotations left out), the host's ``desire::`` ranges, and the window
    from the first of these to the last."""
    cpu = torch.autograd.DeviceType.CPU
    busy, spans = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        end = s + e.duration_ns()
        name = e.name()
        if e.device_type() != cpu:
            # by kind, not by name: the kernels' own names start with the
            # C++ namespace desire:: too
            if not e.is_user_annotation():
                busy.append((s, end))
        elif name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], s, end))
    edges = [t for _, s, e in spans for t in (s, e)]
    edges += [t for iv in busy for t in iv]
    window = (min(edges), max(edges)) if edges else (0, 0)
    return busy, spans, window


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host activity with
    the spans' ``desire::`` ranges and their ids, and the card's kernels
    and copies where CUDA is available) and write it to
    ``<log_dir>/trace.json`` (Chrome trace format; open it in Perfetto or
    chrome://tracing) when the block ends. Yields the profile, which
    ``profile_intervals`` reads once the block has ended."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
