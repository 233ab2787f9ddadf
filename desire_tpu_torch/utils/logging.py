"""Structured metrics logging and trace capture (PyTorch port of
``desire_tpu/utils/logging.py``).

:class:`MetricLogger` writes one JSON object a line to stdout and, when
given a path, to a line-buffered file (machine-readable, and a crash loses
at most the line being written). :func:`profile_trace` captures a
``torch.profiler`` trace of a block of code as a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


class MetricLogger:
    def __init__(self, path: str | None = None, quiet: bool = False):
        """quiet: print nothing (a multi-process run's other ranks)."""
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1) if path else None
        self._quiet = quiet
        self._t0 = time.time()

    def log(self, record: dict) -> None:
        if self._quiet:
            return
        record = dict(record, t=round(time.time() - self._t0, 3))
        line = json.dumps(record, sort_keys=True, default=float)
        print(line)
        sys.stdout.flush()
        if self._f:
            self._f.write(line + "\n")

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host activity, and
    the card's kernels and copies where CUDA is available) and write it to
    ``<log_dir>/trace.json`` (Chrome trace format; open it in Perfetto or
    chrome://tracing) when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
