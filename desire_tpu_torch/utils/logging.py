"""Structured metrics logging (PyTorch port of
``desire_tpu/utils/logging.py``).

:class:`MetricLogger` writes one JSON object a line to stdout and, when
given a path, to a line-buffered file (machine-readable, and a crash loses
at most the line being written). Trace capture is
``utils.telemetry.profile_trace``.
"""

from __future__ import annotations

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

