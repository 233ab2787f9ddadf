"""What the drivers share: their outcome, the seeded sample of answers kept
for the reference, and the steps between the window and the check."""

from __future__ import annotations

import dataclasses
import gc
import random

import numpy as np
import torch


@dataclasses.dataclass
class Outcome:
    """A driver's result: end-to-end values by metric name, the
    requests or steps attempted and failed in the window, the process's
    device memory peak, the trace (``--trace 1``) and what the per-layer
    metric readers read (``ctx``)."""
    e2e: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: object = None
    ctx: dict = dataclasses.field(default_factory=dict)


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn from ``seed``: the answers the reference checks."""

    def __init__(self, size, seed):
        self.size = size
        self.rng = random.Random(seed)
        self.items = []
        self.seen = 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.items[j] = item


def p95(values):
    """The 95th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def memory_peak(device):
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def release(device):
    """Frees what the program held before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reference_precision():
    """Float32 products as float32: no TF32 for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
