"""Parameter trees: conversion from and to the JAX package's trees, and the
port's own initialisation.

A tree is nested dicts and lists of arrays with the JAX package's names and
layouts (dense (in, out); GRU (in, 3H) with gates [r | z | n]; conv HWIO).
Conversion goes through numpy, so this module needs no JAX: anything with
``__array__`` is a leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from desire_tpu_torch.models.desire import init_desire

__all__ = ["from_jax", "to_numpy", "to_device", "init_desire",
           "require_device"]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def from_jax(tree, device="cpu", dtype=None):
    """Tree of numpy (or JAX) arrays -> tree of tensors on ``device``, cast
    to ``dtype`` when given. bfloat16 leaves pass through float32, which
    holds them exactly."""
    def leaf(x):
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)
    return _map(tree, leaf)


def require_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" raises without a CUDA device
    (the entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} needs a CUDA device "
                           "(pass --device cpu to run on the CPU)")
    return device


def to_device(tree, device):
    """Tree of tensors -> the same tree on ``device``."""
    return _map(tree, lambda t: torch.as_tensor(t).to(device))


def to_numpy(tree):
    """Tree of tensors -> tree of numpy arrays (bfloat16 as float32)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return _map(tree, leaf)
