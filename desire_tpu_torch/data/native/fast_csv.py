"""ctypes binding of the C++ fast CSV parser (libfast_csv.so; the port's
own copy of ``desire_tpu/data/native/fast_csv.py``).

The parser reads the transposed 4-row CSV once and parses all four rows in
one pass. The loader (``data/loader.py``) takes the Python reader when the
library has not been built: ``python -m desire_tpu_torch.data.native.build``.
This is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "lib", "libfast_csv.so")
_lib = None


def _load():
    global _lib
    if _lib is None and os.path.exists(_LIB_PATH):
        lib = ctypes.CDLL(_LIB_PATH)
        lib.count_fields.argtypes = [ctypes.c_char_p]
        lib.count_fields.restype = ctypes.c_long
        lib.parse_csv4.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.parse_csv4.restype = ctypes.c_long
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def read_processed_csv(path: str):
    """Parse a 4-row transposed CSV -> (frames i64, ids i64, xs f32, ys f32)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libfast_csv.so not built")
    p = path.encode()
    n = lib.count_fields(p)
    if n < 0:
        raise IOError(f"fast_csv: cannot read {path} (code {n})")
    out = np.empty((4, n), dtype=np.float64)
    got = lib.parse_csv4(p, n, out)
    if got != n:
        raise ValueError(f"fast_csv: {path}: expected {n} fields/row, parsed {got}")
    return (out[0].astype(np.int64), out[1].astype(np.int64),
            out[2].astype(np.float32), out[3].astype(np.float32))
