"""Build and load the hand-written CUDA kernels of ``desire_tpu_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per
source, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``. The build happens at first use,
into ``desire_tpu_torch/_build/<hash of the sources>/`` (a directory git
ignores), so a fresh checkout builds everything itself. The library is
written under a temporary name and renamed into place, so processes that
build at the same time do not read a half-written file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from desire_tpu_torch.utils import telemetry
# the kernel wrappers' launch counts, kept by the telemetry registry
from desire_tpu_torch.utils.telemetry import (  # noqa: F401
    LAUNCHES, reset_launch_counts)

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
LIB_NAME = "libdesire_kernels.so"


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose=False):
    """Compile the kernels unless this version is built already. Returns
    (path of the library, compiler output; empty when nothing was built).
    verbose adds ``-Xptxas -v`` (registers, shared memory and spills per
    kernel) and rebuilds even when the library exists."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists() and not verbose:
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
             "-c", "-o", obj, str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [src.name for src, p in zip(sources(), procs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(logs))
        so = os.path.join(tmp, LIB_NAME)
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("linking the kernels failed:\n" + proc.stdout
                               + proc.stderr)
        os.replace(so, lib)
    return lib, "".join(logs)


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def library():
    """The loaded kernel library (built first if needed), once a process:
    its time is the span ``setup.kernels``."""
    with telemetry.span("setup.kernels"):
        return _load()


def _load():
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.sgm_sample_launch.argtypes = ([_I, _I] + [_P] * 27 + [_I] * 9
                                      + [_P])
    lib.sgm_sample_launch.restype = _I
    lib.ioc_refine_launch.argtypes = ([_I, _I] + [_P] * 18 + [_I] * 9
                                      + [ctypes.c_float, _P])
    lib.ioc_refine_launch.restype = _I
    lib.ioc_refine_bwd_launch.argtypes = ([_I, _P, _P, _P] + [_I] * 9
                                          + [ctypes.c_float, _P])
    lib.ioc_refine_bwd_launch.restype = _I
    lib.ioc_refine_bwd_ws_words.argtypes = [_I] * 9
    lib.ioc_refine_bwd_ws_words.restype = ctypes.c_longlong
    lib.ioc_refine_bwd_wgrad_ctas.argtypes = [_I] * 8
    lib.ioc_refine_bwd_wgrad_ctas.restype = _I
    lib.ioc_refine_bwd_smem_bytes.argtypes = [_I] * 6
    lib.ioc_refine_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.ioc_refine_bwd_max_agents.argtypes = [_I] * 5
    lib.ioc_refine_bwd_max_agents.restype = _I
    lib.ioc_refine_tc_shape.argtypes = [_I] * 6 + [_P]
    lib.ioc_refine_tc_shape.restype = _I
    lib.nll_fwd_launch.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    lib.nll_fwd_launch.restype = _I
    lib.nll_bwd_launch.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    lib.nll_bwd_launch.restype = _I
    lib.scene_pool_fwd_launch.argtypes = [_I] + [_P] * 3 + [_I] * 5 + [_P]
    lib.scene_pool_fwd_launch.restype = _I
    lib.scene_pool_bwd_launch.argtypes = [_I] + [_P] * 6 + [_I] * 4 + [_P]
    lib.scene_pool_bwd_launch.restype = _I
    lib.scene_pool_bwd_ws_bytes.argtypes = [_I] * 4
    lib.scene_pool_bwd_ws_bytes.restype = ctypes.c_longlong
    lib.adam_layout.argtypes = [_I, _P, _P]
    lib.adam_layout.restype = ctypes.c_longlong
    lib.grad_sumsq_launch.argtypes = [_I] + [_P] * 6
    lib.grad_sumsq_launch.restype = _I
    lib.clip_adam_launch.argtypes = ([_I] + [_P] * 9 + [ctypes.c_float] * 4
                                     + [_P])
    lib.clip_adam_launch.restype = _I
    return lib


def check(t, name, shape, dtype, device):
    """Raise unless t is a contiguous tensor of this shape, dtype and
    device — what the kernels take."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: device {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
