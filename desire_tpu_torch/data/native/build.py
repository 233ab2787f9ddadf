"""Build the native fast-CSV parser into ``lib/`` beside this file:
``python -m desire_tpu_torch.data.native.build``.

The library is compiled under a temporary name and renamed into place, so
a process that loads it never reads a half-written file. (In a
subdirectory without ``__init__.py``, no walk of the package's modules
takes it for a Python extension.)"""

import os
import subprocess
import sys


def build(verbose: bool = True) -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "fast_csv.cpp")
    os.makedirs(os.path.join(here, "lib"), exist_ok=True)
    out = os.path.join(here, "lib", "libfast_csv.so")
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, src]
    if verbose:
        print("+", " ".join(cmd))
    try:
        subprocess.check_call(cmd)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


if __name__ == "__main__":
    try:
        path = build()
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"build failed: {e}", file=sys.stderr)
        sys.exit(1)
    print(f"built {path}")
