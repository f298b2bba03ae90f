"""Build the CUDA sources under ``csrc/`` into shared libraries at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` with a plain C interface
and loaded with ``ctypes``: no PyTorch headers, so a build takes seconds. The
output lives in ``kernels/build/`` (ignored by git) under a name that carries
the hash of the sources and flags, so an edited source rebuilds and an
unchanged one is loaded as it is. The compiler's register and shared-memory
report (``-Xptxas -v``) is kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Sequence, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> (library, build seconds, compiler log); one load per process
_LOADED: Dict[str, Tuple[ctypes.CDLL, float, str]] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH); "
                       "the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str, sources: Sequence[str]) -> pathlib.Path:
    """Where the library built from ``sources`` (names under ``csrc/``) lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build (when the hashed library is missing) and load ``name``."""
    if name in _LOADED:
        return _LOADED[name][0]
    out = library_path(name, sources)
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_lib = pathlib.Path(tmp) / out.name
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp_lib),
                   *(str(CSRC / s) for s in sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} ({' '.join(cmd)}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp_lib, out)  # atomic: concurrent builds agree
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = (lib, seconds, log_path.read_text() if log_path.exists() else "")
    return lib


def build_info(name: str) -> Tuple[float, str]:
    """(build seconds in this process, 0 when it was already built; compiler
    log) of a library that :func:`load` has loaded."""
    _, seconds, log = _LOADED[name]
    return seconds, log
