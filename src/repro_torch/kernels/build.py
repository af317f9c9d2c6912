"""Build the CUDA C++ kernels with ``nvcc`` and load them with ``ctypes``.

Every source ``csrc/*.cu`` exposes a plain C interface.  One ``nvcc`` call
compiles them all, on the machine with the card, into one shared library
``build/librafi-<hash>.so`` at the repository root (the hash covers every
source and the flags, so an edited kernel is rebuilt, never reused stale).
No PyTorch header is included: the build takes seconds, not minutes.  The
first launch of any wrapper builds and loads the library; nothing here runs
at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

from repro_torch import compat

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIB: Optional[ctypes.CDLL] = None
_BOUND: set = set()


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"librafi-{h.hexdigest()[:12]}.so"


def build() -> float:
    """Build the library unless it exists.  Returns the wall seconds taken."""
    t0 = time.perf_counter()
    out = _lib_path()
    if out.exists():
        return 0.0
    nvcc = compat.nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed (tensors on the CPU use the plain path)"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc {res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees a whole library
    return time.perf_counter() - t0


def load(signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library (built first if missing), with ``argtypes`` set
    from ``signatures`` and ``restype`` = ``c_int`` (each C entry point
    returns ``cudaGetLastError()``)."""
    global _LIB
    if _LIB is None:
        build()
        _LIB = ctypes.CDLL(str(_lib_path()))
    for fn, argtypes in signatures.items():
        if fn not in _BOUND:
            f = getattr(_LIB, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            _BOUND.add(fn)
    return _LIB
