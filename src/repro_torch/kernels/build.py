"""Build the CUDA C++ kernels with ``nvcc`` and load them with ``ctypes``.

Every source ``csrc/*.cu`` exposes a plain C interface.  On the machine with
the card, one ``nvcc`` per source compiles it to an object file, all of them
started together, and one more ``nvcc`` links the objects into one shared
library ``build/librafi-<hash>.so`` at the repository root.  The hash
covers every source, every header ``csrc/*.cuh`` the sources include, and
the flags, so an edited kernel or header is rebuilt, never reused stale.
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
NVCC_FLAGS = (  # compile flags; the link adds -shared
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_LIB: Optional[ctypes.CDLL] = None
_BOUND: set = set()


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
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
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(_sources(), objs)
    ]
    logs = [(p, p.communicate()[0]) for p in procs]
    try:
        failed = [f"{p.args[-1]} (rc {p.returncode}):\n{log}" for p, log in logs if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc {res.returncode}):\n{res.stdout}{res.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
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
