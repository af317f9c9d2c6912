"""Device and toolchain probes, centralised (the role ``repro.compat`` plays
for the JAX package).

  resolve_device(device)   ``None`` → the CUDA card; raises when no card is
                           present instead of silently picking the CPU
  has_cuda()               a usable CUDA device is visible to torch
  nvcc_path()              the CUDA compiler, or ``None`` when absent
"""
from __future__ import annotations

import os
import shutil

import torch

__all__ = ["has_cuda", "nvcc_path", "resolve_device"]

_CUDA_HOME_NVCC = os.path.join("/usr/local/cuda", "bin", "nvcc")


def has_cuda() -> bool:
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card.  A CUDA request without a card raises
    ``RuntimeError``: the port never falls back to the CPU unless the caller
    asks for it with ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not has_cuda():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the host"
        )
    return dev


def nvcc_path() -> str | None:
    """Path of ``nvcc`` (``PATH`` first, then the toolkit's default home)."""
    found = shutil.which("nvcc")
    if found:
        return found
    return _CUDA_HOME_NVCC if os.path.exists(_CUDA_HOME_NVCC) else None
