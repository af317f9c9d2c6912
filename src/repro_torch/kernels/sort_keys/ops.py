"""K3 ``pack_and_histogram`` and the sort-marshal plan built on it (§4.2.1).

The wrapper runs the CUDA kernel (``csrc/sort_keys.cu``) on CUDA tensors and
the plain version below — the counterpart of
``repro/kernels/sort_keys/ref.py`` — on CPU tensors.  The key sort itself
stays ``torch.sort``: the TPU kernel never sorted either (XLA's
``jax.lax.sort`` did, outside it).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch import kernels as KN
from repro_torch.core import sorting
from repro_torch.kernels import build

__all__ = [
    "pack_and_histogram", "pack_and_histogram_plain", "sort_permutation",
    "sort_permutation_hierarchical",
]

_SIGS = {
    "rafi_pack_and_histogram": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ),
}
_MAX_SHARED_BINS = 48 * 1024 // 4  # static shared memory without opt-in


def _idx_bits(capacity: int) -> int:
    return max(1, (capacity - 1).bit_length())


def pack_and_histogram_plain(
    dest: torch.Tensor, count: torch.Tensor, *, num_ranks: int, idx_bits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``dest (B, C)``, ``count (B,)`` → ``keys (B, C)`` int64
    holding the uint32 key ``(d_clean << idx_bits) | lane``, and ``hist
    (B, R+1)`` int32 (slot R = invalid/discard)."""
    cap = dest.shape[-1]
    lane = torch.arange(cap, dtype=torch.int64, device=dest.device)
    valid = (lane[None, :] < count[:, None]) & (dest >= 0) & (dest < num_ranks)
    d_clean = torch.where(valid, dest, num_ranks).to(torch.int64)
    keys = (d_clean << idx_bits) | lane[None, :]
    hist = torch.zeros(dest.shape[0], num_ranks + 1, dtype=torch.int32, device=dest.device)
    hist.scatter_add_(1, d_clean, torch.ones_like(dest, dtype=torch.int32))
    return keys, hist


def pack_and_histogram(
    dest: torch.Tensor, count: torch.Tensor, *, num_ranks: int, idx_bits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-stacked key pack + histogram in one pass: the kernel on CUDA
    tensors, :func:`pack_and_histogram_plain` on CPU tensors."""
    if dest.dim() != 2 or count.shape != dest.shape[:1]:
        raise ValueError(f"dest must be (B, C) and count (B,), got {tuple(dest.shape)}, {tuple(count.shape)}")
    if (num_ranks + 1).bit_length() + idx_bits > 32:
        raise ValueError("packed key exceeds 32 bits; reduce capacity or ranks")
    if KN.use_plain(dest, count):
        return pack_and_histogram_plain(dest, count, num_ranks=num_ranks, idx_bits=idx_bits)
    if dest.dtype != torch.int32 or count.dtype != torch.int32:
        raise TypeError("pack_and_histogram takes int32 dest and count")
    if num_ranks + 1 > _MAX_SHARED_BINS or dest.shape[0] > 65535:
        raise ValueError(
            f"{dest.shape[0]} rows of {num_ranks} ranks exceed the kernel's limits "
            f"({_MAX_SHARED_BINS - 1} ranks in shared memory, 65535 rows on the grid)"
        )
    dest, count = dest.contiguous(), count.contiguous()
    rows, cap = dest.shape
    keys = torch.empty(rows, cap, dtype=torch.int64, device=dest.device)
    hist = torch.zeros(rows, num_ranks + 1, dtype=torch.int32, device=dest.device)
    lib = build.load(_SIGS)
    rc = lib.rafi_pack_and_histogram(
        dest.data_ptr(), count.data_ptr(), keys.data_ptr(), hist.data_ptr(),
        rows, cap, num_ranks, idx_bits, KN.stream_handle(),
    )
    KN.check_launch(rc, "pack_and_histogram")
    pack_and_histogram.launches += 1
    return keys, hist


pack_and_histogram.launches = 0


def sort_permutation(
    dest: torch.Tensor, count: torch.Tensor, num_ranks: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel-path ``core.sorting.sort_permutation`` (method ``"pack"``):
    key pack + histogram in K3, key sort by ``torch.sort`` — the payload is
    never touched.  Returns ``(perm (B, C), sorted_dest (B, C), hist
    (B, R+1))``, all int32."""
    cap = dest.shape[-1]
    ib = _idx_bits(cap)
    keys, hist = pack_and_histogram(dest, count, num_ranks=num_ranks, idx_bits=ib)
    sorted_keys = torch.sort(keys, dim=-1).values  # keys are unique: any sort is stable
    d_sorted = (sorted_keys >> ib).to(torch.int32)
    perm = (sorted_keys & ((1 << ib) - 1)).to(torch.int32)
    return perm, d_sorted, hist


def sort_permutation_hierarchical(
    dest: torch.Tensor, count: torch.Tensor, level_sizes, *, method: str = "pack"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel-path ``core.sorting.sort_permutation_hierarchical``: the flat
    key sort of :func:`sort_permutation` (K3), whose order is the N-level
    key order because ranks are lexicographic in the tier digits.  With
    ``method="pack"`` the N-level key's width is checked first, so the
    configurations the reference's packed keys refuse are refused here too.
    Returns ``(perm (B, C), count_tensor (B, *level_sizes))``."""
    level_sizes = tuple(int(a) for a in level_sizes)
    if method == "pack":
        sorting.hierarchical_key_bits(level_sizes, dest.shape[-1])
    perm, _d_sorted, hist = sort_permutation(dest, count, math.prod(level_sizes))
    return perm, hist[:, :-1].reshape((dest.shape[0],) + level_sizes)
