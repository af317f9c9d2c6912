"""K4 ``rank_and_histogram`` and K5 ``scatter_rows`` — the sort-free
bucket-scatter marshal — with the plain versions of
``repro/kernels/bucket_scatter/ref.py`` and ``compact_rows`` on top.

K4 replaces the sort marshal's key pack + sort: one pass over the
destinations gives the sanitised destination, each lane's stable rank among
earlier lanes of the same destination, and the histogram (the send counts).
``base[d_clean] + rank`` is then the stable sort's placement, with no keys
and no sort.  K5 is the round's single payload pass: every row is stored
straight at its send-layout slot.  All tensors are rank-stacked (leading
axis B, one launch for all ranks); words are int32 carrying the bits of the
JAX uint32 wire words.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch import kernels as KN
from repro_torch.core import sorting
from repro_torch.kernels import build
from repro_torch.kernels.compact import ops as compact_ops

__all__ = [
    "compact_rows",
    "rank_and_histogram",
    "rank_and_histogram_plain",
    "scatter_rows",
    "scatter_rows_plain",
]

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGS = {
    "rafi_rank_and_histogram": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "rafi_scatter_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
}
_WARP_LANES = 1024  # lanes a warp: csrc/bucket_scatter.cu kWarpLanes (a tile holds 1 to 8 warps)
_MAX_BINS = 12288


def rank_and_histogram_plain(
    dest: torch.Tensor, count: torch.Tensor, *, num_ranks: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(d_clean, rank, hist)`` via the one-hot exclusive cumsum of
    ``ref.rank_and_histogram``: :func:`repro_torch.core.sorting.destination_rank`,
    which owns the formulation."""
    return sorting.destination_rank(dest, count, num_ranks)


def rank_and_histogram(
    dest: torch.Tensor, count: torch.Tensor, *, num_ranks: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: the sanitised destination (invalid lanes → R), the stable
    in-bucket rank and the ``(B, R+1)`` histogram in one single-pass
    launch that writes all three in full.  Counts are int32, exact at any
    capacity (the TPU kernel's 2**24 float cap does not apply)."""
    if dest.dim() != 2 or count.shape != dest.shape[:1]:
        raise ValueError(f"dest must be (B, C) and count (B,), got {tuple(dest.shape)}, {tuple(count.shape)}")
    if KN.use_plain(dest, count):
        return rank_and_histogram_plain(dest, count, num_ranks=num_ranks)
    if dest.dtype != torch.int32 or count.dtype != torch.int32:
        raise TypeError("rank_and_histogram takes int32 dest and count")
    rows, cap = dest.shape
    if num_ranks < 1 or num_ranks + 1 > _MAX_BINS or rows > 65535 or cap >= 2**31:
        raise ValueError(
            f"{rows} rows of {cap} lanes over {num_ranks} ranks exceed the kernel's "
            f"limits ({_MAX_BINS - 1} ranks, 65535 rows, < 2^31 lanes)"
        )
    dest, count = dest.contiguous(), count.contiguous()
    d_clean = torch.empty_like(dest)
    rank = torch.empty_like(dest)
    if rows == 0 or cap == 0:
        return d_clean, rank, torch.zeros(rows, num_ranks + 1, dtype=torch.int32, device=dest.device)
    hist = torch.empty(rows, num_ranks + 1, dtype=torch.int32, device=dest.device)
    # enough words for the smallest tile (one warp) the kernel picks
    status, epoch = KN.lookback_status(dest.device, rows * (num_ranks + 1) * -(-cap // _WARP_LANES))
    lib = build.load(_SIGS)
    rc = lib.rafi_rank_and_histogram(
        dest.data_ptr(), count.data_ptr(), d_clean.data_ptr(), rank.data_ptr(), hist.data_ptr(),
        status.data_ptr(), status.numel(), rows, cap, num_ranks, epoch, KN.stream_handle(),
    )
    KN.check_launch(rc, "rank_and_histogram")
    rank_and_histogram.launches += 1
    return d_clean, rank, hist


rank_and_histogram.launches = 0


def scatter_rows_plain(src: torch.Tensor, dstpos: torch.Tensor, *, num_slots: int) -> torch.Tensor:
    """``out[b, dstpos[b, i]] = src[b, i]`` as ``ref.scatter_rows``: rows
    whose position is negative or at/past ``num_slots`` are dropped,
    unclaimed slots are zero."""
    rows, _n, w = src.shape
    pos = dstpos.to(torch.int64)
    idx = torch.where((pos < 0) | (pos > num_slots), num_slots, pos)
    out = src.new_zeros(rows, num_slots + 1, w)  # + the trash row, cut below
    b_idx = torch.arange(rows, device=src.device)[:, None].expand_as(idx)
    out.index_put_((b_idx, idx), src)
    return out[:, :num_slots]


def scatter_rows(src: torch.Tensor, dstpos: torch.Tensor, *, num_slots: int) -> torch.Tensor:
    """K5: ``src (B, N, W)``, ``dstpos (B, N)`` → ``(B, num_slots, W)``."""
    if src.dim() != 3 or dstpos.shape != src.shape[:2]:
        raise ValueError(
            f"scatter_rows takes src (B, N, W) and dstpos (B, N), got "
            f"{tuple(src.shape)}, {tuple(dstpos.shape)}"
        )
    if KN.use_plain(src, dstpos):
        return scatter_rows_plain(src, dstpos, num_slots=num_slots)
    if src.dtype != torch.int32 or dstpos.dtype != torch.int32:
        raise TypeError("scatter_rows takes int32 words and int32 positions")
    rows, n, w = src.shape
    if rows > 65535 or max(n, num_slots) * w >= 2**31:
        raise ValueError(f"scatter_rows: {rows} ranks of {max(n, num_slots)} rows x {w} words exceed the kernel's limits")
    src, dstpos = src.contiguous(), dstpos.contiguous()
    out = torch.zeros(rows, num_slots, w, dtype=src.dtype, device=src.device)
    lib = build.load(_SIGS)
    rc = lib.rafi_scatter_rows(
        src.data_ptr(), dstpos.data_ptr(), out.data_ptr(), rows, n, w, num_slots,
        KN.stream_handle(),
    )
    KN.check_launch(rc, "scatter_rows")
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0


def compact_rows(src: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable front-compaction of the masked rows of ``src (B, N, W)``: the
    marked rows move to the front in their original order, unmarked slots
    stay zero.  The plan is the mask's exclusive prefix sum (K6), the payload
    moves in ONE :func:`scatter_rows` pass (K5).  Returns ``(out, slot,
    n_kept)``: ``slot`` is each source row's compacted position (``N`` for
    unmarked rows)."""
    n = src.shape[1]
    pos, n_kept = compact_ops.compact_positions(mask)
    slot = torch.where(mask, pos, n)
    return scatter_rows(src, slot, num_slots=n), slot, n_kept
