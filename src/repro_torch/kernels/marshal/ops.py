"""K1 ``gather_rows`` and K2 ``unmarshal`` — the payload passes around the
exchange — and K7 ``marshal``, the two-pass marshal's segment copy, with the
plain versions of ``repro/kernels/marshal/ref.py`` and the per-leaf wrappers
``marshal_items`` / ``unmarshal_items`` of ``repro/kernels/marshal/ops.py``.

All tensors are rank-stacked: a leading axis B (one row per rank) in front
of the per-rank shapes of the JAX kernels, so one launch covers every rank.
Words are int32 carrying the bits of the JAX uint32 wire words.
"""
from __future__ import annotations

import ctypes

from typing import Any

import torch

from repro_torch import kernels as KN
from repro_torch.core import types as T
from repro_torch.kernels import build

__all__ = [
    "check_blocks",
    "fused_marshal",
    "fused_unmarshal",
    "gather_rows",
    "gather_rows_plain",
    "marshal",
    "marshal_items",
    "marshal_plain",
    "unmarshal",
    "unmarshal_items",
    "unmarshal_plain",
]

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGS = {
    "rafi_gather_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
    "rafi_unmarshal": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "rafi_marshal": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
}


_MAX_ROWS = 65535  # the kernels put the rank axis on the grid's y dimension


def _check_words(name: str, rows: int, per_rank: int, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} takes int32 tensors, got {t.dtype}")
    if rows > _MAX_ROWS or per_rank >= 2**31:
        raise ValueError(
            f"{name}: {rows} ranks of {per_rank} words exceed the kernel's "
            f"limits ({_MAX_ROWS} ranks, < 2^31 words per rank)"
        )


def gather_rows_plain(src: torch.Tensor, row_idx: torch.Tensor) -> torch.Tensor:
    """``out[b, i] = src[b, clip(row_idx[b, i], 0, C-1)]``."""
    cap, w = src.shape[1], src.shape[2]
    idx = row_idx.to(torch.int64).clamp(0, cap - 1)
    return torch.gather(src, 1, idx[:, :, None].expand(-1, -1, w))


def gather_rows(src: torch.Tensor, row_idx: torch.Tensor) -> torch.Tensor:
    """K1: ``src (B, C, W)``, ``row_idx (B, N)`` → ``(B, N, W)``."""
    if src.dim() != 3 or row_idx.dim() != 2 or row_idx.shape[0] != src.shape[0]:
        raise ValueError(
            f"gather_rows takes src (B, C, W) and row_idx (B, N), got "
            f"{tuple(src.shape)}, {tuple(row_idx.shape)}"
        )
    if KN.use_plain(src, row_idx):
        return gather_rows_plain(src, row_idx)
    rows, cap, w = src.shape
    n = row_idx.shape[1]
    _check_words("gather_rows", rows, max(n, cap) * w, src, row_idx)
    src, row_idx = src.contiguous(), row_idx.contiguous()
    out = torch.empty(rows, n, w, dtype=src.dtype, device=src.device)
    lib = build.load(_SIGS)
    rc = lib.rafi_gather_rows(
        src.data_ptr(), row_idx.data_ptr(), out.data_ptr(), rows, cap, n, w,
        KN.stream_handle(),
    )
    KN.check_launch(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def unmarshal_plain(
    recv_buf: torch.Tensor, recv_offsets: torch.Tensor, recv_counts: torch.Tensor,
    *, capacity: int,
) -> torch.Tensor:
    """Receive compaction, as ``ref.unmarshal`` per rank: block g's first
    ``recv_counts[b, g]`` rows land at ``clip(off, 0, cap) + s``; rows at or
    past ``capacity`` are cut; every other row is zero.  Blocks are written
    in order of g, so where they overlap the last one wins, as in the
    Pallas kernel's sequential grid."""
    rows, g, slot, w = recv_buf.shape
    dev = recv_buf.device
    off = recv_offsets.to(torch.int64).clamp(0, capacity)
    s = torch.arange(slot, dtype=torch.int64, device=dev)
    dstpos = off[:, :, None] + s[None, None, :]
    ok = s[None, None, :] < recv_counts[:, :, None]
    dstpos = torch.where(ok & (dstpos < capacity), dstpos, capacity)
    b_idx = torch.arange(rows, device=dev)[:, None].expand(rows, slot)
    # one trash row per rank absorbs every cut row; it is sliced off below
    out = torch.zeros(rows, capacity + 1, w, dtype=recv_buf.dtype, device=dev)
    for k in range(g):  # within one block the rows that land are distinct
        out.index_put_((b_idx, dstpos[:, k]), recv_buf[:, k])
    return out[:, :capacity]


_MAX_BLOCKS = 1024  # K2's table of G blocks in shared memory: csrc/marshal.cu


def check_blocks(g: int, *tensors: torch.Tensor) -> None:
    """Raise when K2 would have to compact ``g`` received blocks a rank, more
    than its table holds, on CUDA tensors: a round calls this before it
    launches anything.  The plain version has no such limit."""
    if g > _MAX_BLOCKS and not KN.use_plain(*tensors):
        raise ValueError(f"unmarshal: {g} received blocks a rank exceed the kernel's {_MAX_BLOCKS}")


def unmarshal(
    recv_buf: torch.Tensor, recv_offsets: torch.Tensor, recv_counts: torch.Tensor,
    *, capacity: int,
) -> torch.Tensor:
    """K2: ``recv_buf (B, G, S, W)``, ``recv_offsets``/``recv_counts (B, G)``
    → ``(B, capacity, W)``.  The kernel writes every output word once, so
    the output is allocated uninitialised."""
    if recv_buf.dim() != 4 or recv_offsets.shape != recv_buf.shape[:2] or (
        recv_counts.shape != recv_buf.shape[:2]
    ):
        raise ValueError(
            f"unmarshal takes recv (B, G, S, W) and offsets/counts (B, G), got "
            f"{tuple(recv_buf.shape)}, {tuple(recv_offsets.shape)}, {tuple(recv_counts.shape)}"
        )
    if KN.use_plain(recv_buf, recv_offsets, recv_counts):
        return unmarshal_plain(recv_buf, recv_offsets, recv_counts, capacity=capacity)
    rows, g, slot, w = recv_buf.shape
    _check_words("unmarshal", rows, max(g * slot, capacity) * w, recv_buf, recv_offsets, recv_counts)
    check_blocks(g, recv_buf)
    recv_buf = recv_buf.contiguous()
    recv_offsets, recv_counts = recv_offsets.contiguous(), recv_counts.contiguous()
    out = torch.empty(rows, capacity, w, dtype=recv_buf.dtype, device=recv_buf.device)
    lib = build.load(_SIGS)
    rc = lib.rafi_unmarshal(
        recv_buf.data_ptr(), recv_offsets.data_ptr(), recv_counts.data_ptr(),
        out.data_ptr(), rows, g, slot, w, capacity, KN.stream_handle(),
    )
    KN.check_launch(rc, "unmarshal")
    unmarshal.launches += 1
    return out


unmarshal.launches = 0


def fused_marshal(
    packed: torch.Tensor, src_rows: torch.Tensor, *, num_ranks: int, slot: int
) -> torch.Tensor:
    """``(B, C, W)`` packed payload + composed gather indices ``(B, R·S)`` →
    ``(B, R, S, W)`` send buffer in ONE payload pass (K1)."""
    buf = gather_rows(packed, src_rows)
    return buf.reshape(packed.shape[0], num_ranks, slot, packed.shape[-1])


def fused_unmarshal(
    recv_buf: torch.Tensor, recv_offsets: torch.Tensor, recv_counts: torch.Tensor,
    *, capacity: int,
) -> torch.Tensor:
    """``(B, G, S, W)`` received blocks → ``(B, capacity, W)`` compacted (K2)."""
    return unmarshal(
        recv_buf, recv_offsets.to(torch.int32), recv_counts.to(torch.int32),
        capacity=capacity,
    )


def marshal_plain(sorted_buf: torch.Tensor, offsets: torch.Tensor, *, num_ranks: int, slot: int) -> torch.Tensor:
    """``out[b, r, s] = sorted_buf[b, clip(offsets[b, r], 0, C-S) + s]``."""
    rows, cap, w = sorted_buf.shape
    off = offsets.to(torch.int64).clamp(0, cap - slot)
    src = off[:, :, None] + torch.arange(slot, device=sorted_buf.device)
    out = torch.gather(sorted_buf, 1, src.reshape(rows, -1, 1).expand(-1, -1, w))
    return out.reshape(rows, num_ranks, slot, w)


def marshal(sorted_buf: torch.Tensor, offsets: torch.Tensor, *, num_ranks: int, slot: int) -> torch.Tensor:
    """K7: each peer's contiguous ``slot``-row segment of a destination-
    sorted ``(B, C, W)`` buffer, from ``offsets (B, R)`` clipped to
    ``[0, C-S]``, into the ``(B, R, S, W)`` send layout."""
    if sorted_buf.dim() != 3 or offsets.shape != (sorted_buf.shape[0], num_ranks):
        raise ValueError(
            f"marshal takes sorted (B, C, W) and offsets (B, {num_ranks}), got "
            f"{tuple(sorted_buf.shape)}, {tuple(offsets.shape)}"
        )
    rows, cap, w = sorted_buf.shape
    if slot > cap:
        raise ValueError(f"peer slot {slot} exceeds capacity {cap}")
    if KN.use_plain(sorted_buf, offsets):
        return marshal_plain(sorted_buf, offsets, num_ranks=num_ranks, slot=slot)
    _check_words("marshal", rows, max(num_ranks * slot, cap) * w, sorted_buf, offsets)
    sorted_buf, offsets = sorted_buf.contiguous(), offsets.contiguous()
    out = torch.empty(rows, num_ranks, slot, w, dtype=sorted_buf.dtype, device=sorted_buf.device)
    lib = build.load(_SIGS)
    rc = lib.rafi_marshal(
        sorted_buf.data_ptr(), offsets.data_ptr(), out.data_ptr(), rows, cap,
        num_ranks, slot, w, KN.stream_handle(),
    )
    KN.check_launch(rc, "marshal")
    marshal.launches += 1
    return out


marshal.launches = 0


def marshal_items(sorted_items: Any, offsets: torch.Tensor, *, num_ranks: int, slot: int) -> Any:
    """Pytree of ``(B, C, ...)`` destination-sorted leaves → pytree of
    ``(B, R, S, ...)``: each leaf bitcast to words, copied by K7, bitcast
    back."""

    def one(a: torch.Tensor) -> torch.Tensor:
        words, spec = T.pack_payload(a, batch_dims=2)
        return T.unpack_payload(marshal(words, offsets, num_ranks=num_ranks, slot=slot), spec)

    return T.tree_map(one, sorted_items)


def unmarshal_items(
    recv_items: Any, recv_offsets: torch.Tensor, recv_counts: torch.Tensor, *, capacity: int
) -> Any:
    """Pytree of ``(B, G, S, ...)`` received blocks → pytree of ``(B,
    capacity, ...)``: each leaf bitcast to words, compacted by K2, bitcast
    back."""

    def one(a: torch.Tensor) -> torch.Tensor:
        words, spec = T.pack_payload(a, batch_dims=3)
        return T.unpack_payload(
            fused_unmarshal(words, recv_offsets, recv_counts, capacity=capacity), spec
        )

    return T.tree_map(one, recv_items)
