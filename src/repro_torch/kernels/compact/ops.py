"""K6 ``compact_positions`` — the exclusive prefix sum behind ``enqueue``'s
stable append — with the plain version of ``repro/kernels/compact/ref.py``
and the dense-pack helper ``compact`` of ``repro/kernels/compact/ops.py``.

Rank-stacked: a mask ``(B, n)`` gives one scan per row, all rows in one
launch.
"""
from __future__ import annotations

import ctypes
from typing import Any, Tuple

import torch

from repro_torch import kernels as KN
from repro_torch.core import types as T
from repro_torch.kernels import build

__all__ = ["compact", "compact_positions", "compact_positions_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGS = {"rafi_compact_positions": (_P, _P, _P, _P, _I, _I, _I, _I, _P)}
_TILE = 8192  # lanes per block: csrc/compact.cu kTile


def compact_positions_plain(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pos[b, i] = #{j < i : mask[b, j]}`` and ``total[b] = #{mask[b]}``,
    both int32."""
    m = mask.to(torch.int32)
    cs = torch.cumsum(m, dim=1, dtype=torch.int32)
    return cs - m, cs[:, -1] if m.shape[1] else m.new_zeros(m.shape[0])


def compact_positions(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: ``mask (B, n)`` bool → ``(pos (B, n), total (B,))`` int32, in one
    single-pass launch that writes both outputs in full."""
    if mask.dim() != 2 or mask.dtype != torch.bool:
        raise ValueError(f"compact_positions takes a (B, n) bool mask, got {tuple(mask.shape)} {mask.dtype}")
    if KN.use_plain(mask):
        return compact_positions_plain(mask)
    rows, n = mask.shape
    if rows > 65535 or n >= 2**31:
        raise ValueError(f"compact_positions: {rows} rows of {n} lanes exceed the kernel's limits")
    mask = mask.contiguous()
    pos = torch.empty(rows, n, dtype=torch.int32, device=mask.device)
    if n == 0:
        return pos, torch.zeros(rows, dtype=torch.int32, device=mask.device)
    total = torch.empty(rows, dtype=torch.int32, device=mask.device)
    status, epoch = KN.lookback_status(mask.device, rows * -(-n // _TILE))
    lib = build.load(_SIGS)
    rc = lib.rafi_compact_positions(
        mask.data_ptr(), pos.data_ptr(), total.data_ptr(), status.data_ptr(), status.numel(),
        rows, n, epoch, KN.stream_handle(),
    )
    KN.check_launch(rc, "compact_positions")
    compact_positions.launches += 1
    return pos, total


compact_positions.launches = 0


def compact(items: Any, mask: torch.Tensor, capacity: int) -> Tuple[Any, torch.Tensor]:
    """Dense-pack the masked lanes of ``items`` (leaves ``(B, n, ...)``) into
    ``(B, capacity, ...)`` buffers, in lane order.  Returns ``(packed_items,
    count (B,))``; lanes past ``capacity`` are dropped (§3.3), unclaimed
    slots are zero."""
    pos, count = compact_positions(mask)
    slot = torch.where(mask & (pos < capacity), pos, capacity).to(torch.int64)
    rows = mask.shape[0]
    r_idx = torch.arange(rows, device=mask.device)[:, None].expand_as(slot)

    def one(leaf: torch.Tensor) -> torch.Tensor:
        out = leaf.new_zeros((rows, capacity + 1) + tuple(leaf.shape[2:]))
        out.index_put_((r_idx, slot), leaf)  # slot == capacity: the trash row
        return out[:, :capacity]

    return T.tree_map(one, items), torch.clamp(count, max=capacity)
