"""The exchange round as composable stages (flat, drop, open flow, S=1).

The same five stages as ``repro.core.stages``, over rank-stacked tensors and
an explicit :class:`RoundState`:

  SpillExtract    the §3.3 sender clamp: per-destination counts truncated to
                  the slot budget, the cut rows counted as drops.
  Marshal         the send-side payload pass into the ``(R, R, S, W)`` peer
                  slot layout, ONE pass in either marshal mode, picked by
                  ``RoundState.marshal``: ``"sort"`` composes the sort
                  permutation into one gather (kernel K1), ``"scatter"``
                  stores every row at ``d_clean·S + rank`` (kernel K5) from
                  the bucket plan (kernel K4).
  CountExchange   the control plane: ``all_to_all`` of the clamped counts.
  PayloadExchange the payload collective: ONE ``all_to_all`` of the buffer.
  Unmarshal       receive compaction into the destination queue (kernel K2),
                  rows past capacity dropped.

Retain spill, credit flow, tier stages and micro-shard pipelining belong to
later slices of the port (ROADMAP Queue 1 items 6, 7, 9 and 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.collectives import StackedCollectives
from repro_torch.kernels.bucket_scatter import ops as bs_ops
from repro_torch.kernels.marshal import ops as marshal_ops

__all__ = [
    "CountExchange",
    "Marshal",
    "PayloadExchange",
    "RoundState",
    "SpillExtract",
    "Unmarshal",
    "clamp_subsegments",
    "compact_blocks",
    "compose",
    "padded_send_buffer",
    "send_rows",
]


def _excl_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim=dim, dtype=x.dtype) - x


def clamp_subsegments(cnt: torch.Tensor, slot: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncate stacked sub-segments (rows of ``cnt``, concatenated in row
    order) to a ``slot``-row budget per column.  Returns ``(allowed,
    starts)``: ``allowed`` keeps a contiguous prefix of each column's
    concatenation, ``starts`` is where each surviving sub-segment begins."""
    raw_pref = _excl_cumsum(cnt, 0)
    allowed = torch.clamp(torch.minimum(cnt, slot - raw_pref), min=0)
    return allowed, _excl_cumsum(allowed, 0)


def compact_blocks(
    recv_buf: torch.Tensor,  # (B, G, S, W) received padded blocks
    recv_counts: torch.Tensor,  # (B, G) valid rows per block
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Receive-side compaction: ``out[b, roff[b, g] + s] = recv_buf[b, g, s]``
    for ``s < recv_counts[b, g]``, rows past ``capacity`` dropped (§3.3).
    Returns ``(out (B, capacity, W), new_count (B,), drops (B,))``."""
    roff = _excl_cumsum(recv_counts, 1)
    out = marshal_ops.fused_unmarshal(recv_buf, roff, recv_counts, capacity=capacity)
    total_recv = recv_counts.sum(dim=1, dtype=torch.int32)
    new_count = torch.clamp(total_recv, max=capacity)
    return out, new_count, total_recv - new_count


def send_rows(perm: torch.Tensor, send_counts: torch.Tensor, *, peer_capacity: int) -> torch.Tensor:
    """Source lane of every send-buffer row, ``(B, R·S)`` int32: slot ``s``
    of peer ``r`` reads lane ``perm[b, clip(off[b, r] + s, 0, C-1)]`` — the
    sort permutation composed with the padded send layout."""
    rows, cap = perm.shape
    off = _excl_cumsum(send_counts, 1)  # segment starts in sorted order
    s_idx = torch.arange(peer_capacity, dtype=torch.int32, device=perm.device)
    slotpos = (off[:, :, None] + s_idx[None, None, :]).clamp(0, cap - 1)
    return torch.gather(perm, 1, slotpos.reshape(rows, -1).to(torch.int64))


def padded_send_buffer(
    packed: torch.Tensor,  # (B, C, W) UNSORTED packed payload
    perm: Optional[torch.Tensor],  # (B, C) sort mode: destination-sort permutation
    send_counts: torch.Tensor,  # (B, R) valid-destination counts
    *,
    num_ranks: int,
    peer_capacity: int,
    marshal: str = "sort",
    dest_clean: Optional[torch.Tensor] = None,  # (B, C) scatter mode: sanitised dest
    dest_rank: Optional[torch.Tensor] = None,  # (B, C) scatter mode: in-bucket rank
) -> torch.Tensor:
    """The padded exchange's send-side marshal — the round's ONE payload
    pass.  Sort mode: row ``(r, s)`` of rank b's buffer is ``packed[b,
    perm[b, off[b, r] + s]]``.  Scatter mode: lane ``i`` goes to row
    ``d_clean·S + rank`` where ``d_clean < R`` and ``rank < S``, else it is
    dropped (position ``R·S``).  Returns ``(B, R, S, W)``; rows past a
    segment's clamped count are garbage (sort) or zeros (scatter), masked
    downstream by the exchanged counts."""
    R, S = num_ranks, peer_capacity
    if marshal == "scatter":
        keep = (dest_clean < R) & (dest_rank < S)
        dstpos = torch.where(keep, dest_clean * S + dest_rank, R * S)
        send_buf = bs_ops.scatter_rows(packed, dstpos, num_slots=R * S)
        return send_buf.reshape(packed.shape[0], R, S, packed.shape[-1])
    src = send_rows(perm, send_counts, peer_capacity=peer_capacity)
    return marshal_ops.fused_marshal(packed, src, num_ranks=num_ranks, slot=peer_capacity)


@dataclasses.dataclass
class RoundState:
    """Carried state a stage composition threads from stage to stage."""

    packed: Any = None  # (B, C, W) packed payload
    perm: Any = None  # (B, C) sort mode: destination-sort permutation
    send_counts: Any = None  # (B, R) per-destination counts
    marshal: str = "sort"  # "sort" | "scatter"
    dest_clean: Any = None  # (B, C) scatter mode: sanitised destination
    dest_rank: Any = None  # (B, C) scatter mode: stable in-bucket rank
    clamped: Any = None  # (B, R) sender-clamped counts
    send_drops: Any = None  # (B,) rows the sender clamp cut
    send_buf: Any = None  # (B, R, S, W)
    recv_counts: Any = None  # (B, R)
    recv_buf: Any = None  # (B, R, S, W)
    out: Any = None  # (B, capacity, W)
    new_count: Any = None  # (B,)
    recv_drops: Any = None  # (B,)


@dataclasses.dataclass(frozen=True)
class SpillExtract:
    """The §3.3 sender clamp of the flat exchange, drop mode."""

    num_ranks: int
    capacity: int
    slot: int

    def __call__(self, st: RoundState) -> RoundState:
        st.clamped = torch.clamp(st.send_counts, max=self.slot)
        st.send_drops = (st.send_counts - st.clamped).sum(dim=1, dtype=torch.int32)
        return st


@dataclasses.dataclass(frozen=True)
class Marshal:
    """The send-side payload pass into the ``(R, R, S, W)`` peer slots, in
    the state's marshal mode (sort gather or bucket scatter)."""

    num_peers: int
    slot: int

    def __call__(self, st: RoundState) -> RoundState:
        st.send_buf = padded_send_buffer(
            st.packed, st.perm, st.send_counts,
            num_ranks=self.num_peers, peer_capacity=self.slot,
            marshal=st.marshal, dest_clean=st.dest_clean, dest_rank=st.dest_rank,
        )
        return st


@dataclasses.dataclass(frozen=True)
class CountExchange:
    """The control-plane collective: ``all_to_all`` of the clamped counts."""

    comm: StackedCollectives

    def __call__(self, st: RoundState) -> RoundState:
        st.recv_counts = self.comm.all_to_all(st.clamped[:, :, None]).reshape(st.clamped.shape)
        return st


@dataclasses.dataclass(frozen=True)
class PayloadExchange:
    """The payload collective: ONE ``all_to_all`` of the send buffer."""

    comm: StackedCollectives

    def __call__(self, st: RoundState) -> RoundState:
        st.recv_buf = self.comm.all_to_all(st.send_buf)
        return st


@dataclasses.dataclass(frozen=True)
class Unmarshal:
    """Receive-side compaction into the destination queue."""

    capacity: int

    def __call__(self, st: RoundState) -> RoundState:
        st.out, st.new_count, st.recv_drops = compact_blocks(
            st.recv_buf, st.recv_counts, self.capacity
        )
        return st


def compose(*stage_seq, on_stage: Optional[Callable[[str], None]] = None):
    """Run stages in sequence over a :class:`RoundState` — the bulk graph.
    ``on_stage(name)``, if given, is called after each stage with the
    stage's class name (where a timer marks the stage boundaries)."""

    def run(st: RoundState) -> RoundState:
        for stage in stage_seq:
            st = stage(st)
            if on_stage is not None:
                on_stage(type(stage).__name__)
        return st

    return run
