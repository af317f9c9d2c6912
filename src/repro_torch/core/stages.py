"""The exchange round as composable stages (open flow, S=1).

The same five stages as ``repro.core.stages``, over rank-stacked tensors and
an explicit :class:`RoundState`:

  SpillExtract    the §3.3 clamp site.  ``kind="flat"``: per-destination
                  counts truncated to the slot budget; ``kind="tier"``: a
                  hierarchical stage's stacked sub-segments truncated to the
                  tier's segment budget.  Drop mode counts the cut rows;
                  ``overflow="retain"`` extracts them as a pending spill
                  block ``(rows, dest, age, n)`` (the lossless law).
  Marshal         the send-side payload pass into the ``(R, A, S, W)`` peer
                  slot layout, ONE pass in either marshal mode, picked by
                  ``RoundState.marshal``: ``"sort"`` composes the sort
                  permutation into one gather (kernel K1), ``"scatter"``
                  stores every row at its slot (kernel K5) from the bucket
                  plan (kernel K4).  Later hierarchical tiers gather from
                  the received buffer (K1).
  CountExchange   the control plane: ``all_to_all`` of the clamped counts
                  (per tier: the per-sub-segment survivors, or at the final
                  tier the per-source-group totals).
  PayloadExchange the payload collective: ONE ``all_to_all`` of the buffer.
  Unmarshal       receive compaction into the destination queue (kernel K2),
                  rows past capacity dropped; under retain the arrivals land
                  behind the spill front.
  AdvanceTier     between hierarchical tiers: the received blocks become the
                  next tier's buffer, their sub-segment counts and offsets
                  derived from the tier's count exchange.

Each rank's digit on a tier (``jax.lax.axis_index`` of the reference) is
read from the stacked axis (``collectives.tier_digit``), so ``seg_dest``
stays per rank.  Credit flow and micro-shard pipelining belong to later
slices of the port (ROADMAP Queue 1 items 10 and 9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.collectives import StackedCollectives, tier_digit
from repro_torch.kernels.bucket_scatter import ops as bs_ops
from repro_torch.kernels.marshal import ops as marshal_ops

__all__ = [
    "AdvanceTier",
    "CountExchange",
    "Marshal",
    "PayloadExchange",
    "RoundState",
    "SpillExtract",
    "Unmarshal",
    "clamp_subsegments",
    "compact_blocks",
    "compose",
    "lanes_spill",
    "padded_send_buffer",
    "send_rows",
    "spill_positions",
    "subsegment_gather",
]


def _excl_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim=dim, dtype=x.dtype) - x


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-rank ``jnp.take`` along dim 1: ``x (B, N)``, ``idx (B, ...)``."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1).to(torch.int64)).reshape(idx.shape)


def spill_positions(n_slots: int, cut: torch.Tensor, seg_start: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source positions of a clamp site's cut rows, compacted segment-major.

    ``cut (B, K)`` rows were clamped off segment ``k``; they sit contiguously
    from ``seg_start[k]``.  Spill slot ``j`` maps to segment ``k = #{inclusive
    cumulative cut <= j}`` and position ``seg_start[k] + j - spill_off[k]``.
    Returns ``(k, pos)``, each ``(B, n_slots)`` int64; slots at or past the
    total cut hold clamped garbage the caller bounds by the spill count."""
    incl = torch.cumsum(cut, dim=1, dtype=cut.dtype)
    j = torch.arange(n_slots, dtype=incl.dtype, device=cut.device).expand(cut.shape[0], n_slots)
    k = torch.searchsorted(incl.contiguous(), j.contiguous(), right=True).clamp(0, cut.shape[1] - 1)
    pos = _take(seg_start, k) + j - _take(incl - cut, k)
    return k, pos.to(torch.int64)


def lanes_spill(
    packed, perm, age, allow_tbl, cut, seg_start, n_spill, *,
    num_ranks, marshal, dest_clean, dest_rank,
):
    """Pending spill block of a sender-side clamp over the INPUT lanes.

    ``allow_tbl``/``cut (B, R)``: per-destination allowance and cut count;
    ``seg_start (B, R)``: first cut position of each destination in the
    marshalled (sorted) order.  Sort mode reads the cut rows through
    ``perm``; scatter mode inverts the (dest, in-bucket rank) plan with one
    1-word scatter.  The rows move in ONE gather (K1).  Returns ``(rows (B,
    C, W), dest (B, C), age (B, C), n_spill (B,))``, valid on each rank's
    ``[0, n_spill)`` prefix, ages carried forward +1."""
    rows_n, C = packed.shape[:2]
    k, pos = spill_positions(C, cut, seg_start)
    if marshal == "scatter":
        lanes = torch.arange(C, dtype=torch.int64, device=packed.device).expand(rows_n, C)
        d = dest_clean.clamp(0, num_ranks - 1)
        al = _take(allow_tbl, d)
        tgt = torch.where(
            (dest_clean < num_ranks) & (dest_rank >= al),
            _take(_excl_cumsum(cut, 1), d) + dest_rank - al,
            C,
        ).to(torch.int64)
        src = torch.zeros(rows_n, C + 1, dtype=torch.int64, device=packed.device)
        src = src.scatter_(1, tgt, lanes)[:, :C]  # slot C collects the uncut lanes
    else:
        src = _take(perm, pos.clamp(0, C - 1)).to(torch.int64)
    return (
        marshal_ops.gather_rows(packed, src.to(torch.int32)),
        k.to(torch.int32),
        (_take(age, src) + 1).to(torch.int32),
        n_spill,
    )


def clamp_subsegments(cnt: torch.Tensor, slot: int, dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncate stacked sub-segments (entries of ``cnt`` along ``dim``,
    concatenated in that order) to a ``slot``-row budget per column.
    Returns ``(allowed, starts)``: ``allowed`` keeps a contiguous prefix of
    each column's concatenation, ``starts`` is where each surviving
    sub-segment begins."""
    raw_pref = _excl_cumsum(cnt, dim)
    allowed = torch.clamp(torch.minimum(cnt, slot - raw_pref), min=0)
    return allowed, _excl_cumsum(allowed, dim)


def subsegment_gather(
    allowed: torch.Tensor,  # (B, G, K) surviving sub-segment sizes per slot column k
    starts: torch.Tensor,  # (B, G, K) slot-local sub-segment starts
    src_base: torch.Tensor,  # (B, G, K) source offset of sub-segment (g, k)
    slot: int,
) -> torch.Tensor:
    """Source row of every (slot column k, slot position s): ``(B, K, slot)``
    int64.  Rows past a column's total are clamped garbage, masked
    downstream by the exchanged counts: the composed stage layout, so one
    gather builds a whole stage's send buffer."""
    B, G, K = allowed.shape
    s_idx = torch.arange(slot, dtype=allowed.dtype, device=allowed.device).expand(B, K, slot)
    incl = torch.cumsum(allowed, dim=1, dtype=allowed.dtype).transpose(1, 2).contiguous()  # (B, K, G)
    # sub-segment owning position s = number of fully completed predecessors
    g_c = torch.searchsorted(incl, s_idx.contiguous(), right=True).clamp(0, G - 1)
    at = lambda t: torch.gather(t.transpose(1, 2), 2, g_c)
    return (at(src_base) + s_idx - at(starts)).to(torch.int64)


def compact_blocks(
    recv_buf: torch.Tensor,  # (B, G, S, W) received padded blocks
    recv_counts: torch.Tensor,  # (B, G) valid rows per block
    capacity: int,
    front: Optional[torch.Tensor] = None,  # (B,) retain: rows [0, front) reserved
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Receive-side compaction: ``out[b, front[b] + roff[b, g] + s] =
    recv_buf[b, g, s]`` for ``s < recv_counts[b, g]``, rows past
    ``capacity`` dropped (§3.3), rows no block covers zero.  Returns ``(out
    (B, capacity, W), new_count (B,), drops (B,))``; with ``front`` the
    counts account against the room behind it."""
    roff = _excl_cumsum(recv_counts, 1)
    if front is not None:
        roff = roff + front[:, None]
    out = marshal_ops.fused_unmarshal(recv_buf, roff, recv_counts, capacity=capacity)
    total_recv = recv_counts.sum(dim=1, dtype=torch.int32)
    if front is None:
        new_count = torch.clamp(total_recv, max=capacity)
    else:
        new_count = torch.minimum(total_recv, torch.clamp(capacity - front, min=0))
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

    # marshal plan + payload (round inputs)
    packed: Any = None  # (B, C, W) packed payload
    perm: Any = None  # (B, C) sort mode: destination-sort permutation
    send_counts: Any = None  # (B, R) per-destination counts
    marshal: str = "sort"  # "sort" | "scatter"
    dest_clean: Any = None  # (B, C) scatter mode: sanitised destination
    dest_rank: Any = None  # (B, C) scatter mode: stable in-bucket rank
    retain: bool = False
    age: Any = None  # (B, C) retain: rounds each lane has waited

    # clamp site (SpillExtract)
    clamped: Any = None  # flat: (B, R) sender-clamped counts
    allowed: Any = None  # tier: (B, G, A) surviving sub-segment sizes
    starts: Any = None  # tier: slot-local sub-segment starts
    send_drops: Any = None  # (B,) rows the sender clamp cut
    pending: List[Any] = dataclasses.field(default_factory=list)  # retain spill blocks
    front: Any = None  # flat retain: (B,) spill front
    spill_run: Any = None  # hierarchical: (B,) rows parked so far
    drops: Any = None  # hierarchical: (B,) accumulated stage drops

    # sub-segment bookkeeping (hierarchical tiers)
    cnt: Any = None  # (B, R) per-sub-segment counts in current buffer order
    base: Any = None  # (B, R) per-sub-segment start offsets
    buf: Any = None  # current payload buffer (packed, then tier receives)
    n_rows: int = 0
    via_perm: bool = True  # True until the round's first payload pass
    seg_dest: Any = None  # retain: (B, R) sub-segment → global destination

    # exchange working set (Marshal / CountExchange / PayloadExchange)
    send_buf: Any = None  # (B, A, S, W)
    recv_counts: Any = None  # (B, A)
    recv_buf: Any = None  # (B, A, S, W)
    rcv: Any = None  # tier: (B, A, G) per-sub-segment survivors received

    # results (Unmarshal)
    out: Any = None  # (B, capacity, W)
    new_count: Any = None  # (B,)
    recv_drops: Any = None  # (B,)


@dataclasses.dataclass(frozen=True)
class SpillExtract:
    """The §3.3 clamp site.  ``kind="flat"``: the flat sender clamp.
    ``kind="tier"``: a hierarchical stage clamp — input LANES spill through
    the marshal plan while ``state.via_perm``, mid-route BUFFER rows park in
    place after it.  Drop mode counts the cut; retain mode extracts it as a
    pending block."""

    num_ranks: int
    capacity: int
    slot: int
    retain: bool = False
    kind: str = "flat"
    extent: int = 0  # tier: A_l, the stage's axis size

    def __call__(self, st: RoundState) -> RoundState:
        if self.kind == "tier":
            return self._tier(st)
        st.clamped = torch.clamp(st.send_counts, max=self.slot)
        send_drops = (st.send_counts - st.clamped).sum(dim=1, dtype=torch.int32)
        if self.retain:
            # the cut rows are the per-destination segment TAILS of the
            # marshalled order: one gather with the send gather's arithmetic
            off = _excl_cumsum(st.send_counts, 1)
            st.pending.append(lanes_spill(
                st.packed, st.perm, st.age, st.clamped,
                st.send_counts - st.clamped, off + st.clamped, send_drops,
                num_ranks=self.num_ranks, marshal=st.marshal,
                dest_clean=st.dest_clean, dest_rank=st.dest_rank,
            ))
            st.front = torch.clamp(send_drops, max=self.capacity)
            send_drops = torch.zeros_like(send_drops)
        st.send_drops = send_drops
        return st

    def _tier(self, st: RoundState) -> RoundState:
        A, S, R = self.extent, self.slot, self.num_ranks
        B = st.cnt.shape[0]
        cnt3 = st.cnt.reshape(B, R // A, A)  # rows: buffer order, cols: peer digit
        st.allowed, st.starts = clamp_subsegments(cnt3, S, dim=1)
        stage_drops = (cnt3 - st.allowed).sum(dim=(1, 2), dtype=torch.int32)
        if self.retain:
            alf = st.allowed.reshape(B, R)  # current buffer / destination order
            if st.via_perm:
                # sender-clamp spill from the INPUT lanes (buffer order ==
                # destination order at the first stage)
                st.pending.append(lanes_spill(
                    st.packed, st.perm, st.age, alf, st.cnt - alf, st.base + alf,
                    stage_drops, num_ranks=R, marshal=st.marshal,
                    dest_clean=st.dest_clean, dest_rank=st.dest_rank,
                ))
            else:
                # mid-route park: the cut sub-segment tails stay HERE, read
                # straight out of the stage buffer and re-addressed through
                # seg_dest; ages restart at 1 (age does not ride the wire)
                k, pos = spill_positions(self.capacity, st.cnt - alf, st.base + alf)
                src = pos.clamp(0, st.n_rows - 1).to(torch.int32)
                st.pending.append((
                    marshal_ops.gather_rows(st.buf, src),
                    _take(st.seg_dest, k),
                    torch.ones(B, self.capacity, dtype=torch.int32, device=st.cnt.device),
                    stage_drops,
                ))
            st.spill_run = st.spill_run + stage_drops
        else:
            st.drops = st.drops + stage_drops
        return st


@dataclasses.dataclass(frozen=True)
class Marshal:
    """The send-side payload pass.  ``kind="flat"``: the padded ``(R, S,
    W)`` peer-slot layout.  ``kind="tier"``: a hierarchical stage's ``(A,
    S, W)`` layout — sort permutation composed into the first stage's gather
    (K1), or the sort-free scatter straight into sub-segment slots (K5);
    later stages gather from the received buffer (K1)."""

    num_peers: int  # flat: R ranks; tier: A_l, the stage's axis size
    slot: int
    kind: str = "flat"
    num_ranks: int = 0  # tier: the global rank count R

    def __call__(self, st: RoundState) -> RoundState:
        if self.kind == "tier":
            return self._tier(st)
        st.send_buf = padded_send_buffer(
            st.packed, st.perm, st.send_counts,
            num_ranks=self.num_peers, peer_capacity=self.slot,
            marshal=st.marshal, dest_clean=st.dest_clean, dest_rank=st.dest_rank,
        )
        return st

    def _tier(self, st: RoundState) -> RoundState:
        A, S, R = self.num_peers, self.slot, self.num_ranks
        B, C, W = st.packed.shape
        if st.via_perm and st.marshal == "scatter":
            # first non-trivial stage, sort-free: each row straight to its
            # stage slot; sub-segment (rest, d_l) holds one destination, so
            # the in-bucket rank IS the in-sub-segment position; ranks past
            # the stage clamp go to the trash slot A·S (§3.3)
            row = (st.dest_clean // A).clamp(0, R // A - 1)
            col = (st.dest_clean % A).clamp(0, A - 1)
            cell = row * A + col
            allowed, starts = st.allowed.reshape(B, R), st.starts.reshape(B, R)
            keep = (st.dest_clean < R) & (st.dest_rank < _take(allowed, cell))
            dstpos = torch.where(keep, col * S + _take(starts, cell) + st.dest_rank, A * S)
            st.send_buf = bs_ops.scatter_rows(st.packed, dstpos.to(torch.int32), num_slots=A * S).reshape(B, A, S, W)
            return st
        pos = subsegment_gather(st.allowed, st.starts, st.base.reshape(B, R // A, A), S).reshape(B, -1)
        if st.via_perm:
            # first non-trivial stage: the sort permutation composed into
            # the send gather — the payload's single read of the round
            rows = _take(st.perm, pos.clamp(0, C - 1))
            st.send_buf = marshal_ops.fused_marshal(st.packed, rows.to(torch.int32), num_ranks=A, slot=S)
        else:
            rows = pos.clamp(0, st.n_rows - 1).to(torch.int32)
            st.send_buf = marshal_ops.fused_marshal(st.buf, rows, num_ranks=A, slot=S)
        return st


@dataclasses.dataclass(frozen=True)
class CountExchange:
    """The control-plane collective.  ``kind="flat"``: ``all_to_all`` of the
    clamped per-peer counts.  ``kind="tier"``: ``all_to_all`` over tier
    ``tier`` of the per-sub-segment survivor counts (so the receiver can
    address every sub-segment of each incoming block).  ``kind="final"``:
    the per-source-group totals — blocks are contiguous prefixes at the
    last tier."""

    comm: StackedCollectives
    kind: str = "flat"
    digits: Optional[Sequence[int]] = None  # tier/final: the tier layout
    tier: Optional[int] = None

    def __call__(self, st: RoundState) -> RoundState:
        a2a = lambda x: self.comm.all_to_all(x, digits=self.digits, tier=self.tier)
        if self.kind == "tier":
            st.rcv = a2a(st.allowed.transpose(1, 2).contiguous())  # (B, A, G): [src digit, sub-seg]
        elif self.kind == "final":
            sums = st.allowed.sum(dim=1, dtype=st.allowed.dtype)
            st.recv_counts = a2a(sums[:, :, None]).reshape(sums.shape)
        else:
            st.recv_counts = a2a(st.clamped[:, :, None]).reshape(st.clamped.shape)
        return st


@dataclasses.dataclass(frozen=True)
class PayloadExchange:
    """The payload collective: ONE ``all_to_all`` of the send buffer (over
    tier ``tier`` of ``digits`` on the hierarchical route)."""

    comm: StackedCollectives
    digits: Optional[Sequence[int]] = None
    tier: Optional[int] = None

    def __call__(self, st: RoundState) -> RoundState:
        st.recv_buf = self.comm.all_to_all(st.send_buf, digits=self.digits, tier=self.tier)
        return st


@dataclasses.dataclass(frozen=True)
class Unmarshal:
    """Receive-side compaction into the destination queue.  ``kind="flat"``
    reads the spill front SpillExtract reserved; ``kind="final"`` (the last
    hierarchical tier) reserves the accumulated spill run."""

    capacity: int
    kind: str = "flat"

    def _front(self, st: RoundState):
        if self.kind == "final":
            return torch.clamp(st.spill_run, max=self.capacity) if st.retain else None
        return st.front

    def __call__(self, st: RoundState) -> RoundState:
        st.out, st.new_count, st.recv_drops = compact_blocks(
            st.recv_buf, st.recv_counts, self.capacity, front=self._front(st)
        )
        return st


@dataclasses.dataclass(frozen=True)
class AdvanceTier:
    """Between hierarchical stages: reinterpret the received blocks as the
    next tier's buffer and derive its sub-segment counts and offsets from
    the count exchange — new buffer order ``(s_l, previous order − d_l)``."""

    extent: int
    slot: int
    digits: Sequence[int]
    tier: int
    retain: bool = False

    def __call__(self, st: RoundState) -> RoundState:
        A, S = self.extent, self.slot
        B, _, G = st.rcv.shape
        W = st.recv_buf.shape[-1]
        st.cnt = st.rcv.reshape(B, -1)  # new buffer order: (s_l, previous − d_l)
        a_off = torch.arange(A, dtype=st.rcv.dtype, device=st.rcv.device)[None, :, None] * S
        st.base = (_excl_cumsum(st.rcv, 2) + a_off).reshape(B, -1)
        st.buf = st.recv_buf.reshape(B, A * S, W)
        st.n_rows = A * S
        st.via_perm = False
        if self.retain:
            # sub-segment k of the NEW order (s_l, rest) holds the
            # destination whose digit l equals MINE, shared with every peer
            # of the remaining (slower) stages
            me_l = tier_digit(self.digits, self.tier, device=st.rcv.device)
            mine = torch.gather(st.seg_dest.reshape(B, G, A), 2, me_l[:, None, None].expand(B, G, 1))
            st.seg_dest = mine.reshape(B, G).repeat(1, A)
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
