"""The exchange round as composable stages.

The same five stages as ``repro.core.stages``, over rank-stacked tensors and
an explicit :class:`RoundState`:

  CreditGate      (``flow="credit"``) each sender's grant toward every
                  destination: its share of the receiver's one-round-stale
                  advert, ``free // R + (me < free % R)``.
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

  Reassemble      between the micro-shards of a pipelined tier: the
                  received chunk blocks stitched back into the bulk stage
                  buffer (local data movement, no collective).

Micro-shard pipelining (the overlap law, ``pipeline_shards=S``): every
shard-aware stage also has ``.shard(state, k)``, which issues shard ``k``'s
slice of the work — slot rows ``[k·S/shards, (k+1)·S/shards)`` of every
peer segment — and :class:`Pipelined` runs the per-shard chains one after
the other (marshal 0, counts 0, payload 0, unmarshal 0, marshal 1, …), as
the reference issues them.  The flat and final count exchanges repeat the
FULL count vector on every shard, so each shard derives its landing
offsets alone; a tier's count exchange ships each shard's own chunk counts
and sums them on receive.  Each shard lands its rows at their bulk
positions, so the round is bit-exact with S=1.  On one card the chains run
in order on one stream: nothing overlaps until a real wire exists.

The ragged exchange (``exchange.exchange_ragged``) composes no stage
object, as in the reference: it uses :func:`credit_grant`,
:func:`lanes_spill`, :func:`ragged_control_plane` (every rank's clamps and
landing offsets from the replicated count matrix, one ``(R, R)``
computation) and :func:`ragged_send_buffer` (the one payload pass into
destination order).

Each rank's digit on a tier (``jax.lax.axis_index`` of the reference) is
read from the global ids of the ranks the state holds (``RoundState.ranks``,
the collective backend's ``ranks(R)``, through ``collectives.tier_digit``),
so ``seg_dest`` stays per rank on either backend.  Destinations are global
rank ids throughout; a state's leading axis B is the ranks it holds.

Credit flow (the backpressure law).  The carried credits are ``(B, R)``:
row b is rank b's estimate of every destination's free space (the
reference's per-rank ``(R,)`` vector, stacked).  The grant tightens the
flat sender clamp, or the hierarchical route's FIRST clamp, and the
un-credited tail rides the retain spill.  The count collective widens by
ONE int32 column carrying the adverts: flat, every rank ships its fresh
receive room; hierarchical, tier l ships the minimum estimate over the
sender's tier-l subtree (the final tier folds in its fresh room first) and
the receiver fans it back over that subtree.  No call is added.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.collectives import StackedCollectives, tier_digit
from repro_torch.kernels.bucket_scatter import ops as bs_ops
from repro_torch.kernels.marshal import ops as marshal_ops

__all__ = [
    "AdvanceTier",
    "CountExchange",
    "CreditGate",
    "Marshal",
    "PayloadExchange",
    "Pipelined",
    "Reassemble",
    "RoundState",
    "SpillExtract",
    "Unmarshal",
    "clamp_subsegments",
    "compact_blocks",
    "compact_shard",
    "compose",
    "credit_grant",
    "lanes_spill",
    "padded_send_buffer",
    "ragged_control_plane",
    "ragged_send_buffer",
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


def ragged_control_plane(cnt: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every rank's ragged layout from the replicated ``(R_src, R_dst)`` count
    matrix at once: the receiver-capacity clamp (:func:`clamp_subsegments`
    down each destination column, so a segment or segment tail past
    ``capacity`` is cut, the §3.3 drop rule, decided without a round trip).
    Returns ``(send_sizes, output_offsets, recv_sizes)``, each ``(R, R)``
    with row = rank: row ``r`` is the reference's ``(R,)`` vectors at ``me
    = r`` — what ``r`` may deliver to each peer, where its block lands
    there, and what each peer delivers to ``r``."""
    allowed, roff = clamp_subsegments(cnt, capacity)
    return allowed, roff, allowed.transpose(0, 1).contiguous()


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
    return (out,) + _admit(recv_counts, capacity, front)


def _admit(recv_counts: torch.Tensor, capacity: int, front: Optional[torch.Tensor]):
    """``(new_count, drops)`` of a receive compaction: the arrivals admitted
    into the room behind ``front`` (all of ``capacity`` without one)."""
    total_recv = recv_counts.sum(dim=1, dtype=torch.int32)
    if front is None:
        new_count = torch.clamp(total_recv, max=capacity)
    else:
        new_count = torch.minimum(total_recv, torch.clamp(capacity - front, min=0))
    return new_count, total_recv - new_count


def compact_shard(
    acc: Optional[torch.Tensor],  # (B·capacity + B·G·chunk, W) accumulator, None at the first shard
    recv_buf: torch.Tensor,  # (B, G, chunk, W) shard k's received blocks
    recv_counts: torch.Tensor,  # (B, G) FULL per-block counts (shard-independent)
    capacity: int,
    *,
    row_offset: int,  # k·chunk — where this shard's rows sit in each block
    front: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One micro-shard's slice of the receive compaction: shard rows land at
    the SAME positions :func:`compact_blocks` gives them (``front[b] +
    roff[b, g] + row_offset + s``, valid while ``row_offset + s <
    recv_counts[b, g]``), so the union over shards is bit-exact with it.

    Plain PyTorch, as the reference's is plain XLA: K2 is output-driven (it
    writes every row of its output) and would erase the earlier shards'
    rows.  ``acc`` is the rank-stacked queue flattened, ``(B·capacity, W)``,
    then one trash row per slot of a shard: slot ``i`` that lies past its
    block's count or past capacity lands in row ``B·capacity + i`` (the
    reference's ``mode="drop"``), so no two slots write one row.  Given
    ``acc=None`` it is allocated with the queue zeroed; ``acc[:B·capacity]``
    viewed as ``(B, capacity, W)`` is the compacted queue."""
    B, G, chunk, W = recv_buf.shape
    if acc is None:
        acc = recv_buf.new_empty(B * (capacity + G * chunk), W)
        acc[:B * capacity].zero_()
    roff = _excl_cumsum(recv_counts, 1)
    if front is not None:
        roff = roff + front[:, None]
    s = torch.arange(chunk, dtype=roff.dtype, device=roff.device) + row_offset
    dstpos = roff[:, :, None] + s
    ok = (s < recv_counts[:, :, None]) & (dstpos < capacity)
    base = torch.arange(B, dtype=torch.int64, device=roff.device)[:, None, None] * capacity
    trash = torch.arange(B * capacity, B * (capacity + G * chunk), device=roff.device).view(B, G, chunk)
    slot = torch.where(ok, base + dstpos, trash)
    return acc.index_copy_(0, slot.reshape(-1), recv_buf.reshape(-1, W))


def send_rows(
    perm: torch.Tensor, send_counts: torch.Tensor, *, peer_capacity: int, lo: int = 0, rows: Optional[int] = None
) -> torch.Tensor:
    """Source lane of every send-buffer row, ``(B, R·n)`` int32: slot ``s``
    of peer ``r`` (``lo <= s < lo + n``, ``n = rows or peer_capacity``) reads
    lane ``perm[b, clip(off[b, r] + s, 0, C-1)]`` — the sort permutation
    composed with the padded send layout."""
    rows_b, cap = perm.shape
    off = _excl_cumsum(send_counts, 1)  # segment starts in sorted order
    n = peer_capacity if rows is None else rows
    s_idx = torch.arange(lo, lo + n, dtype=torch.int32, device=perm.device)
    slotpos = (off[:, :, None] + s_idx[None, None, :]).clamp(0, cap - 1)
    return torch.gather(perm, 1, slotpos.reshape(rows_b, -1).to(torch.int64))


def ragged_send_buffer(
    packed: torch.Tensor,  # (B, C, W) UNSORTED packed payload
    perm: Optional[torch.Tensor],  # (B, C) sort mode: destination-sort permutation
    send_counts: torch.Tensor,  # (B, R) valid-destination counts
    *,
    num_ranks: int,
    marshal: str = "sort",
    dest_clean: Optional[torch.Tensor] = None,  # (B, C) scatter mode: sanitised dest
    dest_rank: Optional[torch.Tensor] = None,  # (B, C) scatter mode: in-bucket rank
) -> torch.Tensor:
    """The ragged exchange's send-side marshal, the round's ONE payload
    pass: the payload in destination order, contiguous per-peer segments
    from ``off = excl_cumsum(send_counts)``, no slot padding.  Sort mode
    gathers through the permutation (K1); scatter mode stores lane ``i`` at
    ``off[d_clean] + rank`` (K5), DISCARD lanes at ``C`` (dropped).
    Returns ``(B, C, W)``; rows past the live total are garbage (sort) or
    zeros (scatter)."""
    if marshal == "scatter":
        C = packed.shape[1]
        off = _excl_cumsum(send_counts, 1)
        pos = _take(off, dest_clean.clamp(0, num_ranks - 1)) + dest_rank
        return bs_ops.scatter_rows(packed, torch.where(dest_clean < num_ranks, pos, C), num_slots=C)
    return marshal_ops.gather_rows(packed, perm)


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
    shards: int = 1,
    k: int = 0,
) -> torch.Tensor:
    """The padded exchange's send-side marshal — the round's ONE payload
    pass (a micro-shard's: slot rows ``[k·chunk, (k+1)·chunk)`` of every
    peer segment, ``chunk = S / shards``).  Sort mode: row ``(r, s)`` of
    rank b's buffer is ``packed[b, perm[b, off[b, r] + k·chunk + s]]``.
    Scatter mode: lane ``i`` goes to row ``d_clean·chunk + rank − k·chunk``
    where ``d_clean < R`` and the rank lies in the shard's chunk, else it is
    dropped (position ``R·chunk``).  Returns ``(B, R, chunk, W)``; rows past
    a segment's clamped count are garbage (sort) or zeros (scatter), masked
    downstream by the exchanged counts.  The union over shards is row for
    row the one-shard buffer."""
    R = num_ranks
    chunk = peer_capacity // shards
    lo = k * chunk
    B, _, W = packed.shape
    if marshal == "scatter":
        rank = dest_rank - lo if lo else dest_rank  # position in the shard's chunk
        keep = (dest_clean < R) & (rank < chunk)
        if lo:
            keep = keep & (rank >= 0)
        dstpos = torch.where(keep, dest_clean * chunk + rank, R * chunk)
        return bs_ops.scatter_rows(packed, dstpos, num_slots=R * chunk).reshape(B, R, chunk, W)
    src = send_rows(perm, send_counts, peer_capacity=peer_capacity, lo=lo, rows=chunk)
    return marshal_ops.fused_marshal(packed, src, num_ranks=R, slot=chunk)


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

    ranks: Any = None  # (B,) global ids of the ranks held (None: 0 … B-1)

    # credit flow — None / "open" unless ForwardConfig(flow="credit")
    flow: str = "open"
    credits: Any = None  # (B, R) carried-in per-destination free estimates
    credit_allow: Any = None  # (B, R) this round's per-destination grant
    credits_out: Any = None  # (B, R) working / updated estimates (returned)
    my_free: Any = None  # (B,) each rank's fresh advert this round

    # clamp site (SpillExtract)
    clamped: Any = None  # flat: (B, R) sender-clamped counts
    allowed: Any = None  # tier: (B, G, A) surviving sub-segment sizes
    starts: Any = None  # tier: slot-local sub-segment starts
    send_drops: Any = None  # (B,) rows the sender clamp cut
    stage_drops: Any = None  # tier: (B,) this tier's clamp loss (telemetry reads it)
    stage_held: Any = None  # retain: (B,) rows the current clamp held locally
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
    stage_pos: Any = None  # tier: cached (B, A, S) source positions (sharded gathers)

    # exchange working set (Marshal / CountExchange / PayloadExchange)
    send_buf: Any = None  # (B, A, S, W)
    recv_counts: Any = None  # (B, A)
    recv_buf: Any = None  # (B, A, S, W)
    rcv: Any = None  # tier: (B, A, G) per-sub-segment survivors received
    recv_blocks: List[Any] = dataclasses.field(default_factory=list)  # sharded tier receives

    # results (Unmarshal)
    acc: Any = None  # sharded: (B·capacity + B·G·chunk, W) accumulator (compact_shard)
    out: Any = None  # (B, capacity, W)
    new_count: Any = None  # (B,)
    recv_drops: Any = None  # (B,)


def credit_grant(credits: torch.Tensor, num_ranks: int, ranks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each holder's grant toward every destination, ``(B, R)`` int32: the
    floor share plus rank-ordered residual of the clipped advert, ``free //
    R + (me < free % R)`` with ``me`` the holding rank's global id
    (``ranks``; None: the row)."""
    free = torch.clamp(credits, min=0)
    me = (torch.arange(free.shape[0], device=free.device) if ranks is None else ranks)[:, None]
    return (free // num_ranks + (me < free % num_ranks).to(free.dtype)).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class CreditGate:
    """The backpressure law's sender gate: rank ``me`` may ship
    ``free[d] // R + (me < free[d] % R)`` rows to destination ``d`` — floor
    share plus rank-ordered residual of the advert, so the grants of all R
    senders sum to exactly the advertised room.  ``me`` is the holding rank
    (``RoundState.ranks``)."""

    num_ranks: int

    def __call__(self, st: RoundState) -> RoundState:
        st.credit_allow = credit_grant(st.credits, self.num_ranks, st.ranks)
        st.credits_out = st.credits
        return st

    def shard(self, st: RoundState, k: int) -> RoundState:
        # grants do not depend on the shard (the slot chunking is downstream)
        return self(st) if k == 0 else st


def _fresh_advert(room: torch.Tensor, reserve: int, num_ranks: int) -> torch.Tensor:
    """A receiver's advert: its room minus the emission reserve, floored at
    one credit per sender while room exists (``min(room, R)``)."""
    return torch.maximum(torch.clamp(room - reserve, min=0), torch.clamp(room, max=num_ranks)).to(torch.int32)


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
    reserve: int = 0  # credit: receive rows withheld for local emissions

    def __call__(self, st: RoundState) -> RoundState:
        if self.kind == "tier":
            return self._tier(st)
        st.clamped = torch.clamp(st.send_counts, max=self.slot)
        if st.flow == "credit":
            # the grant tightens the slot clamp; the extra cut rides the spill
            st.clamped = torch.minimum(st.clamped, st.credit_allow)
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
            st.stage_held = send_drops
            if st.flow == "credit":
                # my advert: the room behind the spill front, less the
                # emission reserve; with the drive's emission gate next
                # round's front cannot grow into it, so granted arrivals fit
                st.my_free = _fresh_advert(self.capacity - st.front, self.reserve, self.num_ranks)
            send_drops = torch.zeros_like(send_drops)
        st.send_drops = send_drops
        return st

    def _tier(self, st: RoundState) -> RoundState:
        A, S, R = self.extent, self.slot, self.num_ranks
        B = st.cnt.shape[0]
        cnt3 = st.cnt.reshape(B, R // A, A)  # rows: buffer order, cols: peer digit
        cnt_eff = cnt3
        if st.flow == "credit" and st.via_perm:
            # the route's FIRST clamp is gated: buffer order is destination
            # order here, so the grant reshapes onto the sub-segment grid and
            # the un-credited tail never enters any tier
            cnt_eff = torch.minimum(cnt3, st.credit_allow.reshape(B, R // A, A))
        st.allowed, st.starts = clamp_subsegments(cnt_eff, S, dim=1)
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
            st.stage_held = stage_drops
            stage_drops = torch.zeros_like(stage_drops)
        st.stage_drops = stage_drops
        st.drops = st.drops + stage_drops
        return st


@dataclasses.dataclass(frozen=True)
class Marshal:
    """The send-side payload pass.  ``kind="flat"``: the padded ``(R, S,
    W)`` peer-slot layout.  ``kind="tier"``: a hierarchical stage's ``(A,
    S, W)`` layout — sort permutation composed into the first stage's gather
    (K1), or the sort-free scatter straight into sub-segment slots (K5);
    later stages gather from the received buffer (K1).  ``.shard(st, k)``
    builds only slot rows ``[k·chunk, (k+1)·chunk)`` of every segment."""

    num_peers: int  # flat: R ranks; tier: A_l, the stage's axis size
    slot: int
    shards: int = 1
    kind: str = "flat"
    num_ranks: int = 0  # tier: the global rank count R

    def __call__(self, st: RoundState) -> RoundState:
        return self.shard(st, None)

    def shard(self, st: RoundState, k: Optional[int]) -> RoundState:
        if self.kind == "tier":
            return self._tier(st, k)
        st.send_buf = padded_send_buffer(
            st.packed, st.perm, st.send_counts,
            num_ranks=self.num_peers, peer_capacity=self.slot,
            marshal=st.marshal, dest_clean=st.dest_clean, dest_rank=st.dest_rank,
            shards=1 if k is None else self.shards, k=k or 0,
        )
        return st

    def _tier(self, st: RoundState, k: Optional[int]) -> RoundState:
        A, S, R = self.num_peers, self.slot, self.num_ranks
        chunk = S if k is None else S // self.shards
        lo = 0 if k is None else k * chunk
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
            s_in = _take(starts, cell) + st.dest_rank  # slot position in the column
            keep = keep & (s_in >= lo) & (s_in < lo + chunk)
            dstpos = torch.where(keep, col * chunk + s_in - lo, A * chunk)
            send = bs_ops.scatter_rows(st.packed, dstpos.to(torch.int32), num_slots=A * chunk)
            st.send_buf = send.reshape(B, A, chunk, W)
            return st
        if k is None or st.stage_pos is None:
            st.stage_pos = subsegment_gather(st.allowed, st.starts, st.base.reshape(B, R // A, A), S)
        pos = (st.stage_pos if k is None else st.stage_pos[:, :, lo:lo + chunk]).reshape(B, -1)
        if st.via_perm:
            # first non-trivial stage: the sort permutation composed into
            # the send gather — the payload's single read of the round
            rows = _take(st.perm, pos.clamp(0, C - 1))
            st.send_buf = marshal_ops.fused_marshal(st.packed, rows.to(torch.int32), num_ranks=A, slot=chunk)
        else:
            rows = pos.clamp(0, st.n_rows - 1).to(torch.int32)
            st.send_buf = marshal_ops.fused_marshal(st.buf, rows, num_ranks=A, slot=chunk)
        return st


@dataclasses.dataclass(frozen=True)
class CountExchange:
    """The control-plane collective.  ``kind="flat"``: ``all_to_all`` of the
    clamped per-peer counts.  ``kind="tier"``: ``all_to_all`` over tier
    ``tier`` of the per-sub-segment survivor counts (so the receiver can
    address every sub-segment of each incoming block).  ``kind="final"``:
    the per-source-group totals — blocks are contiguous prefixes at the
    last tier.  Sharded, the flat and final kinds repeat the FULL vector on
    every shard; the tier kind ships each shard's own chunk counts
    ``clip(allowed − k·chunk, 0, chunk)`` and sums them on receive.

    Under credit flow every kind's count block widens by one int32 column
    of adverts (module docstring); a sharded tier's widened calls repeat
    the same adverts, so only shard 0's read updates the credits."""

    comm: StackedCollectives
    kind: str = "flat"
    digits: Optional[Sequence[int]] = None  # tier/final: the tier layout
    tier: Optional[int] = None
    shards: int = 1
    slot: int = 0  # tier: full per-peer slot rows (shard chunking)
    num_ranks: int = 0  # credit: the global rank count R
    capacity: int = 0  # credit: queue capacity (subtree min fill, fresh room)
    reserve: int = 0  # credit final: receive rows withheld for local emissions

    def _a2a(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.all_to_all(x, digits=self.digits, tier=self.tier)

    def __call__(self, st: RoundState) -> RoundState:
        credit = st.flow == "credit"
        if self.kind == "tier":
            counts = st.allowed.transpose(1, 2).contiguous()  # (B, A, G): [peer digit, sub-seg]
            st.rcv = self._credit_recv(st, counts) if credit else self._a2a(counts)
        elif self.kind == "final":
            sums = st.allowed.sum(dim=1, dtype=st.allowed.dtype)
            recv = self._credit_recv(st, sums[:, :, None]) if credit else self._a2a(sums[:, :, None])
            st.recv_counts = recv.reshape(sums.shape)
        elif credit:
            # (B, R, 1) → (B, R, 2): column 1 carries my advert to every
            # peer; the received column 1 is every destination's advert
            wide = torch.stack([st.clamped, st.my_free[:, None].expand_as(st.clamped).to(st.clamped.dtype)], dim=2)
            recv = self._a2a(wide)
            st.recv_counts, st.credits_out = recv[:, :, 0], recv[:, :, 1].to(torch.int32)
        else:
            st.recv_counts = self._a2a(st.clamped[:, :, None]).reshape(st.clamped.shape)
        return st

    def _credit_recv(self, st: RoundState, counts: torch.Tensor) -> torch.Tensor:
        """The tier or final count call widened by the advert column:
        returns the un-widened received counts and applies the received
        subtree adverts to ``st.credits_out``."""
        B, A = counts.shape[:2]
        R, cap = self.num_ranks, self.capacity
        stride = math.prod(self.digits[self.tier + 1:])
        dev = counts.device
        me = self.comm.ranks(R, dev)[:, None]  # (B, 1) global rank
        r = torch.arange(R, device=dev)[None, :]  # (1, R) destination
        cur = st.credits_out
        if self.kind == "final":
            # fold my fresh post-spill room into my own entry first: the
            # spill run is complete at the final tier
            fresh = _fresh_advert(torch.clamp(cap - st.spill_run, min=0), self.reserve, R)
            st.my_free = fresh
            cur = torch.where(r == me, fresh[:, None], cur)
        sub = (r // stride) == (me // stride)  # my tier-l subtree
        adv = torch.where(sub, cur, cap).amin(dim=1)  # (B,)
        wide = torch.cat([counts, adv.to(counts.dtype)[:, None, None].expand(B, A, 1)], dim=2)
        recv = self._a2a(wide)
        # peer a's aggregate covers the ranks sharing my slower digits with
        # digit_l = a; my own subtree keeps its fresher per-rank entries
        dig = ((r // stride) % A).expand(B, R)
        upd = ((r // (stride * A)) == (me // (stride * A))) & (dig != (me // stride) % A)
        st.credits_out = torch.where(upd, torch.gather(recv[:, :, -1], 1, dig), cur).to(torch.int32)
        return recv[:, :, :-1]

    def shard(self, st: RoundState, k: int) -> RoundState:
        if self.kind != "tier":
            return self(st)
        # Σ_k clip(allowed − k·chunk, 0, chunk) = allowed
        chunk = self.slot // self.shards
        allowed_k = torch.clamp(st.allowed - k * chunk, 0, chunk).transpose(1, 2).contiguous()
        if st.flow == "credit":
            saved = st.credits_out
            part = self._credit_recv(st, allowed_k)
            if k > 0:  # the adverts do not depend on the shard: shard 0's read stands
                st.credits_out = saved
        else:
            part = self._a2a(allowed_k)
        st.rcv = part if k == 0 else st.rcv + part
        return st


@dataclasses.dataclass(frozen=True)
class PayloadExchange:
    """The payload collective: ONE ``all_to_all`` of the (current shard's)
    send buffer (over tier ``tier`` of ``digits`` on the hierarchical route).
    With ``collect=True`` (sharded non-final tiers) the received blocks are
    kept for :class:`Reassemble`."""

    comm: StackedCollectives
    digits: Optional[Sequence[int]] = None
    tier: Optional[int] = None
    collect: bool = False

    def __call__(self, st: RoundState) -> RoundState:
        st.recv_buf = self.comm.all_to_all(st.send_buf, digits=self.digits, tier=self.tier)
        if self.collect:
            st.recv_blocks.append(st.recv_buf)
        return st

    def shard(self, st: RoundState, k: int) -> RoundState:
        return self(st)


@dataclasses.dataclass(frozen=True)
class Unmarshal:
    """Receive-side compaction into the destination queue.  ``kind="flat"``
    reads the spill front SpillExtract reserved; ``kind="final"`` (the last
    hierarchical tier) reserves the accumulated spill run.  Sharded, each
    shard's rows land at their bulk positions (:func:`compact_shard`) and
    the last shard closes the count and drop accounting."""

    capacity: int
    shards: int = 1
    slot: int = 0  # full per-peer slot rows (shard row offsets)
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

    def shard(self, st: RoundState, k: int) -> RoundState:
        B, _, chunk, W = st.recv_buf.shape
        front = self._front(st)
        st.acc = compact_shard(None if k == 0 else st.acc, st.recv_buf, st.recv_counts, self.capacity, row_offset=k * chunk, front=front)
        if k == self.shards - 1:
            st.out = st.acc[:B * self.capacity].view(B, self.capacity, W)
            st.new_count, st.recv_drops = _admit(st.recv_counts, self.capacity, front)
        return st


@dataclasses.dataclass(frozen=True)
class Reassemble:
    """Stitch a sharded tier's received chunk blocks back into the bulk
    ``(B, A, S, W)`` stage buffer, ``full[b, a, k·chunk + s] =
    recv_k[b, a, s]``: local data movement, no collective, bit-exact with
    the bulk receive."""

    extent: int
    slot: int

    def __call__(self, st: RoundState) -> RoundState:
        B, A, _, W = st.recv_blocks[0].shape
        st.recv_buf = torch.stack(st.recv_blocks, dim=2).reshape(B, A, self.slot, W)  # (B, A, shards, chunk, W)
        st.recv_blocks = []
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
        st.stage_pos = None
        if self.retain:
            # sub-segment k of the NEW order (s_l, rest) holds the
            # destination whose digit l equals MINE, shared with every peer
            # of the remaining (slower) stages
            me_l = tier_digit(self.digits, self.tier, ranks=st.ranks)
            mine = torch.gather(st.seg_dest.reshape(B, G, A), 2, me_l[:, None, None].expand(B, G, 1))
            st.seg_dest = mine.reshape(B, G).repeat(1, A)
        return st


@dataclasses.dataclass(frozen=True)
class Pipelined:
    """Run shard-aware stages as per-shard chains, one after the other
    (marshal k → counts k → payload k → unmarshal k → marshal k+1 → …): the
    overlap law's schedule.  ``on_stage(name)``, if given, is called after
    each stage of each shard as ``"Stage#k"``."""

    stages: Tuple[Any, ...]
    shards: int
    on_stage: Optional[Callable[[str], None]] = None

    def __call__(self, st: RoundState) -> RoundState:
        for k in range(self.shards):
            for stage in self.stages:
                st = stage.shard(st, k)
                if self.on_stage is not None:
                    self.on_stage(f"{type(stage).__name__}#{k}")
        return st


def compose(*stage_seq, on_stage: Optional[Callable[[str], None]] = None):
    """Run stages in sequence over a :class:`RoundState` — the bulk graph.
    ``on_stage(name)``, if given, is called after each stage with the
    stage's class name (where a timer marks the stage boundaries); a
    :class:`Pipelined` stage marks its own shards."""

    def run(st: RoundState) -> RoundState:
        for stage in stage_seq:
            st = stage(st)
            if on_stage is not None and not isinstance(stage, Pipelined):
                on_stage(type(stage).__name__)
        return st

    return run
