"""Packed-payload exchange (§4.2.2, MPI_Alltoallv) over rank-stacked tensors.

The caller packs the work items into ONE ``(R, C, W)`` buffer of words
(``core.types.pack_payload``).  Backends of the port so far:

* ``padded`` — fixed per-peer slots of ``peer_capacity`` rows, moved with a
  single ``all_to_all``; a stage composition (``core.stages``):
  SpillExtract → Marshal → CountExchange → PayloadExchange → Unmarshal.
* ``hierarchical`` — the N-stage padded exchange over a multi-tier rank
  layout ``level_sizes`` (slowest first; ranks lexicographic in the tier
  digits, slowest-major): dimension-ordered routing, FASTEST tier first,
  one SpillExtract → Marshal → CountExchange → PayloadExchange per
  non-trivial tier, ``AdvanceTier`` between tiers and ``Unmarshal`` after
  the last.  Placement is bit-identical to the flat backends.
* ``ragged`` — the MPI_Alltoallv analogue (the reference's production
  backend): the payload is placed ONCE in destination order, contiguous
  per-peer segments, and shipped in ONE ``ragged_all_to_all``; the control
  plane is one count ``all_gather`` from which every rank derives every
  rank's clamps and landing offsets: no padded slot, no per-peer clamp, no
  receive unpack pass.  On one card the stacked copy
  (``StackedCollectives.ragged_all_to_all``) is an output-driven gather
  that writes every lane of every receive queue whatever the live count;
  over a ``torch.distributed`` world (``DistributedCollectives``) the
  wire carries the live rows alone, with one host read a round for the
  split sizes.  Every rank reads its own rows of the replicated control
  plane (``comm.local``).
* ``onehot`` — the all-gather reference oracle, a deliberately different
  code path used by the tests and the chip smoke run.

All take either marshal plan: ``marshal="sort"`` with the destination-sort
``perm``, or ``marshal="scatter"`` with the bucket plan ``dest_clean`` /
``dest_rank`` (``perm`` is then None).

Budget per round: 1 payload ``all_to_all`` + 1 count ``all_to_all`` on
``padded``, one of each per non-trivial tier on ``hierarchical``, 1
``ragged_all_to_all`` + 1 count ``all_gather`` on ``ragged`` (recorded by
``core.collectives``); ``pipeline_shards=S`` makes it S of each, the
shards' chains run in turn (``stages.Pipelined``), payload bytes conserved
and placement bit-exact with S=1.  Segment overflow — sender-side,
tier-side or receiver-side — is dropped and counted exactly once.  Every
backend returns ``(recv_packed, recv_counts, new_count, drops, pending,
credits_out, stats)``.  With ``overflow="retain"`` ``pending`` holds the spill blocks
``(rows, dest, age, n)`` of every sender or tier clamp (the rows it would
have cut, compacted, with their global destination and aged counter), and
the receive compaction lands the arrivals behind them; otherwise it is
empty.  The onehot oracle has no sender clamp, so its plan is empty by
construction.  With ``telemetry=True`` ``stats`` is the round's
``telemetry.RoundStats``, read from control-plane values the round already
holds (no collective, no host sync); otherwise it is None.  With
``flow="credit"`` (under retain) the carried ``credits (R, R)`` gate the
first clamp (``stages.credit_grant``), each count call carries one more
int32 column of adverts, and ``credits_out`` is the updated ``(R, R)``
estimate; otherwise it is None.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import dataclasses

import torch

from repro_torch.core import stages as ST
from repro_torch.core.collectives import StackedCollectives
from repro_torch.kernels.bucket_scatter import ops as bs_ops
from repro_torch.kernels.marshal import ops as marshal_ops
from repro_torch.telemetry import stats as TS

__all__ = ["exchange_counts", "exchange_hierarchical", "exchange_onehot", "exchange_padded", "exchange_ragged"]


def exchange_counts(send_counts: torch.Tensor, comm: StackedCollectives) -> torch.Tensor:
    """§4.2.2 step 2 — MPI_Alltoall of per-peer counts: ``send_counts
    (R, R)`` (what rank b sends each peer) → ``(R, R)`` (what each peer
    sends rank b)."""
    return comm.all_to_all(send_counts[:, :, None]).reshape(send_counts.shape)


def exchange_padded(
    packed: torch.Tensor,  # (R, C, W) UNSORTED packed payload
    perm: torch.Tensor,  # (R, C) destination-sort permutation
    send_counts: torch.Tensor,  # (R, R) valid-destination counts
    *,
    comm: StackedCollectives,
    num_ranks: int,
    capacity: int,
    peer_capacity: int,
    marshal: str = "sort",
    dest_clean: Optional[torch.Tensor] = None,
    dest_rank: Optional[torch.Tensor] = None,
    overflow: str = "drop",
    age: Optional[torch.Tensor] = None,  # (R, C) retain: rounds each lane has waited
    telemetry: bool = False,
    telemetry_buckets: int = 8,
    pipeline_shards: int = 1,
    on_stage: Optional[Callable[[str], None]] = None,
    flow: str = "open",
    credits: Optional[torch.Tensor] = None,  # (R, R) credit: carried adverts, one round stale
    credit_reserve: int = 0,  # credit: receive rows withheld from adverts
    digits: Optional[Tuple[int, ...]] = None,
    tier: Optional[int] = None,
):
    """Padded-slot exchange, ``[CreditGate →] SpillExtract → Marshal →
    CountExchange → PayloadExchange → Unmarshal``.  Returns ``(recv_packed
    (R, capacity, W), recv_counts (R, R), new_count (R,), drops (R,),
    pending, credits_out, stats)``; under retain ``pending`` is the sender
    clamp's one spill block and ``drops`` only the receiver-side admission
    cut.  With ``pipeline_shards=S > 1`` the Marshal → … → Unmarshal chain
    runs S times over slot-row micro-shards (the gate and the spill stay
    outside the shard loop).  With ``telemetry`` the stats record the
    per-peer send counts as the segment demand against ``peer_capacity``
    (and, under credit, ``credits_granted = Σ min(grant, S)``).
    ``on_stage`` is passed to :func:`core.stages.compose` (shards mark
    ``"Stage#k"``).  With ``digits`` and ``tier`` the ``num_ranks`` peers
    are each rank's tier-``tier`` group and both calls are tier calls."""
    R, S = num_ranks, peer_capacity
    retain = overflow == "retain"
    credit = flow == "credit"
    st = ST.RoundState(
        packed=packed, perm=perm, send_counts=send_counts, marshal=marshal,
        dest_clean=dest_clean, dest_rank=dest_rank, retain=retain,
        age=_fresh_age(packed) if retain and age is None else age,
        flow=flow, credits=credits,
        # a tier-scoped round's peers are digit lanes: only a flat one has ranks
        ranks=comm.ranks(R, packed.device) if digits is None else None,
    )
    inner = (
        ST.Marshal(R, S, shards=pipeline_shards),
        ST.CountExchange(comm, digits=digits, tier=tier),
        ST.PayloadExchange(comm, digits=digits, tier=tier),
        ST.Unmarshal(capacity, shards=pipeline_shards, slot=S),
    )
    if pipeline_shards > 1:
        inner = (ST.Pipelined(inner, pipeline_shards, on_stage=on_stage),)
    head = (ST.CreditGate(R),) if credit else ()
    st = ST.compose(*head, ST.SpillExtract(R, capacity, S, retain=retain, reserve=credit_reserve), *inner,
                    on_stage=on_stage)(st)
    stats = None
    if telemetry:
        stats = TS.single_tier_stats(
            send_counts, S, telemetry_buckets,
            sent_rows=st.clamped.sum(dim=1, dtype=torch.int32), stage_drops=st.send_drops,
            recv_total=st.recv_counts.sum(dim=1, dtype=torch.int32), recv_drops=st.recv_drops,
            rows_held=st.stage_held if retain else None,
            credits_granted=torch.clamp(st.credit_allow, max=S).sum(dim=1, dtype=torch.int32) if credit else None,
        )
    drops = st.send_drops + st.recv_drops
    return st.out, st.recv_counts, st.new_count, drops, tuple(st.pending), st.credits_out if credit else None, stats


def exchange_ragged(
    packed: torch.Tensor,  # (R, C, W) UNSORTED packed payload
    perm: Optional[torch.Tensor],  # (R, C) destination-sort permutation
    send_counts: torch.Tensor,  # (R, R) valid-destination counts
    *,
    comm: StackedCollectives,
    num_ranks: int,
    capacity: int,
    marshal: str = "sort",
    dest_clean: Optional[torch.Tensor] = None,
    dest_rank: Optional[torch.Tensor] = None,
    overflow: str = "drop",
    age: Optional[torch.Tensor] = None,
    telemetry: bool = False,
    telemetry_buckets: int = 8,
    pipeline_shards: int = 1,
    on_stage: Optional[Callable[[str], None]] = None,
    flow: str = "open",
    credits: Optional[torch.Tensor] = None,  # (R, R) credit: carried adverts, one round stale
    credit_reserve: int = 0,
):
    """The ``ragged_all_to_all`` exchange (the reference's ``exchange_ragged``).

    The count ``all_gather`` of the ``(R, R)`` send counts is the whole
    control plane: every rank derives every rank's clamps and landing
    offsets from the replicated matrix (``stages.ragged_control_plane``,
    the receiver queue as the only clamp, cut in source order).  The
    payload is placed once in destination order (``stages.
    ragged_send_buffer``: K1 through the sort permutation, or K5 to
    ``off[d] + rank``) and ships in ONE ``ragged_all_to_all`` that lands
    the rows compacted.  The sender owns the drop accounting: in drop mode
    ``drops`` is the control plane's cut of the rank's own row.

    Retain: the rows past each segment's allowance come back as one spill
    block (``stages.lanes_spill``), and the arrivals land straight behind
    its front (``output_offsets + front``, cut at ``capacity``), the same
    bits on every lane below the count as the reference's landing at 0 and
    shifting after, with one pass fewer.  Credit (under retain): the grant
    ``credit_grant(credits)`` gates the counts BEFORE the gather, which
    widens by one int32 column carrying each rank's own-entry advert; the
    rank's fresh advert then replaces its own entry of ``credits_out``.
    ``pipeline_shards=S``: shard ``k`` ships rows ``[k·capacity/S,
    (k+1)·capacity/S)`` of every segment, each shard with its own count
    ``all_gather`` (S payload and S count calls); the marshal stays one
    pass.  Telemetry: the segment demand is the count matrix's column
    totals, replicated on every rank (totals ×R, the reference's
    population), ``recv_drops`` the receiver-admission cut.

    Returns ``(recv_packed (R, capacity, W), recv_sizes (R, R), new_count
    (R,), drops (R,), pending, credits_out, stats)``.  ``on_stage`` is
    called after ``CountExchange``, ``SpillExtract`` (retain), ``Marshal``
    and ``PayloadExchange`` (``"PayloadExchange#k"`` and, for k > 0,
    ``"CountExchange#k"`` when sharded)."""
    R = num_ranks
    B, C, _W = packed.shape
    if B != comm.local_ranks(R):
        raise ValueError(f"exchange_ragged runs over the whole rank axis: {B} rows for {R} ranks")
    mark = on_stage or (lambda name: None)
    retain, credit = overflow == "retain", flow == "credit"
    me = comm.ranks(R, packed.device)
    off = ST._excl_cumsum(send_counts, 1)
    send_gated, credits_out, grant = send_counts, None, None
    if credit:
        grant = ST.credit_grant(credits, R, me)
        send_gated = torch.minimum(send_counts, grant)
        # the count call widened by one column: each rank's own-entry advert
        own = torch.gather(credits, 1, me[:, None]).to(send_gated.dtype)
        gath = comm.all_gather(torch.cat([send_gated, own], dim=1))  # (B_me, R_src, R + 1)
        cnt, credits_out = gath[0, :, :R], gath[:, :, R].to(torch.int32)
    else:
        cnt = comm.all_gather(send_counts)[0]
    # every rank holds the same matrix: the replicated layout is derived
    # once, and each rank reads its own rows of it
    ss_all, oo_all, rs_all = ST.ragged_control_plane(cnt, capacity)
    send_sizes, recv_sizes = comm.local(ss_all), comm.local(rs_all)
    mark("CountExchange")
    send_drops = (send_counts - send_sizes).sum(dim=1, dtype=torch.int32)
    pending, front = (), None
    if retain:
        pending = (ST.lanes_spill(
            packed, perm, _fresh_age(packed) if age is None else age, send_sizes, send_counts - send_sizes,
            off + send_sizes, send_drops, num_ranks=R, marshal=marshal, dest_clean=dest_clean,
            dest_rank=dest_rank,
        ),)
        front = torch.clamp(send_drops, max=capacity)
        held = send_drops
        if credit:
            fresh = ST._fresh_advert(capacity - front, credit_reserve, R)
            mine = me[:, None] == torch.arange(R, device=packed.device)[None, :]
            credits_out = torch.where(mine, fresh[:, None], credits_out)
        send_drops = torch.zeros_like(send_drops)
        mark("SpillExtract")
    sorted_packed = ST.ragged_send_buffer(
        packed, perm, send_counts, num_ranks=R, marshal=marshal, dest_clean=dest_clean, dest_rank=dest_rank,
    )
    mark("Marshal")
    chunk = capacity // pipeline_shards
    out = None
    for k in range(pipeline_shards):
        ss, oo = ss_all, oo_all
        if k > 0:
            # shard k's own count call, as the reference issues it (the
            # counts do not change between shards)
            ss, oo, _rs = ST.ragged_control_plane(comm.all_gather(send_gated)[0], capacity)
            mark(f"CountExchange#{k}")
        lo = torch.clamp(ss, max=k * chunk)
        size = torch.clamp(ss - k * chunk, 0, chunk)
        land = comm.local(oo + lo, 1)  # (R_src, B_dst): where each block lands on my ranks
        if front is not None:
            # land behind the receiver's spill front; the lanes stop at
            # capacity, which cuts a block that would run past it
            land = land + front[None, :]
        out = comm.ragged_all_to_all(
            sorted_packed, out, input_offsets=off + comm.local(lo), send_sizes=comm.local(size),
            output_offsets=land, recv_sizes=comm.local(size.transpose(0, 1)), capacity=capacity,
        )
        mark("PayloadExchange" if pipeline_shards == 1 else f"PayloadExchange#{k}")
    new_count = recv_sizes.sum(dim=1, dtype=torch.int32)
    recv_cut = torch.zeros_like(new_count)
    if retain:
        admitted = torch.minimum(new_count, capacity - front)
        recv_cut, new_count = new_count - admitted, admitted
    stats = None
    if telemetry:
        col_demand = cnt.sum(dim=0, dtype=torch.int32)  # (R,), the same on every rank
        stats = TS.single_tier_stats(
            col_demand.expand(B, R), capacity, telemetry_buckets,
            sent_rows=send_sizes.sum(dim=1, dtype=torch.int32), stage_drops=send_drops,
            recv_total=comm.local(col_demand), recv_drops=recv_cut,
            rows_held=held if retain else None,
            credits_granted=torch.minimum(grant, send_counts).sum(dim=1, dtype=torch.int32) if credit else None,
        )
    return out, recv_sizes, new_count, send_drops + recv_cut, pending, credits_out, stats


def _fresh_age(packed: torch.Tensor) -> torch.Tensor:
    return torch.zeros(packed.shape[:2], dtype=torch.int32, device=packed.device)


def exchange_hierarchical(
    packed: torch.Tensor,  # (R, C, W) UNSORTED packed payload
    perm: torch.Tensor,  # (R, C) lexicographic destination-sort permutation
    send_counts: torch.Tensor,  # (R, R) valid-destination counts, slowest-major
    *,
    comm: StackedCollectives,
    num_ranks: int,
    capacity: int,
    level_sizes: Tuple[int, ...],  # ranks per tier, slowest first
    level_capacities: Tuple[int, ...],  # padded rows per peer segment, per tier
    marshal: str = "sort",
    dest_clean: Optional[torch.Tensor] = None,
    dest_rank: Optional[torch.Tensor] = None,
    overflow: str = "drop",
    age: Optional[torch.Tensor] = None,
    telemetry: bool = False,
    telemetry_buckets: int = 8,
    pipeline_shards: int = 1,
    on_stage: Optional[Callable[[str], None]] = None,
    flow: str = "open",
    credits: Optional[torch.Tensor] = None,
    credit_reserve: int = 0,
):
    """N-stage packed exchange over the tier layout ``level_sizes``.

    Stage ``l`` (fastest first, extent-1 tiers skipped) combines traffic
    within tier ``l``: each rank ships, per peer ``j`` on the tier, its
    sub-segments whose destination digit ``d_l == j``, in buffer order, so
    every item lands on a rank whose digit ``l`` equals its destination's.
    The first non-trivial stage is the round's single local payload pass
    (the sort permutation composed into its gather, or the scatter straight
    into its slots); every stage's counts derive from the one histogram and
    the per-stage count collectives.  Returns ``(recv_packed, recv_counts,
    new_count, drops, pending, stats)``; ``recv_counts`` are per source
    group of the last stage.  ``on_stage(name)``, if given, is called after
    each stage with its class name and tier, e.g. ``"Marshal@1"`` (or
    ``"Marshal#0@1"`` for shard 0 of a pipelined tier).

    With ``overflow="retain"`` every stage clamp parks its cut rows where
    they sit: the first stage spills input lanes (ages carried forward),
    later stages park mid-route buffer rows re-addressed through
    ``seg_dest`` (ages restart at 1).  One pending block per non-trivial
    stage; the final compaction lands the arrivals behind them.

    With ``flow="credit"`` the carried ``credits`` gate the route's FIRST
    clamp, so a saturated destination throttles every tier at the source
    and the un-granted tail parks in the sender's first spill block.  Each
    tier's count call carries the minimum estimate of the sender's subtree
    on that tier (the final tier folds in the rank's fresh post-spill room
    first), fanned back over the subtree by the receiver;
    ``credits_granted`` is recorded at the first tier only.

    With ``pipeline_shards=S > 1`` each tier's Marshal → CountExchange →
    PayloadExchange chain runs S times over ``level_capacities[l]/S``-row
    micro-shards; non-final tiers reassemble the bulk stage buffer
    (``stages.Reassemble``), the final tier's shards compact straight into
    the queue.  With ``telemetry`` tier ``l``'s segment demand is the
    pre-clamp row total per peer slot column of stage ``l``, after the
    faster tiers' clamps, recorded at its ``level_sizes`` index (extent-1
    tiers stay zero)."""
    level_sizes = tuple(int(a) for a in level_sizes)
    R = num_ranks
    B, C, W = packed.shape
    retain = overflow == "retain"
    credit = flow == "credit"
    tiers = [l for l in reversed(range(len(level_sizes))) if level_sizes[l] > 1]
    rec = TS.make_stats(len(level_sizes), telemetry_buckets, num_ranks=B, device=packed.device) if telemetry else None
    st = ST.RoundState(
        packed=packed, perm=perm, send_counts=send_counts, marshal=marshal,
        dest_clean=dest_clean, dest_rank=dest_rank, retain=retain,
        age=_fresh_age(packed) if retain and age is None else age,
        flow=flow, credits=credits, ranks=comm.ranks(R, packed.device),
    )
    if credit:
        st = ST.CreditGate(R)(st)
    zero = torch.zeros(B, dtype=torch.int32, device=packed.device)
    st.spill_run, st.drops = zero, zero
    if retain:
        # which global destination sub-segment k of the current buffer
        # holds: the identity in sorted destination order, updated after
        # each non-final stage from digits every later-stage peer shares
        st.seg_dest = torch.arange(R, dtype=torch.int32, device=packed.device).repeat(B, 1)
    st.cnt = send_counts
    st.base = ST._excl_cumsum(send_counts, 1)
    st.buf, st.n_rows, st.via_perm = packed, C, True

    if not tiers:
        # a 1-rank layout: the round is a local compaction, no collectives
        allowed = torch.clamp(st.cnt, max=capacity)
        if marshal == "scatter":
            keep = (dest_clean < R) & (dest_rank < capacity)
            out = bs_ops.scatter_rows(packed, torch.where(keep, dest_rank, capacity), num_slots=capacity)
        else:
            rows = torch.gather(perm, 1, torch.arange(capacity, device=packed.device).clamp(0, C - 1).expand(B, -1))
            out = marshal_ops.fused_marshal(packed, rows, num_ranks=1, slot=capacity)[:, 0]
        drops = (st.cnt - allowed).sum(dim=1, dtype=torch.int32)
        if telemetry:  # no stage ran: only the local compaction is observable
            rec = dataclasses.replace(rec, recv_total=st.cnt.sum(dim=1, dtype=torch.int32), recv_drops=drops)
        credits_out = (capacity - allowed).to(torch.int32) if credit else None
        return out, allowed, allowed[:, 0], drops, (), credits_out, rec

    shards = pipeline_shards
    for i, l in enumerate(tiers):
        A, S = level_sizes[l], level_capacities[l]
        final = i == len(tiers) - 1
        mark = None if on_stage is None else (lambda name, l=l: on_stage(f"{name}@{l}"))
        st = ST.compose(ST.SpillExtract(R, capacity, S, retain=retain, kind="tier", extent=A), on_stage=mark)(st)
        if telemetry:
            _record_tier(rec, st, l, A, S, telemetry_buckets, retain)
            if credit and i == 0:
                rec.credits_granted[:, l] = torch.clamp(st.credit_allow, max=S).sum(dim=1, dtype=torch.int32)
        chain = (
            ST.Marshal(A, S, shards=shards, kind="tier", num_ranks=R),
            # final stage: per-source-group totals suffice — blocks are
            # contiguous prefixes, compacted straight into the receive
            # queue; other stages ship the per-sub-segment survivors
            ST.CountExchange(comm, kind="final" if final else "tier", digits=level_sizes, tier=l,
                             shards=shards, slot=S, num_ranks=R, capacity=capacity,
                             reserve=credit_reserve if final else 0),
            ST.PayloadExchange(comm, digits=level_sizes, tier=l, collect=shards > 1 and not final),
        )
        if final:
            chain += (ST.Unmarshal(capacity, shards=shards, slot=S, kind="final"),)
        if shards > 1:
            chain = (ST.Pipelined(chain, shards, on_stage=mark),) + (() if final else (ST.Reassemble(A, S),))
        if not final:
            chain += (ST.AdvanceTier(A, S, level_sizes, l, retain=retain),)
        st = ST.compose(*chain, on_stage=mark)(st)
    if telemetry:
        # wasted wire: every row discarded after crossing a wire — the
        # receiver cut plus the stage clamps past the first hop (zero under
        # retain, where the later stages hold instead of dropping)
        late = sum((rec.stage_drops[:, j] for j in tiers[1:]), torch.zeros_like(st.recv_drops))
        rec = dataclasses.replace(
            rec, recv_total=st.recv_counts.sum(dim=1, dtype=torch.int32),
            recv_drops=st.recv_drops.to(torch.int32), wasted_wire_rows=(st.recv_drops + late).to(torch.int32),
        )
    credits_out = st.credits_out if credit else None
    return st.out, st.recv_counts, st.new_count, st.drops + st.recv_drops, tuple(st.pending), credits_out, rec


def _record_tier(rec, st, l: int, A: int, S: int, buckets: int, retain: bool) -> None:
    """Fill tier ``l``'s row of ``rec`` right after its clamp: the segment
    demand is the pre-clamp rows per peer slot column."""
    B = st.cnt.shape[0]
    col = st.cnt.reshape(B, -1, A).sum(dim=1, dtype=torch.int32)  # (B, A)
    rec.demand_hist[:, l] = TS.occupancy_histogram(col, S, buckets)
    rec.demand_max[:, l] = col.amax(dim=1)
    rec.demand_total[:, l] = col.sum(dim=1, dtype=torch.int32)
    rec.sent_rows[:, l] = st.allowed.sum(dim=(1, 2), dtype=torch.int32)
    rec.stage_drops[:, l] = st.stage_drops
    if retain:
        rec.rows_held[:, l] = st.stage_held


def exchange_onehot(
    packed: torch.Tensor,
    perm: torch.Tensor,
    send_counts: torch.Tensor,
    *,
    comm: StackedCollectives,
    num_ranks: int,
    capacity: int,
    marshal: str = "sort",
    dest_clean: Optional[torch.Tensor] = None,
    dest_rank: Optional[torch.Tensor] = None,
    overflow: str = "drop",
    age: Optional[torch.Tensor] = None,
    telemetry: bool = False,
    telemetry_buckets: int = 8,
):
    """All-gather reference oracle: every rank sees every rank's sorted
    queue, selects what is addressed to it, and compacts stably by
    (source, lane).  In scatter mode the queue is placed into sorted order
    with kernel K5's ``scatter_rows`` (the only step that differs).  No
    sender clamp exists, so a retain round's spill plan is empty; the
    receiver clamp stays a counted drop.  Same returns as
    :func:`exchange_padded`; its stats record the per-destination send
    counts against the receiver queue, the only clamp it has."""
    del overflow, age
    R = num_ranks
    rows, cap, w = packed.shape
    dev = packed.device
    if marshal == "scatter":
        off = torch.cumsum(send_counts, dim=1, dtype=torch.int32) - send_counts
        pos = torch.gather(off, 1, dest_clean.clamp(0, R - 1).to(torch.int64)) + dest_rank
        sorted_packed = bs_ops.scatter_rows(packed, torch.where(dest_clean < R, pos, cap), num_slots=cap)
    else:
        sorted_packed = torch.gather(packed, 1, perm.to(torch.int64)[:, :, None].expand(-1, -1, w))
    lane = torch.arange(cap, dtype=torch.int32, device=dev)
    # per-item dest from the segments: dest[i] = r iff off[r] <= i < off[r] + cnt[r]
    seg_end = torch.cumsum(send_counts, dim=1, dtype=torch.int32)
    dest = (lane[None, :, None] >= seg_end[:, None, :]).sum(dim=2, dtype=torch.int32)
    dest = torch.where(lane[None, :] < seg_end[:, -1:], dest, R)

    all_packed = comm.all_gather(sorted_packed)  # (R_me, R_src, C, W)
    all_dest = comm.all_gather(dest)  # (R_me, R_src, C)
    me = comm.ranks(R, dev).to(torch.int32)[:, None, None]
    mine = (all_dest == me).reshape(rows, R * cap)
    # mine first, stable (source, lane) order
    order = torch.sort((~mine).to(torch.int8), dim=1, stable=True).indices[:, :capacity]
    flat = all_packed.reshape(rows, R * cap, w)
    gathered = torch.gather(flat, 1, order[:, :, None].expand(-1, -1, w))
    total = mine.sum(dim=1, dtype=torch.int32)
    new_count = torch.clamp(total, max=capacity)
    recv_counts = (all_dest == me).sum(dim=2, dtype=torch.int32)
    stats = None
    if telemetry:
        stats = TS.single_tier_stats(
            send_counts, capacity, telemetry_buckets,
            sent_rows=send_counts.sum(dim=1, dtype=torch.int32), stage_drops=torch.zeros_like(total),
            recv_total=total, recv_drops=total - new_count,
        )
    return gathered, recv_counts, new_count, total - new_count, (), None, stats

