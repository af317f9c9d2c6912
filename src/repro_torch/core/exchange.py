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
* ``onehot`` — the all-gather reference oracle, a deliberately different
  code path used by the tests and the chip smoke run.

All take either marshal plan: ``marshal="sort"`` with the destination-sort
``perm``, or ``marshal="scatter"`` with the bucket plan ``dest_clean`` /
``dest_rank`` (``perm`` is then None).

Budget per round: 1 payload ``all_to_all`` + 1 count ``all_to_all`` on
``padded``, one of each per non-trivial tier on ``hierarchical`` (recorded
by ``core.collectives``).  Segment overflow — sender-side, tier-side or
receiver-side — is dropped and counted exactly once.  Every backend returns
``(recv_packed, recv_counts, new_count, drops, pending)``.  With
``overflow="retain"`` ``pending`` holds the spill blocks ``(rows, dest, age,
n)`` of every sender or tier clamp (the rows it would have cut, compacted,
with their global destination and aged counter), and the receive compaction
lands the arrivals behind them; otherwise it is empty.  The onehot oracle
has no sender clamp, so its plan is empty by construction.  ``ragged``
comes later (ROADMAP Queue 1 item 16).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import stages as ST
from repro_torch.core.collectives import StackedCollectives
from repro_torch.kernels.bucket_scatter import ops as bs_ops
from repro_torch.kernels.marshal import ops as marshal_ops

__all__ = ["exchange_counts", "exchange_hierarchical", "exchange_onehot", "exchange_padded"]


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
    on_stage: Optional[Callable[[str], None]] = None,
):
    """Padded-slot exchange.  Returns ``(recv_packed (R, capacity, W),
    recv_counts (R, R), new_count (R,), drops (R,), pending)``; under retain
    ``pending`` is the sender clamp's one spill block and ``drops`` only the
    receiver-side admission cut.  ``on_stage`` is passed to
    :func:`core.stages.compose`."""
    R, S = num_ranks, peer_capacity
    retain = overflow == "retain"
    st = ST.RoundState(
        packed=packed, perm=perm, send_counts=send_counts, marshal=marshal,
        dest_clean=dest_clean, dest_rank=dest_rank, retain=retain,
        age=_fresh_age(packed) if retain and age is None else age,
    )
    st = ST.compose(
        ST.SpillExtract(R, capacity, S, retain=retain),
        ST.Marshal(R, S),
        ST.CountExchange(comm),
        ST.PayloadExchange(comm),
        ST.Unmarshal(capacity),
        on_stage=on_stage,
    )(st)
    return st.out, st.recv_counts, st.new_count, st.send_drops + st.recv_drops, tuple(st.pending)


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
    on_stage: Optional[Callable[[str], None]] = None,
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
    new_count, drops, pending)``; ``recv_counts`` are per source group of
    the last stage.  ``on_stage(name)``, if given, is called after each
    stage with its class name and tier, e.g. ``"Marshal@1"``.

    With ``overflow="retain"`` every stage clamp parks its cut rows where
    they sit: the first stage spills input lanes (ages carried forward),
    later stages park mid-route buffer rows re-addressed through
    ``seg_dest`` (ages restart at 1).  One pending block per non-trivial
    stage; the final compaction lands the arrivals behind them."""
    level_sizes = tuple(int(a) for a in level_sizes)
    R = num_ranks
    B, C, W = packed.shape
    retain = overflow == "retain"
    tiers = [l for l in reversed(range(len(level_sizes))) if level_sizes[l] > 1]
    st = ST.RoundState(
        packed=packed, perm=perm, send_counts=send_counts, marshal=marshal,
        dest_clean=dest_clean, dest_rank=dest_rank, retain=retain,
        age=_fresh_age(packed) if retain and age is None else age,
    )
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
        return out, allowed, allowed[:, 0], drops, ()

    for i, l in enumerate(tiers):
        A, S = level_sizes[l], level_capacities[l]
        mark = None if on_stage is None else (lambda name, l=l: on_stage(f"{name}@{l}"))
        head = (ST.SpillExtract(R, capacity, S, retain=retain, kind="tier", extent=A),
                ST.Marshal(A, S, kind="tier", num_ranks=R))
        if i == len(tiers) - 1:
            # final stage: per-source-group totals suffice — blocks are
            # contiguous prefixes, compacted straight into the receive queue
            st = ST.compose(
                *head,
                ST.CountExchange(comm, kind="final", digits=level_sizes, tier=l),
                ST.PayloadExchange(comm, digits=level_sizes, tier=l),
                ST.Unmarshal(capacity, kind="final"),
                on_stage=mark,
            )(st)
            return st.out, st.recv_counts, st.new_count, st.drops + st.recv_drops, tuple(st.pending)
        st = ST.compose(
            *head,
            ST.CountExchange(comm, kind="tier", digits=level_sizes, tier=l),
            ST.PayloadExchange(comm, digits=level_sizes, tier=l),
            ST.AdvanceTier(A, S, level_sizes, l, retain=retain),
            on_stage=mark,
        )(st)


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
):
    """All-gather reference oracle: every rank sees every rank's sorted
    queue, selects what is addressed to it, and compacts stably by
    (source, lane).  In scatter mode the queue is placed into sorted order
    with kernel K5's ``scatter_rows`` (the only step that differs).  No
    sender clamp exists, so a retain round's spill plan is empty; the
    receiver clamp stays a counted drop.  Same returns as
    :func:`exchange_padded`."""
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
    me = torch.arange(rows, dtype=torch.int32, device=dev)[:, None, None]
    mine = (all_dest == me).reshape(rows, R * cap)
    # mine first, stable (source, lane) order
    order = torch.sort((~mine).to(torch.int8), dim=1, stable=True).indices[:, :capacity]
    flat = all_packed.reshape(rows, R * cap, w)
    gathered = torch.gather(flat, 1, order[:, :, None].expand(-1, -1, w))
    total = mine.sum(dim=1, dtype=torch.int32)
    new_count = torch.clamp(total, max=capacity)
    recv_counts = (all_dest == me).sum(dim=2, dtype=torch.int32)
    return gathered, recv_counts, new_count, total - new_count, ()

