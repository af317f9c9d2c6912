"""Ray-queue cycling — the paper's §6.3 alternative communication pattern.

"…the NVIDIA Barney renderer instead uses *ray queue cycling*, in which
every rank always communicates with exactly one other rank."  Instead of a
sorted all-to-all, the WHOLE queue migrates around the ring: each rank
absorbs the items addressed to it and passes the rest on.  A hop is one
``ppermute`` of the packed queue (and one of its count), the cheapest
collective there is, at the price of R hops for full delivery.

The ring is node-major (rank i sends to i + 1 on the stacked axis), so on a
multi-tier layout only the hops that wrap a group boundary cross a slower
tier; over a ``DistributedCollectives`` world only the hop from a process's
last rank to the next process's first crosses a process boundary.  A hop
packs the item payload AND the in-flight destination into one ``(R, C,
W+1)`` word buffer (``dest`` in the first word) and compacts the passing
rows in ONE payload pass, as ``cfg.marshal`` says: ``"sort"`` runs a
one-bucket key sort (kernel K3 and ``torch.sort``) and gathers through
the permutation (K1); ``"scatter"`` takes the passing mask's exclusive
prefix (K6) as the compacted position and scatters there (K5).  The
absorb is an ``enqueue`` (K6).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import types as T
from repro_torch.core.collectives import StackedCollectives, backend
from repro_torch.core.forwarding import ForwardConfig
from repro_torch.core.queue import DISCARD, WorkQueue, enqueue, make_queue
from repro_torch.kernels.bucket_scatter import ops as bs_ops
from repro_torch.kernels.compact import ops as compact_ops
from repro_torch.kernels.marshal import ops as marshal_ops
from repro_torch.kernels.sort_keys import ops as sk_ops
from repro_torch.obs import trace as OT
from repro_torch.telemetry import stats as TS

__all__ = ["cycle_step", "deliver_by_cycling"]


def cycle_step(q: WorkQueue, absorbed: WorkQueue, cfg: ForwardConfig, *, comm: Optional[StackedCollectives] = None):
    """One ring hop: every rank absorbs the items addressed to it and passes
    the rest to its ring successor.  Returns ``(in_flight_queue_after_hop,
    absorbed_queue)``, both of fixed capacity.

    With ``cfg.telemetry`` a ``RoundStats`` follows: a hop has ONE send
    segment (the whole passing queue), so the segment demand is the passing
    count against the queue capacity, and ``recv_drops`` records what the
    absorb enqueue overflowed (the ship itself loses nothing).

    With ``cfg.overflow == "retain"`` the absorb backpressures instead of
    dropping: items addressed to me that the absorbed queue has no room for
    stay in flight (re-offered every R hops); exactly the rows that fit are
    taken, front first."""
    if cfg.pipeline_shards > 1:
        raise ValueError(
            "cycling cannot micro-shard: a ring hop ships the WHOLE queue in "
            "one collective_permute (there is no per-peer segment to split), "
            f"so pipeline_shards={cfg.pipeline_shards} has nothing to overlap "
            "— use pipeline_shards=1 with the cycling pattern"
        )
    comm = backend(comm)
    C = q.capacity
    dev = q.dest.device
    me = comm.ranks(cfg.num_ranks, dev).to(torch.int32)[:, None]
    lane = torch.arange(C, device=dev)[None, :]
    valid = lane < q.count[:, None]
    mine = valid & (q.dest == me)
    if cfg.overflow == "retain":
        # absorb only what fits: the rest keeps cycling, nothing is dropped
        free = torch.clamp(absorbed.capacity - absorbed.count, min=0)
        m32 = mine.to(torch.int32)
        absorb_ok = mine & (torch.cumsum(m32, dim=1) - m32 < free[:, None])
    else:
        absorb_ok = mine
    passing = valid & ~absorb_ok

    absorb_drops0 = absorbed.drops
    absorbed = enqueue(absorbed, q.items, torch.where(absorb_ok, me, DISCARD), valid)

    items, spec = T.pack_payload(q.items, batch_dims=2)
    packed = torch.cat([q.dest.to(torch.int32)[:, :, None], items], dim=2)  # (R, C, W+1), dest first
    if cfg.marshal == "scatter":
        # sort-free stable compaction: the passing mask's exclusive prefix
        # is each row's compacted position (the 1-bucket counting sort)
        rank, n_pass = compact_ops.compact_positions(passing)
        packed_c = bs_ops.scatter_rows(packed, torch.where(passing, rank, C), num_slots=C)
    else:
        # passing rows key 0, the rest the DISCARD bucket: ONE key sort, ONE
        # payload gather for items and dest together
        fake_dest = torch.where(passing, 0, DISCARD).to(torch.int32)
        perm, _sorted, hist = sk_ops.sort_permutation(fake_dest, q.count, 1)
        n_pass = hist[:, 0]
        packed_c = marshal_ops.gather_rows(packed, perm)

    shipped = comm.ppermute(packed_c)
    shipped_count = comm.ppermute(n_pass)
    nq = WorkQueue(
        items=T.unpack_payload(shipped[:, :, 1:], spec),
        dest=shipped[:, :, 0].contiguous(),
        count=shipped_count.to(torch.int32),
        drops=q.drops,
    )
    if cfg.telemetry:
        stats = TS.single_tier_stats(
            n_pass[:, None], C, cfg.telemetry_buckets,
            sent_rows=n_pass, stage_drops=torch.zeros_like(n_pass),
            recv_total=shipped_count, recv_drops=absorbed.drops - absorb_drops0,
        )
        return nq, absorbed, stats
    return nq, absorbed


def deliver_by_cycling(q: WorkQueue, cfg: ForwardConfig, *, comm: Optional[StackedCollectives] = None):
    """Deliver every item by cycling the queue around the full ring — the
    Barney-style drop-in for one ``forward_work`` round.  The loop runs
    ``num_ranks`` hops (the last returns every undelivered row to its
    source).  Returns ``(absorbed_queue, total_delivered_globally)``; with
    ``cfg.telemetry`` also a ``StatsRing`` of one ``RoundStats`` a hop,
    whose window is ``num_ranks`` whatever ``telemetry_window`` says, so
    the whole trace survives.

    With ``cfg.overflow == "retain"`` the ring is lossless: the absorb
    backpressure keeps unabsorbable items in flight, and after the circuit
    the leftovers — each back at its source — are PARKED in the absorbed
    queue with their ``dest`` intact for the caller to re-offer.  Parking
    overflows only when a rank's absorbed queue is full, and is then
    counted in ``drops``."""
    if OT.enabled():
        OT.event(
            "route.deliver_by_cycling", OT.CAT_ROUTE,
            num_ranks=cfg.num_ranks, hops=cfg.num_ranks,
            overflow=cfg.overflow, telemetry=cfg.telemetry,
        )
    comm = backend(comm)
    if q.num_ranks != comm.local_ranks(cfg.num_ranks) or q.capacity != cfg.capacity:
        raise ValueError(
            f"queue is ({q.num_ranks}, {q.capacity}) but the config is "
            f"({cfg.num_ranks}, {cfg.capacity}) over a world of {comm.world} process(es)"
        )
    dev = q.dest.device
    proto = T.tree_map(lambda a: a[0, 0], q.items)
    absorbed = make_queue(proto, cfg.capacity, num_ranks=q.num_ranks, device=dev)
    ring = None
    if cfg.telemetry:
        ring = TS.make_ring(1, window=cfg.num_ranks, buckets=cfg.telemetry_buckets,
                            num_ranks=q.num_ranks, device=dev)
    for _hop in range(cfg.num_ranks):
        out = cycle_step(q, absorbed, cfg, comm=comm)
        q, absorbed = out[:2]
        if ring is not None:
            ring = TS.ring_push(ring, out[2])
    if cfg.overflow == "retain":
        lane = torch.arange(q.capacity, device=dev)[None, :]
        absorbed = enqueue(absorbed, q.items, q.dest, lane < q.count[:, None])
    total = comm.psum(absorbed.count)
    if ring is not None:
        return absorbed, total, ring
    return absorbed, total
