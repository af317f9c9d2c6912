"""Per-stage timing of one forwarding round over rank-stacked tensors (the
counterpart of ``repro.obs.phases``, with its phase keys).

Each stage of the exchange is rebuilt as a STANDALONE call over the port's
production primitives (``stages.padded_send_buffer`` with its sort plan
through K3 or its scatter plan through K4, ``exchange.exchange_counts``,
``StackedCollectives.all_to_all``, ``stages.compact_blocks`` (K2) and
``stages.compact_shard``) and timed on its own: the sum can exceed the
fused round, whose stages share their inputs; the split shows WHERE the
time goes.  A stage's inputs are built on the device before its timed
calls, from the reference's setup law (``(me·7 + lane·131) % R``
destinations, lane-valued leaves), so the timed window holds the stage and
no host-to-device copy.  A marshal phase holds the send side as the round
runs it: pack, plan and the payload pass (the reference's also builds the
queue, which here is an input).

The phase keys:

* flat padded, ``pipeline_shards=1``:
  ``marshal`` / ``count_collective`` / ``payload_collective`` / ``unmarshal``
* flat padded, ``pipeline_shards=S>1``: the bulk four plus per-shard
  ``shard{k}_marshal`` / ``shard{k}_payload_collective`` /
  ``shard{k}_unmarshal`` (each shard's count call ships the full vector, so
  there is one ``count_collective`` key).
* hierarchical: per tier ``tier{l}_marshal`` / ``tier{l}_count_collective``
  / ``tier{l}_payload_collective`` for every tier ``l`` of extent above 1
  (fastest first), plus the final ``unmarshal``.
* ragged: ``marshal`` (pack, plan and the one payload pass into
  destination order, ``stages.ragged_send_buffer``) / ``count_collective``
  (the one count ``all_gather`` and the replicated control plane,
  ``stages.ragged_control_plane``) / ``payload_collective`` (one
  ``StackedCollectives.ragged_all_to_all`` of equal segments).

:func:`to_perfetto` lays the measured durations out as a merged multi-rank
Perfetto timeline, one process track per rank and one thread track per
tier, the layout of ``obs.trace``.

With ``comm=`` a ``DistributedCollectives`` every phase runs on the
process's block of ranks (inputs built from the global ids of
``comm.ranks``) through that backend: each process times its own block,
and the phase list, the calls a phase makes and its launches are the
stacked run's, per process.  Every process must time the same phases
with the same number of calls.
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.core import stages as ST
from repro_torch.core import types as T
from repro_torch.core.collectives import backend
from repro_torch.core.exchange import exchange_counts
from repro_torch.core.queue import enqueue, make_queue
from repro_torch.kernels.bucket_scatter import ops as bs_ops
from repro_torch.kernels.sort_keys import ops as sk_ops
from repro_torch.obs import trace as OT

__all__ = ["profile_phases", "to_perfetto", "tier_of_phase"]


def _default_timeit(fn: Callable, x, *, warmup: int = 2, iters: int = 5):
    """Median of ``iters`` timings in µs after ``warmup`` calls: CUDA events
    around each call on the card, ``time.perf_counter`` on the CPU."""
    out = None
    for _ in range(warmup):
        out = fn(x)
    times = []
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
        for _ in range(iters):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(x)
            times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times), out


def _fill_items(proto: Any, num_ranks: int, n_emit: int, device):
    """Lane-valued leaves of the proto's shapes, ``(R, n_emit, ...)``
    (values do not matter for timing)."""
    lane = torch.arange(n_emit, device=device)

    def leaf(a):
        x = lane.to(a.dtype).reshape((1, n_emit) + (1,) * a.dim())
        return x.expand((num_ranks, n_emit) + tuple(a.shape)).contiguous()

    return T.tree_map(leaf, proto)


def profile_phases(
    cfg: Any,
    *,
    n_emit: int,
    cap: int,
    proto: Any,
    timeit: Optional[Callable] = None,
    device=None,
    comm=None,
) -> Dict[str, float]:
    """Time each stage of one ``cfg`` forwarding round standalone; returns
    ``{phase_key: us}`` (module docstring for the keys).  ``timeit(fn, x)
    -> (us, out)`` times one phase; ``x`` is the ``(L, 1)`` tensor of the
    process's rank ids each phase's call takes.  ``device=None`` is the
    CUDA card; ``comm`` the backend (None: a ``StackedCollectives``)."""
    dev = compat.resolve_device(device)
    if timeit is None:
        timeit = _default_timeit
    comm = backend(comm)
    me = comm.ranks(cfg.num_ranks, dev)[:, None]  # (L, 1) global rank ids
    if cfg.exchange == "padded":
        q, words = _setup(cfg, n_emit, cap, proto, dev, me)
        phases = _padded_phases(cfg, comm, me, q, words, cap, dev)
        if cfg.pipeline_shards > 1:
            phases += _pipelined_phases(cfg, comm, me, q, words, cap, dev)
    elif cfg.exchange == "hierarchical":
        phases = _hierarchical_phases(cfg, comm, me, n_emit, cap, proto, dev)
    elif cfg.exchange == "ragged":
        q, words = _setup(cfg, n_emit, cap, proto, dev, me)
        phases = _ragged_phases(cfg, comm, me, q, words, n_emit, cap, dev)
    else:
        raise ValueError(
            f"profile_phases supports padded/hierarchical/ragged rounds, "
            f"got exchange={cfg.exchange!r}"
        )
    x = me.to(torch.int32)
    return {key: timeit(fn, x)[0] for key, fn in phases}


def _setup(cfg, n_emit, cap, proto, dev, me=None):
    """The shared emission: a filled queue with the reference's scattered
    destination law, and its packed payload's word count (the ranks of
    ``me``, the ``(L, 1)`` global ids; None: every rank)."""
    R = cfg.num_ranks
    me = torch.arange(R, device=dev)[:, None] if me is None else me
    L = me.shape[0]
    lane = torch.arange(n_emit, device=dev)[None, :]
    dest = ((me * 7 + lane * 131) % R).to(torch.int32)
    q = make_queue(proto, cap, num_ranks=L, device=dev)
    q = enqueue(q, _fill_items(proto, L, n_emit, dev), dest, torch.ones(L, n_emit, dtype=torch.bool, device=dev))
    return q, T.pack_spec(proto).total_words


def _send_side(cfg, q, **shard):
    """Pack, plan and the send-side payload pass of the flat round (the
    plan through K3 (sort) or K4 (scatter), as ``forward_work`` plans)."""
    R = cfg.num_ranks
    packed, _spec = T.pack_payload(q.items, batch_dims=2)
    perm = dest_clean = dest_rank = None
    if cfg.marshal == "scatter":
        dest_clean, dest_rank, hist = bs_ops.rank_and_histogram(q.dest, q.count, num_ranks=R)
    else:
        perm, _sorted, hist = sk_ops.sort_permutation(q.dest, q.count, R)
    if cfg.exchange == "ragged":
        return ST.ragged_send_buffer(packed, perm, hist[:, :R], num_ranks=R, marshal=cfg.marshal,
                                     dest_clean=dest_clean, dest_rank=dest_rank)
    return ST.padded_send_buffer(
        packed, perm, hist[:, :R], num_ranks=R, peer_capacity=cfg.peer_capacity, marshal=cfg.marshal,
        dest_clean=dest_clean, dest_rank=dest_rank, **shard,
    )


def _words(me: torch.Tensor, shape, dev) -> torch.Tensor:
    """``(L, *shape)`` int32 words, rank-varying: ``me + arange`` (``me``
    the ``(L, 1)`` global rank ids)."""
    n = math.prod(shape)
    me = me.to(torch.int32)
    return (me + torch.arange(n, dtype=torch.int32, device=dev)[None, :]).reshape((me.shape[0],) + tuple(shape))


def _block_counts(me: torch.Tensor, extent: int, slot: int, limit: int, dev) -> torch.Tensor:
    """``min((me + j) % slot, limit)`` for peer ``j``: ``(L, extent)`` int32."""
    j = torch.arange(extent, device=dev)[None, :]
    return torch.clamp((me + j) % slot, max=limit).to(torch.int32)


def _padded_phases(cfg, comm, me, q, words, cap, dev) -> Tuple:
    R, slot = cfg.num_ranks, cfg.peer_capacity
    counts = _block_counts(me, R, slot, slot, dev)
    buf = _words(me, (R, slot, words), dev)
    recv_counts = _block_counts(me, R, slot, cap // R, dev)
    return (
        ("marshal", lambda me: _send_side(cfg, q)),
        ("count_collective", lambda me: exchange_counts(counts, comm)),
        ("payload_collective", lambda me: comm.all_to_all(buf)),
        ("unmarshal", lambda me: ST.compact_blocks(buf, recv_counts, cap)),
    )


def _pipelined_phases(cfg, comm, me, q, words, cap, dev) -> Tuple:
    """Per-shard slices of the padded round (the overlap law's schedule):
    shard k marshals, ships and compacts slot rows ``[k·chunk,
    (k+1)·chunk)``, through ``padded_send_buffer(shards=, k=)`` and
    ``compact_shard`` (with its trash rows), the pipelined round's own
    primitives."""
    R, slot, S = cfg.num_ranks, cfg.peer_capacity, cfg.pipeline_shards
    chunk = slot // S  # config law: pipeline_shards divides peer_capacity
    buf = _words(me, (R, chunk, words), dev)
    recv_counts = _block_counts(me, R, slot, cap // R, dev)
    out = []
    for k in range(S):
        out += [
            (f"shard{k}_marshal", lambda me, k=k: _send_side(cfg, q, shards=S, k=k)),
            (f"shard{k}_payload_collective", lambda me: comm.all_to_all(buf)),
            (f"shard{k}_unmarshal",
             lambda me, k=k: ST.compact_shard(None, buf, recv_counts, cap, row_offset=k * chunk)),
        ]
    return tuple(out)


def _ragged_phases(cfg, comm, me, q, words, n_emit, cap, dev) -> Tuple:
    """The ragged round's three stages: the send side into destination
    order, the count ``all_gather`` with the replicated control plane
    (``(me + j) % (n_emit / R)`` rows toward peer ``j``), and one
    ``ragged_all_to_all`` of ``max(n_emit, R)`` rows a rank in R equal
    segments.  Unlike the reference's phase, which lands every sender's
    segment at the same receiver offsets, sender ``s``'s segment lands at
    ``s·seg`` on every receiver, so the timed call is a layout the op
    defines (disjoint landing intervals in source order)."""
    R = cfg.num_ranks
    counts = _block_counts(me, R, max(n_emit // R, 1), n_emit, dev)
    n = max(n_emit, R)
    buf = _words(me, (n, words), dev)
    whole = torch.full((R, R), n // R, dtype=torch.int32, device=dev)
    starts = ST._excl_cumsum(whole, 1)  # sender s's segment toward d starts at d·seg
    # the local ranks' rows of the sender tables, and their columns of the
    # landing table (sender s lands on d at s·seg)
    seg, off = comm.local(whole), comm.local(starts)
    land = off.T.contiguous()

    def count_collective(me):
        return ST.ragged_control_plane(comm.all_gather(counts)[0], cap)

    def payload_collective(me):
        return comm.ragged_all_to_all(buf, None, input_offsets=off, send_sizes=seg, output_offsets=land,
                                      recv_sizes=seg, capacity=n)

    return (
        ("marshal", lambda me: _send_side(cfg, q)),
        ("count_collective", count_collective),
        ("payload_collective", payload_collective),
    )


def _hierarchical_phases(cfg, comm, me, n_emit, cap, proto, dev) -> Tuple:
    """Per-tier marshal, count and payload phases of the N-level route, each
    over its tier's groups at that tier's (extent, segment capacity), plus
    the final receive compaction, which keys on the last stage's tier."""
    L = me.shape[0]
    level_sizes = tuple(int(a) for a in cfg.level_sizes)
    level_caps = tuple(int(c) for c in cfg.level_capacities)
    words = T.pack_spec(proto).total_words
    out = []
    tiers = [l for l in reversed(range(len(level_sizes))) if level_sizes[l] > 1]
    for l in tiers:
        A, S = level_sizes[l], level_caps[l]
        n = max(n_emit, A * S)
        rows = _words(me, (n, words), dev)
        perm = torch.arange(n, dtype=torch.int32, device=dev).expand(L, n)
        cnt = _block_counts(me, A, S, S, dev)
        buf = _words(me, (A, S, words), dev)

        def marshal_tier(me, rows=rows, perm=perm, cnt=cnt, A=A, S=S):
            # the tier's send-side pass: A sub-segments into (A, S) slots,
            # the flat marshal's primitive at the tier's shape
            return ST.padded_send_buffer(rows, perm, cnt, num_ranks=A, peer_capacity=S)

        out += [
            (f"tier{l}_marshal", marshal_tier),
            (f"tier{l}_count_collective",
             lambda me, cnt=cnt, l=l: comm.all_to_all(cnt[:, :, None], digits=level_sizes, tier=l)),
            (f"tier{l}_payload_collective",
             lambda me, buf=buf, l=l: comm.all_to_all(buf, digits=level_sizes, tier=l)),
        ]
    A, S = level_sizes[tiers[-1]], level_caps[tiers[-1]]
    buf = _words(me, (A, S, words), dev)
    recv_counts = _block_counts(me, A, S, cap // A, dev)
    out.append(("unmarshal", lambda me: ST.compact_blocks(buf, recv_counts, cap)))
    return tuple(out)


# ----------------------------------------------------------- timeline view
def tier_of_phase(key: str) -> int:
    """Tier index encoded in a phase key (``tier2_marshal`` → 2; flat and
    shard keys → 0)."""
    if key.startswith("tier"):
        return int(key[4:].split("_", 1)[0])
    return 0


def to_perfetto(
    phase_us: Dict[str, float], *, num_ranks: int, tag: str = "round",
    t0_us: float = 0.0,
) -> Dict[str, Any]:
    """Measured phase durations → a merged multi-rank Perfetto timeline:
    every rank runs the same round, so each rank's process track (``pid =
    rank``) carries the phase sequence laid end to end, on the thread track
    of the phase's tier (``tid = tier``).  Compose with a host
    ``obs.trace`` export by concatenating ``traceEvents``."""
    events = []
    for rank in range(num_ranks):
        t = t0_us
        for key, us in phase_us.items():
            events.append({
                "name": f"{tag}:{key}", "cat": OT.CAT_PHASE, "ph": "X",
                "ts": t, "dur": float(us), "rank": rank,
                "tier": tier_of_phase(key), "args": {"us": float(us)},
            })
            t += float(us)
    return OT.to_perfetto(events)
