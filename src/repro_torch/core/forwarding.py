"""``forwardRays()`` — the RaFI §4.2 round over rank-stacked queues.

Per round, for all R ranks at once:

  1. marshal plan (§4.2.1).  ``marshal="sort"``: pack (dest, lane) keys and
     histogram them in one pass (kernel K3), sort the keys, keep only the
     permutation.  ``marshal="scatter"``: one counting pass (kernel K4)
     gives each lane's sanitised destination and stable in-bucket rank and
     the histogram — no keys, no sort;
  2. pack the items into ONE ``(R, C, W)`` word buffer (the wire format);
  3. exchange (§4.2.2): sender clamp, ONE send-side payload pass (the
     composed gather K1, or the bucket scatter K5), one count and one
     payload ``all_to_all`` (per non-trivial tier on the hierarchical
     route), receive compaction (K2); on the ragged route one count
     ``all_gather`` and one ``ragged_all_to_all`` that lands the rows
     compacted (no K2);
  4. wrap up (§4.2.3): unpack into the next input queue, destinations reset
     to DISCARD, and a ``psum`` of the received counts gives the global
     in-flight total for termination.

Under ``overflow="retain"`` (the lossless law) the rows a sender or tier
clamp would cut come back from the exchange as spill blocks and are merged
into the FRONT of the next queue with their destination intact (FIFO
oldest-first through the stable marshal); the arrivals sit behind them with
DISCARD.  The round then also returns the per-lane ``age`` counter.

With ``telemetry=True`` the round's ``telemetry.RoundStats`` rides along as
the last output; with ``pipeline_shards=S`` each exchange runs as S
micro-shard chains, bit-exact with S=1 (``core.stages.Pipelined``).

Under ``flow="credit"`` (the backpressure law, on top of retain) every
sender ships a destination at most its share of that receiver's one-round-
stale free-space advert (``core.stages.CreditGate``); the un-credited tail
is retained like any clamp cut, and the count collective carries the fresh
adverts back in one more int32 column.  The credits are an ``(R, R)`` int32
tensor: row = the rank holding the estimate, column = the destination (the
reference's per-rank ``(R,)`` vector, stacked).  ``health=`` re-addresses
destinations on unhealthy ranks before the marshal (``core.health``).

The reference's ``use_pallas`` and ``axis_name`` have no counterpart: the
rank axis is dim 0, and the tensors' device picks kernel or plain version.
The sort plan always goes through K3 and the scatter plan through K4, as
the reference's kernel path did: on CPU tensors those are the kernels'
plain versions.  The two marshals place every item identically.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import exchange as X
from repro_torch.core import types as T
from repro_torch.core.collectives import StackedCollectives, backend
from repro_torch.core.health import remap_dest
from repro_torch.core.queue import DISCARD, WorkQueue
from repro_torch.kernels.bucket_scatter import ops as bs_ops
from repro_torch.kernels.marshal import ops as marshal_ops
from repro_torch.kernels.sort_keys import ops as sk_ops

__all__ = ["ForwardConfig", "credit_reserve_rows", "forward_work"]

_EXCHANGES = {
    "padded": X.exchange_padded,
    "ragged": X.exchange_ragged,
    "hierarchical": X.exchange_hierarchical,
    "onehot": X.exchange_onehot,
}


@dataclasses.dataclass(frozen=True)
class ForwardConfig:
    """Static configuration of a forwarding context (field names and
    validation as in ``repro.core.forwarding.ForwardConfig``).

    Attributes:
      num_ranks: number of ranks R (the leading axis of every queue tensor).
      capacity: per-rank queue capacity (paper: ``resizeRayQueues(N)``).
      peer_capacity: padded exchange only — per-peer slot rows of the send
        buffer (default 2·ceil(C/R)).
      exchange: "padded" | "ragged" (contiguous live segments in one
        ``ragged_all_to_all``: the reference's production backend) |
        "hierarchical" (N-stage, over the tier layout ``level_sizes``) |
        "onehot" (test oracle).
      marshal: "sort" (key sort, then one composed gather) | "scatter"
        (the sort-free bucket plan, then one scatter); bit-identical
        placement.
      sort_method: "pack" | "argsort", validated as in the reference.  The
        sort round plans through kernel K3 either way, as the reference's
        kernel path did; the keys are unique, so both give the same
        permutation.  The scatter round does not read it.
      level_sizes: hierarchical only — ranks per tier, slowest first; they
        multiply to ``num_ranks`` and set the tier count (the reference
        counts its mesh axes instead).  2-level configs may give
        ``fast_size`` instead.
      level_capacities: hierarchical only — padded rows per peer segment on
        each tier (default 2·ceil(C/level_sizes[l])).
      fast_size, node_capacity: the reference's 2-level aliases of
        ``level_sizes[-1]`` and ``level_capacities[0]``; ``peer_capacity``
        aliases ``level_capacities[-1]`` there.
      overflow: "drop" (the §3.3 oracle) | "retain" (spill and retry: the
        lossless law).
      telemetry: record every round's ``telemetry.RoundStats`` (a trailing
        output of ``forward_work``; ``run_until_done`` carries a ring of the
        last ``telemetry_window`` rounds, ``telemetry_buckets`` demand
        buckets per tier).
      pipeline_shards: S micro-shards a round (the overlap law), bit-exact
        with S=1; must divide ``capacity`` and every per-peer slot budget.
      flow: "open" (ship every clamped segment) | "credit" (receiver-
        advertised admission, the backpressure law; needs
        ``overflow="retain"`` and a padded, ragged or hierarchical exchange).
      emit_reserve: credit only — receive rows every advert withholds for
        the rank's own emissions (-1: ``capacity // 2``).
    """

    num_ranks: int
    capacity: int
    peer_capacity: int = 0
    exchange: str = "padded"
    marshal: str = "sort"
    sort_method: str = "pack"
    fast_size: int = 0
    node_capacity: int = 0
    level_sizes: Tuple[int, ...] = ()
    level_capacities: Tuple[int, ...] = ()
    telemetry: bool = False
    telemetry_window: int = 16
    telemetry_buckets: int = 8
    overflow: str = "drop"
    pipeline_shards: int = 1
    flow: str = "open"
    emit_reserve: int = -1

    def __post_init__(self):
        if self.exchange not in _EXCHANGES:
            raise ValueError(f"unknown exchange {self.exchange!r}")
        if self.overflow not in ("drop", "retain"):
            raise ValueError(
                f"unknown overflow {self.overflow!r} (expected 'drop' — the "
                "§3.3 oracle — or 'retain': spill-and-retry, the lossless law)"
            )
        if self.flow not in ("open", "credit"):
            raise ValueError(
                f"unknown flow {self.flow!r} (expected 'open' — ship every "
                "clamped segment, the §3.3 oracle — or 'credit': "
                "receiver-advertised admission, the backpressure law)"
            )
        if self.flow == "credit" and self.overflow != "retain":
            raise ValueError(
                "flow='credit' requires overflow='retain': the un-credited "
                "tail of each destination segment is held locally through "
                "the retain spill/compaction machinery — with overflow="
                "'drop' the credit gate would convert backpressure into "
                "silent sender-side loss"
            )
        if self.flow == "credit" and self.exchange == "onehot":
            raise ValueError(
                "flow='credit' is not supported by exchange='onehot': the "
                "all-gather oracle ships whole queues (no per-destination "
                "sender clamp exists for a credit gate to tighten)"
            )
        if self.emit_reserve != -1 and not (0 <= self.emit_reserve < self.capacity):
            raise ValueError(
                f"emit_reserve ({self.emit_reserve}) must be -1 (auto: "
                f"capacity // 2) or in [0, capacity) — reserving the whole "
                "queue would advertise zero credit forever"
            )
        if self.marshal not in ("sort", "scatter"):
            raise ValueError(f"unknown marshal {self.marshal!r}")
        if self.sort_method not in ("pack", "argsort"):
            raise ValueError(f"unknown sort_method {self.sort_method!r}")
        if self.telemetry_window < 1:
            raise ValueError(f"telemetry_window ({self.telemetry_window}) must be >= 1")
        if self.telemetry_buckets < 2:
            raise ValueError(
                f"telemetry_buckets ({self.telemetry_buckets}) must be >= 2 "
                "(bucket B-1 is the at-capacity overflow bucket)"
            )
        if self.num_ranks <= 0 or self.capacity <= 0:
            raise ValueError(
                f"num_ranks ({self.num_ranks}) and capacity ({self.capacity}) "
                "must be positive"
            )
        if self.pipeline_shards < 1:
            raise ValueError(
                f"pipeline_shards ({self.pipeline_shards}) must be >= 1 "
                "(1 = the bulk-synchronous round)"
            )
        if self.capacity % self.pipeline_shards:
            raise ValueError(
                f"pipeline_shards ({self.pipeline_shards}) must divide the "
                f"queue capacity ({self.capacity}) so every micro-shard "
                "covers an equal slice of the wavefront"
            )
        if self.pipeline_shards > 1 and self.exchange == "onehot":
            raise ValueError(
                "pipeline_shards > 1 is not supported by exchange='onehot': "
                "the all-gather oracle is bulk-synchronous by design (whole "
                "queues ship at once — no per-peer slot rows to micro-shard)"
            )
        if self.exchange == "hierarchical":
            self._init_hierarchical()
        else:
            self._init_flat()

    def _init_flat(self):
        for field in ("fast_size", "node_capacity", "level_sizes", "level_capacities"):
            if getattr(self, field):
                raise ValueError(
                    f"{field} only applies to exchange='hierarchical'; the "
                    f"{self.exchange!r} exchange routes over one flat axis "
                    "and would silently ignore it"
                )
        if self.exchange == "padded":
            if self.peer_capacity <= 0:
                object.__setattr__(
                    self, "peer_capacity", max(1, -(-self.capacity // self.num_ranks) * 2)
                )
            if self.peer_capacity % self.pipeline_shards:
                raise ValueError(
                    f"pipeline_shards ({self.pipeline_shards}) must divide "
                    f"peer_capacity ({self.peer_capacity}): micro-shards are "
                    "equal slices of the per-peer slot rows"
                )
        elif self.peer_capacity:
            raise ValueError(
                f"peer_capacity does not apply to exchange={self.exchange!r} "
                "(no padded per-peer slots exist there) and would be "
                "silently ignored"
            )

    def _init_hierarchical(self):
        """The reference's ``_init_hierarchical`` with the tier count taken
        from ``level_sizes`` (or 2 with the ``fast_size`` alias): the port
        has no mesh axis names to count."""
        sizes = tuple(int(a) for a in self.level_sizes)
        if sizes:
            if len(sizes) < 2:
                raise ValueError(
                    "hierarchical exchange routes over a multi-tier layout and "
                    f"needs level_sizes=(slowest, …, fastest) of >= 2 tiers; got {sizes}"
                )
            if any(a < 1 for a in sizes):
                raise ValueError(f"level_sizes entries must be >= 1, got {sizes}")
            if math.prod(sizes) != self.num_ranks:
                raise ValueError(
                    f"level_sizes {sizes} multiply to {math.prod(sizes)}, not "
                    f"num_ranks {self.num_ranks}"
                )
            if self.fast_size and self.fast_size != sizes[-1]:
                raise ValueError(
                    f"fast_size {self.fast_size} contradicts level_sizes "
                    f"{sizes} (it aliases the fastest tier, {sizes[-1]})"
                )
        else:
            if self.fast_size <= 0:
                raise ValueError(
                    "hierarchical exchange needs level_sizes (or the 2-level "
                    "fast_size alias: the number of ranks on the fast tier)"
                )
            if self.num_ranks % self.fast_size:
                raise ValueError(
                    f"fast_size {self.fast_size} must divide num_ranks "
                    f"{self.num_ranks} (ranks are node-major over (slow, fast))"
                )
            sizes = (self.num_ranks // self.fast_size, self.fast_size)

        caps = tuple(int(c) for c in self.level_capacities)
        if caps and len(caps) != len(sizes):
            raise ValueError(
                f"level_capacities {caps} must give one segment size per "
                f"tier ({len(sizes)} tiers)"
            )
        if not caps:
            # tier-l fan-out: level_sizes[l] aggregated segments, 2× headroom
            caps = tuple(max(1, -(-self.capacity // a) * 2) for a in sizes)
            if self.peer_capacity > 0:  # legacy alias: fastest tier
                caps = caps[:-1] + (self.peer_capacity,)
            if self.node_capacity > 0:  # legacy alias: slowest tier
                caps = (self.node_capacity,) + caps[1:]
        else:
            if any(c < 1 for c in caps):
                raise ValueError(f"level_capacities entries must be >= 1, got {caps}")
            if self.peer_capacity and self.peer_capacity != caps[-1]:
                raise ValueError(
                    f"peer_capacity {self.peer_capacity} contradicts "
                    f"level_capacities {caps} (it aliases the fastest tier)"
                )
            if self.node_capacity and self.node_capacity != caps[0]:
                raise ValueError(
                    f"node_capacity {self.node_capacity} contradicts "
                    f"level_capacities {caps} (it aliases the slowest tier)"
                )
        if any(c % self.pipeline_shards for c in caps):
            raise ValueError(
                f"pipeline_shards ({self.pipeline_shards}) must divide every "
                f"level_capacities entry ({caps}): micro-shards are equal "
                "slices of each tier's per-segment slot rows"
            )
        object.__setattr__(self, "level_sizes", sizes)
        object.__setattr__(self, "level_capacities", caps)
        # keep the legacy aliases live so 2-level callers read either form
        object.__setattr__(self, "fast_size", sizes[-1])
        object.__setattr__(self, "peer_capacity", caps[-1])
        object.__setattr__(self, "node_capacity", caps[0])


def credit_reserve_rows(cfg: ForwardConfig) -> int:
    """Resolved ``emit_reserve``: receive rows every credit advert withholds
    for the rank's own emissions (``-1``: half the queue)."""
    return cfg.capacity // 2 if cfg.emit_reserve < 0 else cfg.emit_reserve


def forward_work(
    q: WorkQueue,
    cfg: ForwardConfig,
    *,
    age: Optional[torch.Tensor] = None,
    health: Optional[torch.Tensor] = None,
    credits: Optional[torch.Tensor] = None,
    comm: StackedCollectives | None = None,
    on_stage: Optional[Callable[[str], None]] = None,
):
    """One collective forwarding round over the rank-stacked queue ``q``.

    Returns ``(new_queue, total_in_flight)``; ``total_in_flight`` is the
    §4.2.3 global reduce (a 0-d tensor: the number of items alive across all
    ranks after the exchange).  Under ``overflow="retain"`` it returns
    ``(new_queue, total, age_out)``: clamp-cut rows come back at the FRONT
    of ``new_queue`` with their ``dest`` intact, ``total`` counts them, and
    ``age_out (R, C)`` is the per-lane rounds-waiting counter to feed back
    through ``age=`` (None: every lane fresh).  Under ``flow="credit"``
    ``credits_out (R, R)`` follows ``age_out`` — row r is rank r's estimate
    of every destination's free space, to feed back through ``credits=``
    (None: every receiver credited with ``capacity``, the uncontended
    single-shot assumption; the drive cold-starts at zero instead).  With
    ``cfg.telemetry`` the round's ``RoundStats`` is the last output:
    ``(new_queue, total, stats)``, ``(new_queue, total, age_out, stats)``
    under retain or ``(new_queue, total, age_out, credits_out, stats)``
    under credit, with ``retained_rows`` and ``age_max`` stamped after the
    merge.

    ``health`` (optional ``(R,) bool``) re-addresses every destination on an
    unhealthy rank before the marshal (``core.health.remap_dest``): no call
    and no launch is added, retained rows keep the remapped destination, and
    ``None`` and an all-True mask give the same round bit for bit.

    ``comm`` is the collective backend and records the round's calls
    (None: a fresh ``StackedCollectives``).  Over a
    ``DistributedCollectives`` world ``q`` is the process's block of
    ``comm.local_ranks(num_ranks)`` ranks, every per-rank input and output
    (``age``, ``credits``, the stats rows) is that block's, and ``total``
    is the world's.  ``on_stage(name)``, if given,
    is called after each step of the round ("plan", "pack", each exchange
    stage on ``padded`` and ``ragged`` and, with its tier, on
    ``hierarchical`` —
    ``"Stage#k"`` for shard k of a pipelined round — or "exchange" on
    ``onehot``, "merge" under retain, "unpack", "psum"), e.g. to record a
    CUDA event there; it must not change the round.
    """
    comm = backend(comm)
    if q.num_ranks != comm.local_ranks(cfg.num_ranks) or q.capacity != cfg.capacity:
        raise ValueError(
            f"queue is ({q.num_ranks}, {q.capacity}) but the config is "
            f"({cfg.num_ranks}, {cfg.capacity}) over a world of {comm.world} process(es)"
        )
    return _forward(q, cfg, age=age, health=health, credits=credits, comm=comm, on_stage=on_stage)


def _forward(q, cfg, *, age=None, health=None, credits=None, comm=None, on_stage=None, digits=None, tier=None):
    """:func:`forward_work`'s round.  With ``digits`` (a tier layout of
    ``q.num_ranks`` ranks) and ``tier`` l, ``cfg`` is a flat padded config
    over the ``A_l = cfg.num_ranks`` ranks of each tier-l group: every
    destination is a digit-l lane and every collective is a tier-l call
    (``core.rebalance``'s intra-scope round)."""
    mark = on_stage or (lambda name: None)
    comm = backend(comm)
    R, C = cfg.num_ranks, cfg.capacity
    retain = cfg.overflow == "retain"
    credit = cfg.flow == "credit"
    if health is not None:
        q = dataclasses.replace(q, dest=remap_dest(q.dest, health))
    # K2 compacts R blocks a rank (padded) or the last stage's A_l: refuse
    # a count its block table cannot hold before anything is launched
    if cfg.exchange == "padded":
        marshal_ops.check_blocks(R, q.dest)
    elif cfg.exchange == "hierarchical":
        marshal_ops.check_blocks(next((a for a in cfg.level_sizes if a > 1), 1), q.dest)
    perm = dest_clean = dest_rank = None
    if cfg.marshal == "scatter":
        # ranks are lexicographic in the tier digits, so the in-bucket rank
        # against the full destination is the in-sub-segment rank at every tier
        dest_clean, dest_rank, hist = bs_ops.rank_and_histogram(q.dest, q.count, num_ranks=R)
        send_counts = hist[:, :R]  # segments are fully described by the histogram
    elif cfg.exchange == "hierarchical":
        perm, count_tensor = sk_ops.sort_permutation_hierarchical(
            q.dest, q.count, cfg.level_sizes, method=cfg.sort_method
        )
        send_counts = count_tensor.reshape(q.num_ranks, R)
    else:
        perm, _sorted_dest, hist = sk_ops.sort_permutation(q.dest, q.count, R)
        send_counts = hist[:, :R]
    mark("plan")

    packed, spec = T.pack_payload(q.items, batch_dims=2)  # (R, C, W) wire format
    mark("pack")
    kwargs = dict(
        comm=comm, num_ranks=R, capacity=C, marshal=cfg.marshal,
        dest_clean=dest_clean, dest_rank=dest_rank, overflow=cfg.overflow, age=age,
        telemetry=cfg.telemetry, telemetry_buckets=cfg.telemetry_buckets,
    )
    if cfg.exchange == "padded":
        kwargs.update(peer_capacity=cfg.peer_capacity, pipeline_shards=cfg.pipeline_shards, on_stage=on_stage,
                      digits=digits, tier=tier)
    elif cfg.exchange == "ragged":
        kwargs.update(pipeline_shards=cfg.pipeline_shards, on_stage=on_stage)
    elif cfg.exchange == "hierarchical":
        kwargs.update(level_sizes=cfg.level_sizes, level_capacities=cfg.level_capacities,
                      pipeline_shards=cfg.pipeline_shards, on_stage=on_stage)
    if credit:
        if credits is None:  # single-shot call: uncontended, fully credited receivers
            credits = torch.full((q.num_ranks, R), C, dtype=torch.int32, device=q.dest.device)
        kwargs.update(flow="credit", credits=credits, credit_reserve=credit_reserve_rows(cfg))
    recv_packed, _recv_counts, new_count, drops, pending, credits_out, stats = _EXCHANGES[cfg.exchange](
        packed, perm, send_counts, **kwargs
    )
    tail = () if stats is None else (stats,)
    if cfg.exchange == "onehot":
        mark("exchange")
    if not retain:
        new_q = WorkQueue(
            items=T.unpack_payload(recv_packed, spec),
            dest=torch.full_like(q.dest, DISCARD),
            count=new_count.to(torch.int32),
            drops=(q.drops + drops).to(torch.int32),
        )
        mark("unpack")
        # §4.2.3: "a final MPI reduce-add on the number of rays received"
        total = comm.psum(new_q.count, digits=digits, tier=tier)
        mark("psum")
        return (new_q, total) + tail

    # Merge: retained lanes FIRST (their dest survives), arrivals behind
    # (dest DISCARD) — pure local work, zero collectives.  Each clamp site
    # handed back an already compacted block, and the receive compaction
    # already landed the arrivals behind the reserved front; a spill past C
    # (unreachable when capacity bounds the resident population) is counted
    # as spill_over.
    lane = torch.arange(C, dtype=torch.int32, device=q.dest.device)[None, :]
    run = sum((n for *_rest, n in pending), torch.zeros_like(new_count))
    ret_count = torch.clamp(run, max=C)
    spill_over = run - ret_count
    if not pending:  # the onehot oracle: nothing to merge
        merged = recv_packed
        dest_out = torch.full_like(q.dest, DISCARD)
        age_out = torch.zeros_like(q.dest)
    elif len(pending) == 1:  # flat: one block at offset 0, a single select
        rows_e, dest_e, age_e, n_e = pending[0]
        sel = lane < n_e[:, None]
        merged = torch.where(sel[:, :, None], rows_e, recv_packed)
        dest_out = torch.where(sel, dest_e, DISCARD)
        age_out = torch.where(sel, age_e, 0)
    else:
        # multi-stage routes: one gather (K1) from the virtual concatenation
        # [block_0 | block_1 | … | arrivals]; the lane → source map is (R, C)
        # integer math
        src = lane + len(pending) * C  # default: the arrivals region
        start = torch.zeros_like(run)[:, None]
        for i, (_rows, _dest, _age, n_e) in enumerate(pending):
            sel = (lane >= start) & (lane < start + n_e[:, None])
            src = torch.where(sel, i * C + lane - start, src)
            start = start + n_e[:, None]
        merged = marshal_ops.gather_rows(torch.cat([p[0] for p in pending] + [recv_packed], dim=1), src)
        cat = lambda parts, fill: torch.cat(parts + [torch.full_like(q.dest, fill)], dim=1)
        dest_out = torch.gather(cat([p[1] for p in pending], DISCARD), 1, src.to(torch.int64))
        age_out = torch.gather(cat([p[2] for p in pending], 0), 1, src.to(torch.int64))
    mark("merge")
    new_q = WorkQueue(
        items=T.unpack_payload(merged, spec),
        dest=dest_out.to(torch.int32),
        count=(ret_count + new_count).to(torch.int32),
        drops=(q.drops + drops + spill_over).to(torch.int32),
    )
    mark("unpack")
    total = comm.psum(new_q.count, digits=digits, tier=tier)
    mark("psum")
    age_out = age_out.to(torch.int32)
    if stats is not None:
        tail = (dataclasses.replace(stats, retained_rows=ret_count.to(torch.int32),
                                    age_max=age_out.amax(dim=1)),)
    return (new_q, total, age_out) + ((credits_out,) if credit else ()) + tail
