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
     route), receive compaction (K2);
  4. wrap up (§4.2.3): unpack into the next input queue, destinations reset
     to DISCARD, and a ``psum`` of the received counts gives the global
     in-flight total for termination.

Under ``overflow="retain"`` (the lossless law) the rows a sender or tier
clamp would cut come back from the exchange as spill blocks and are merged
into the FRONT of the next queue with their destination intact (FIFO
oldest-first through the stable marshal); the arrivals sit behind them with
DISCARD.  The round then also returns the per-lane ``age`` counter.

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
from repro_torch.core.collectives import StackedCollectives
from repro_torch.core.queue import DISCARD, WorkQueue
from repro_torch.kernels.bucket_scatter import ops as bs_ops
from repro_torch.kernels.marshal import ops as marshal_ops
from repro_torch.kernels.sort_keys import ops as sk_ops

__all__ = ["ForwardConfig", "forward_work"]

_EXCHANGES = {
    "padded": X.exchange_padded,
    "hierarchical": X.exchange_hierarchical,
    "onehot": X.exchange_onehot,
}
_KNOWN_EXCHANGES = ("padded", "ragged", "hierarchical", "onehot")


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md Queue 1 item {item}"
    )


@dataclasses.dataclass(frozen=True)
class ForwardConfig:
    """Static configuration of a forwarding context (field names and
    validation as in ``repro.core.forwarding.ForwardConfig``).

    Attributes:
      num_ranks: number of ranks R (the leading axis of every queue tensor).
      capacity: per-rank queue capacity (paper: ``resizeRayQueues(N)``).
      peer_capacity: padded exchange only — per-peer slot rows of the send
        buffer (default 2·ceil(C/R)).
      exchange: "padded" | "hierarchical" (N-stage, over the tier layout
        ``level_sizes``) | "onehot" (test oracle); "ragged" comes in a later
        slice.
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
      telemetry, pipeline_shards > 1, flow="credit" and exchange="ragged"
        are validated as in the reference and refused until their slice
        lands (ROADMAP Queue 1 items 8, 9, 10, 16).
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
        if self.exchange not in _KNOWN_EXCHANGES:
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
        # valid reference configurations whose feature a later slice brings
        if self.exchange == "ragged":
            raise _later("exchange='ragged'", "16")
        if self.flow == "credit":
            raise _later("flow='credit'", "10")
        if self.pipeline_shards > 1:
            raise _later("pipeline_shards > 1", "9")
        if self.telemetry:
            raise _later("telemetry=True", "8")

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


def forward_work(
    q: WorkQueue,
    cfg: ForwardConfig,
    *,
    age: Optional[torch.Tensor] = None,
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
    through ``age=`` (None: every lane fresh).  ``comm`` records the round's
    collectives.  ``on_stage(name)``, if given, is called after each step of
    the round ("plan", "pack", each exchange stage on ``padded`` and, with
    its tier, on ``hierarchical``, or "exchange" on ``onehot``, "merge"
    under retain, "unpack", "psum"), e.g. to record a CUDA event there; it
    must not change the round.
    """
    mark = on_stage or (lambda name: None)
    if q.num_ranks != cfg.num_ranks or q.capacity != cfg.capacity:
        raise ValueError(
            f"queue is ({q.num_ranks}, {q.capacity}) but the config is "
            f"({cfg.num_ranks}, {cfg.capacity})"
        )
    comm = StackedCollectives() if comm is None else comm
    R, C = cfg.num_ranks, cfg.capacity
    retain = cfg.overflow == "retain"
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
        send_counts = count_tensor.reshape(R, R)
    else:
        perm, _sorted_dest, hist = sk_ops.sort_permutation(q.dest, q.count, R)
        send_counts = hist[:, :R]
    mark("plan")

    packed, spec = T.pack_payload(q.items, batch_dims=2)  # (R, C, W) wire format
    mark("pack")
    kwargs = dict(
        comm=comm, num_ranks=R, capacity=C, marshal=cfg.marshal,
        dest_clean=dest_clean, dest_rank=dest_rank, overflow=cfg.overflow, age=age,
    )
    if cfg.exchange == "padded":
        kwargs.update(peer_capacity=cfg.peer_capacity, on_stage=on_stage)
    elif cfg.exchange == "hierarchical":
        kwargs.update(level_sizes=cfg.level_sizes, level_capacities=cfg.level_capacities,
                      on_stage=on_stage)
    recv_packed, _recv_counts, new_count, drops, pending = _EXCHANGES[cfg.exchange](
        packed, perm, send_counts, **kwargs
    )
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
        total = comm.psum(new_q.count)
        mark("psum")
        return new_q, total

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
    total = comm.psum(new_q.count)
    mark("psum")
    return new_q, total, age_out.to(torch.int32)
