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
     payload ``all_to_all``, receive compaction (K2);
  4. wrap up (§4.2.3): unpack into the next input queue, destinations reset
     to DISCARD, and a ``psum`` of the received counts gives the global
     in-flight total for termination.

The reference's ``use_pallas`` and ``axis_name`` have no counterpart: the
rank axis is dim 0, and the tensors' device picks kernel or plain version.
The sort plan always goes through K3 and the scatter plan through K4, as
the reference's kernel path did: on CPU tensors those are the kernels'
plain versions.  The two marshals place every item identically.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import exchange as X
from repro_torch.core import types as T
from repro_torch.core.collectives import StackedCollectives
from repro_torch.core.queue import DISCARD, WorkQueue
from repro_torch.kernels.bucket_scatter import ops as bs_ops
from repro_torch.kernels.sort_keys import ops as sk_ops

__all__ = ["ForwardConfig", "forward_work"]

_EXCHANGES = {
    "padded": X.exchange_padded,
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
      exchange: "padded" | "onehot" (test oracle); "ragged" and
        "hierarchical" come in later slices.
      marshal: "sort" (key sort, then one composed gather) | "scatter"
        (the sort-free bucket plan, then one scatter); bit-identical
        placement.
      sort_method: "pack" | "argsort", validated as in the reference.  The
        sort round plans through kernel K3 either way, as the reference's
        kernel path did; the keys are unique, so both give the same
        permutation.  The scatter round does not read it.
      The remaining fields mirror the reference and must keep their
      defaults until their slice lands.
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
        # valid reference configurations whose feature a later slice brings
        if self.exchange == "hierarchical":
            raise _later("exchange='hierarchical'", "7")
        if self.exchange == "ragged":
            raise _later("exchange='ragged'", "16")
        if self.flow == "credit":
            raise _later("flow='credit'", "10")
        if self.overflow == "retain":
            raise _later("overflow='retain'", "6")
        if self.pipeline_shards > 1:
            raise _later("pipeline_shards > 1", "9")
        if self.telemetry:
            raise _later("telemetry=True", "8")
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


def forward_work(
    q: WorkQueue,
    cfg: ForwardConfig,
    *,
    comm: StackedCollectives | None = None,
    on_stage: Optional[Callable[[str], None]] = None,
) -> Tuple[WorkQueue, torch.Tensor]:
    """One collective forwarding round over the rank-stacked queue ``q``.

    Returns ``(new_queue, total_in_flight)``; ``total_in_flight`` is the
    §4.2.3 global reduce (a 0-d tensor: the number of items alive across all
    ranks after the exchange).  ``comm`` records the round's collectives.
    ``on_stage(name)``, if given, is called after each step of the round
    ("plan", "pack", each exchange stage on ``padded``, "unpack", "psum"),
    e.g. to record a CUDA event there; it must not change the round.
    """
    mark = on_stage or (lambda name: None)
    if q.num_ranks != cfg.num_ranks or q.capacity != cfg.capacity:
        raise ValueError(
            f"queue is ({q.num_ranks}, {q.capacity}) but the config is "
            f"({cfg.num_ranks}, {cfg.capacity})"
        )
    comm = StackedCollectives() if comm is None else comm
    R = cfg.num_ranks
    perm = dest_clean = dest_rank = None
    if cfg.marshal == "scatter":
        dest_clean, dest_rank, hist = bs_ops.rank_and_histogram(q.dest, q.count, num_ranks=R)
    else:
        perm, _sorted_dest, hist = sk_ops.sort_permutation(q.dest, q.count, R)
    send_counts = hist[:, :R]  # segments are fully described by the histogram
    mark("plan")

    packed, spec = T.pack_payload(q.items, batch_dims=2)  # (R, C, W) wire format
    mark("pack")
    kwargs = dict(
        comm=comm, num_ranks=R, capacity=cfg.capacity,
        marshal=cfg.marshal, dest_clean=dest_clean, dest_rank=dest_rank,
    )
    if cfg.exchange == "padded":
        kwargs.update(peer_capacity=cfg.peer_capacity, on_stage=on_stage)
    recv_packed, _recv_counts, new_count, drops = _EXCHANGES[cfg.exchange](
        packed, perm, send_counts, **kwargs
    )
    if cfg.exchange != "padded":
        mark("exchange")
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
