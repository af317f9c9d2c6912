"""The traffic flight recorder over rank-stacked tensors.

Every forwarding round already computes the full traffic picture in its
control plane: the marshal histogram is the per-destination demand, the
hierarchical route's per-tier count exchanges are the per-sub-segment
demands, and the §3.3 clamps know exactly what they cut.  ``RoundStats``
snapshots those values and nothing else: capture issues ZERO collectives,
never touches the payload and never reads a value back to the host.

The fields are those of ``repro.telemetry.stats`` (see its docstring for
their meaning), each with a leading rank axis R:

* ``demand_hist (R, L, B)`` — per-tier histogram of segment demand against
  the tier's capacity (:func:`occupancy_bucket`: bucket ``B-1`` holds every
  demand at or above capacity);
* ``demand_max``, ``demand_total``, ``sent_rows``, ``stage_drops``,
  ``credits_granted``, ``rows_held`` ``(R, L)``;
* ``recv_total``, ``recv_drops``, ``wasted_wire_rows``, ``retained_rows``,
  ``age_max``, ``emit_overflow`` ``(R,)``.

Tiers follow ``ForwardConfig``: one per ``level_sizes`` entry on the
hierarchical route (slowest first; extent-1 tiers stay zero), one on the
flat backends.  A ``StatsRing`` keeps the last ``window`` rounds: leaves
``(R, window, …)`` and ``pos (R,)`` — the reference's rank-stacked layout
(``stack_ring``), so :func:`stack_ring` is the identity here.  Unwritten
slots are zero and add nothing to any aggregate.

:func:`summarize`, :func:`ring_trace` and :func:`demand_quantile` are the
host-side view: they read a ring back once, between bursts, and return the
reference's keys with numpy values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = [
    "RoundStats",
    "StatsRing",
    "attach_emit_overflow",
    "bucket_upper_edges",
    "bucket_width",
    "demand_quantile",
    "make_ring",
    "make_stats",
    "num_tiers",
    "occupancy_bucket",
    "occupancy_histogram",
    "ring_filled",
    "ring_push",
    "ring_trace",
    "single_tier_stats",
    "stack_ring",
    "summarize",
    "tier_capacities",
]


@dataclasses.dataclass
class RoundStats:
    """One forwarding round's traffic snapshot, every leaf int32 with a
    leading rank axis (module docstring)."""

    demand_hist: torch.Tensor  # (R, L, B) segments per demand bucket, per tier
    demand_max: torch.Tensor  # (R, L) exact max single-segment demand
    demand_total: torch.Tensor  # (R, L) rows presented to the tier
    sent_rows: torch.Tensor  # (R, L) rows shipped post-clamp
    stage_drops: torch.Tensor  # (R, L) rows the tier's §3.3 send clamp cut
    recv_total: torch.Tensor  # (R,) rows arriving pre receiver clamp
    recv_drops: torch.Tensor  # (R,) rows the receiver compaction cut
    wasted_wire_rows: torch.Tensor  # (R,) post-wire discards
    retained_rows: torch.Tensor  # (R,) rows retained locally (overflow="retain")
    age_max: torch.Tensor  # (R,) oldest retained lane's rounds waiting
    credits_granted: torch.Tensor  # (R, L) credit allowance (flow="credit")
    rows_held: torch.Tensor  # (R, L) rows each tier's clamp held locally
    emit_overflow: torch.Tensor  # (R,) local emission rows clipped (drive-stamped)

    @property
    def tiers(self) -> int:
        return self.demand_hist.shape[-2]

    @property
    def buckets(self) -> int:
        return self.demand_hist.shape[-1]


@dataclasses.dataclass
class StatsRing:
    """The last ``window`` rounds of :class:`RoundStats`: leaves ``(R,
    window, …)``; ``pos (R,)`` counts the rounds recorded so far (the next
    write lands at ``pos % window``)."""

    stats: RoundStats
    pos: torch.Tensor

    @property
    def window(self) -> int:
        return self.stats.demand_hist.shape[-3]


def _leaves(stats: RoundStats) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)}


# ------------------------------------------------------------ bucketing law
def bucket_width(capacity: int, num_buckets: int) -> int:
    """Fixed bucket width: buckets ``0 … B-2`` tile ``[0, capacity)``."""
    return max(1, -(-int(capacity) // (int(num_buckets) - 1)))


def bucket_upper_edges(capacity: int, num_buckets: int) -> np.ndarray:
    """Exclusive upper demand edge of every bucket (host side); the
    overflow bucket's entry is clamped to ``capacity`` as a placeholder."""
    w = bucket_width(capacity, num_buckets)
    return np.minimum(np.arange(1, num_buckets + 1) * w, capacity)


def occupancy_bucket(occ: torch.Tensor, capacity: int, num_buckets: int) -> torch.Tensor:
    """Bucket of each demand value.  Bucket ``B-1`` takes EVERY demand at
    or above ``capacity``, not only the quotient's overflow."""
    w = bucket_width(capacity, num_buckets)
    return torch.where(
        occ >= capacity, num_buckets - 1, torch.clamp(occ // w, max=num_buckets - 2)
    ).to(torch.int32)


def occupancy_histogram(occ: torch.Tensor, capacity: int, num_buckets: int) -> torch.Tensor:
    """``(…, B)`` int32 — segments per demand bucket of ``occ (…, A)``, the
    per-segment demands of one tier.  A ``scatter_add_`` into a fixed zero
    tensor: no output sized from the data, so no host sync."""
    b = occupancy_bucket(occ, capacity, num_buckets).to(torch.int64)
    hist = torch.zeros(occ.shape[:-1] + (num_buckets,), dtype=torch.int32, device=occ.device)
    return hist.scatter_add_(-1, b, torch.ones_like(b, dtype=torch.int32))


# --------------------------------------------------------------- builders
def make_stats(tiers: int, buckets: int, *, num_ranks: int = 1, device=None) -> RoundStats:
    """All-zero stats, the builder the exchanges fill tier by tier."""
    z = lambda *s: torch.zeros((num_ranks,) + s, dtype=torch.int32, device=device)
    return RoundStats(
        demand_hist=z(tiers, buckets), demand_max=z(tiers), demand_total=z(tiers),
        sent_rows=z(tiers), stage_drops=z(tiers), recv_total=z(), recv_drops=z(),
        wasted_wire_rows=z(), retained_rows=z(), age_max=z(), credits_granted=z(tiers),
        rows_held=z(tiers), emit_overflow=z(),
    )


def single_tier_stats(
    demand: torch.Tensor,  # (R, A) per-segment demand, pre-clamp
    capacity: int,  # the tier's configured segment capacity
    buckets: int,
    *,
    sent_rows: torch.Tensor,  # (R,) rows shipped post-clamp
    stage_drops: torch.Tensor,  # (R,) send-clamp drops
    recv_total: torch.Tensor,  # (R,) rows arriving pre receiver clamp
    recv_drops: torch.Tensor,  # (R,) receiver compaction drops
    rows_held: torch.Tensor = None,  # (R,) retain: rows the send clamp held
    credits_granted: torch.Tensor = None,  # (R,) credit: Σ min(grant, slot)
) -> RoundStats:
    """The flat-backend capture: one tier, filled in one call.  Every flat
    backend discards shipped rows only at the receiver, so
    ``wasted_wire_rows`` is ``recv_drops``.  The retain fields start zero;
    ``forward_work`` stamps them after the merge.  Under credit flow
    ``rows_held`` also counts the tails that were not credited."""
    i32 = lambda t: t.to(torch.int32)
    zero = torch.zeros(demand.shape[0], dtype=torch.int32, device=demand.device)
    return RoundStats(
        demand_hist=occupancy_histogram(demand, capacity, buckets)[:, None, :],
        demand_max=i32(demand.amax(dim=1))[:, None],
        demand_total=demand.sum(dim=1, dtype=torch.int32)[:, None],
        sent_rows=i32(sent_rows)[:, None],
        stage_drops=i32(stage_drops)[:, None],
        recv_total=i32(recv_total),
        recv_drops=i32(recv_drops),
        wasted_wire_rows=i32(recv_drops),
        retained_rows=zero,
        age_max=zero,
        credits_granted=i32(zero if credits_granted is None else credits_granted)[:, None],
        rows_held=i32(zero if rows_held is None else rows_held)[:, None],
        emit_overflow=zero,
    )


# ------------------------------------------------------------- ring buffer
def make_ring(tiers: int, *, window: int, buckets: int, num_ranks: int = 1, device=None) -> StatsRing:
    """An empty ring (all zeros)."""
    proto = make_stats(tiers, buckets, num_ranks=num_ranks, device=device)
    stats = RoundStats(**{
        k: torch.zeros((v.shape[0], window) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        for k, v in _leaves(proto).items()
    })
    return StatsRing(stats=stats, pos=torch.zeros(num_ranks, dtype=torch.int32, device=device))


def attach_emit_overflow(stats: RoundStats, n) -> RoundStats:
    """Stamp the round's local emission loss (the drive owns it)."""
    return dataclasses.replace(stats, emit_overflow=torch.as_tensor(n).to(torch.int32))


def ring_push(ring: StatsRing, stats: RoundStats) -> StatsRing:
    """Record one round in slot ``pos % window`` (overwriting the oldest once
    the window is full).  The slot is selected on the device, so a push
    never reads ``pos`` back to the host."""
    W = ring.window
    hit = torch.arange(W, device=ring.pos.device)[None, :] == (ring.pos % W)[:, None]  # (R, W)

    def put(buf, s):
        sel = hit.reshape(hit.shape + (1,) * (buf.dim() - 2))
        return torch.where(sel, s.to(buf.dtype)[:, None], buf)

    new = {k: put(buf, getattr(stats, k)) for k, buf in _leaves(ring.stats).items()}
    return StatsRing(stats=RoundStats(**new), pos=ring.pos + 1)


def ring_filled(ring: StatsRing) -> torch.Tensor:
    """Number of valid (written) slots, per rank."""
    return torch.clamp(ring.pos, max=ring.window)


def stack_ring(ring):
    """The reference's per-rank → rank-stacked conversion.  Port rings and
    stats already carry the rank axis, so this is the identity."""
    return ring


# --------------------------------------------------------- config plumbing
def num_tiers(cfg: Any) -> int:
    """Recorded tiers of a ``ForwardConfig``."""
    if cfg.exchange == "hierarchical":
        return len(cfg.level_sizes)
    return 1


def tier_capacities(cfg: Any) -> Tuple[int, ...]:
    """The capacity each tier's histogram is measured against."""
    if cfg.exchange == "hierarchical":
        return tuple(int(c) for c in cfg.level_capacities)
    if cfg.exchange == "padded":
        return (int(cfg.peer_capacity),)
    return (int(cfg.capacity),)  # onehot: the receiver queue is the clamp


# ---------------------------------------------------------- host-side view
def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def summarize(ring: StatsRing, *, tier_capacities: Tuple[int, ...]) -> Dict:
    """Aggregate a ring into the controller's host-side view (the
    reference's keys and aggregation; quantiles are over every segment of
    every recorded round on every rank)."""
    s = {k: _np(v) for k, v in _leaves(ring.stats).items()}
    hist = s["demand_hist"]
    L, B = hist.shape[-2], hist.shape[-1]
    per_tier = lambda a, red: red(a.reshape(-1, L), axis=0)
    stage_drops = per_tier(s["stage_drops"], np.sum)
    recv_drops = int(s["recv_drops"].sum())
    recv_total = int(s["recv_total"].sum())
    pos = _np(ring.pos)
    return {
        "tier_capacities": tuple(int(c) for c in tier_capacities),
        "buckets": B,
        "rounds": int(pos.max()),
        "window_filled": int(np.minimum(pos, ring.window).max()),
        "demand_hist": hist.reshape(-1, L, B).sum(axis=0),
        "demand_max": per_tier(s["demand_max"], np.max),
        "demand_total": per_tier(s["demand_total"], np.sum),
        "sent_rows": per_tier(s["sent_rows"], np.sum),
        "stage_drops": stage_drops,
        "recv_total_max": int(s["recv_total"].max()),
        "recv_drops": recv_drops,
        "wasted_wire_rows": int(s["wasted_wire_rows"].sum()),
        "drops": int(stage_drops.sum()) + recv_drops,
        "retained_rows": int(s["retained_rows"].sum()),
        "age_max": int(s["age_max"].max()),
        "credits_granted": per_tier(s["credits_granted"], np.sum),
        "rows_held": per_tier(s["rows_held"], np.sum),
        "emit_overflow": int(s["emit_overflow"].sum()),
        "goodput": 1.0 if recv_total == 0 else 1.0 - recv_drops / recv_total,
    }


def ring_trace(ring: StatsRing) -> Dict:
    """Chronological per-round trace of the ring's scalar counters, oldest
    first, ``window_filled`` entries: ``retained_rows``, ``recv_total``,
    ``recv_drops``, ``wasted_wire_rows`` and ``emit_overflow`` summed over
    ranks, ``age_max`` maxed."""
    pos_all = _np(ring.pos).reshape(-1)
    if pos_all.size == 0 or not (pos_all == pos_all[0]).all():
        raise ValueError(
            f"ring positions diverge across ranks: {pos_all} — ranks push in "
            "lockstep inside the drive, so this ring was not produced by one drive"
        )
    pos, W = int(pos_all[0]), ring.window
    idx = (np.arange(W) + pos % W) % W if pos > W else np.arange(pos)

    def per_round(leaf, reduce):
        return reduce(_np(leaf)[:, idx], axis=0)

    st = ring.stats
    return {
        "retained_rows": per_round(st.retained_rows, np.sum),
        "age_max": per_round(st.age_max, np.max),
        "recv_total": per_round(st.recv_total, np.sum),
        "recv_drops": per_round(st.recv_drops, np.sum),
        "wasted_wire_rows": per_round(st.wasted_wire_rows, np.sum),
        "emit_overflow": per_round(st.emit_overflow, np.sum),
    }


def demand_quantile(summary: Dict, tier: int, q: float) -> int:
    """Conservative demand at quantile ``q`` of tier ``tier``'s recorded
    segments, read off the buckets' exclusive upper edges; ``q >= 1`` and
    any quantile in the overflow bucket return the exact recorded max."""
    hist = np.asarray(summary["demand_hist"][tier], dtype=np.int64)
    dmax = int(summary["demand_max"][tier])
    total = int(hist.sum())
    if total == 0:
        return 0
    if q >= 1.0:
        return dmax
    edges = bucket_upper_edges(summary["tier_capacities"][tier], summary["buckets"])
    b = int(np.searchsorted(np.cumsum(hist), q * total))
    if b >= len(hist) - 1:
        return dmax
    return int(min(edges[b], max(dmax, 1)))
