"""The adaptive capacity controller over the port's flight recorder (the
counterpart of ``repro.tune.controller``, the same law and trajectory).

Every capacity knob of the forwarding round (``peer_capacity``, the
hierarchical route's ``level_capacities``) is a burst-tolerance bet: too
small and §3.3 clamps drop work, too large and every round pays padding on
the wire.  Between bursts the host solves, per tier,

    capacity = ceil(headroom · demand_quantile(q)),  rounded to granularity

from the ``telemetry`` ring's summary, and ``autotune_forward`` repeats run
burst → summarize → re-plan until a burst is drop-free and the plan is a
fixed point.  Tier ``l`` records demand after the faster tiers' clamps, so
a multi-tier route converges over a few bursts, not one.  A new
``ForwardConfig`` is just a new set of shapes here; nothing is recompiled.
Over a ``DistributedCollectives`` world (``comm=``) a burst's ring is the
process's block: the controller summarizes the gathered ring and sums the
burst's drops over the world (both off the call recorder), so every
process re-plans on the same numbers and reaches the same configs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.core.forwarding import ForwardConfig
from repro_torch.obs import trace as OT
from repro_torch.telemetry import stats as TS

__all__ = [
    "TunePolicy",
    "TuneStep",
    "TuneReport",
    "solve_capacities",
    "plan_capacities",
    "autotune_forward",
]


@dataclasses.dataclass(frozen=True)
class TunePolicy:
    """The drop-probability / padding-waste trade-off, as knobs.

    Attributes:
      quantile: fraction of observed segments that must fit the planned
        capacity.  ``1.0`` = drop-free (plans from the exact recorded max);
        lower values accept a drop tail to cut padding.
      headroom: multiplier on the quantile demand — absorbs drift between
        the measuring burst and the next one.
      granularity: capacities are rounded UP to a multiple of this (8 keeps
        segment rows tile-aligned for the marshal kernels).
      min_capacity: floor, so a silent tier can never plan a 0-row segment.
      allow_shrink: when False the plan only ever grows capacities —
        guarantees monotone convergence at the cost of keeping padding from
        a cold start's over-estimate.
    """

    quantile: float = 1.0
    headroom: float = 1.25
    granularity: int = 8
    min_capacity: int = 8
    allow_shrink: bool = True

    def __post_init__(self):
        if not 0.0 < self.quantile <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {self.quantile}")
        if self.headroom < 1.0:
            raise ValueError(f"headroom must be >= 1, got {self.headroom}")
        if self.granularity < 1 or self.min_capacity < 1:
            raise ValueError("granularity and min_capacity must be >= 1")


@dataclasses.dataclass
class TuneStep:
    """One burst of the autotune loop (history row of :class:`TuneReport`)."""

    burst: int
    capacities: Tuple[int, ...]   # what the burst ran with
    planned: Tuple[int, ...]      # what the summary asked for next
    drops: int                    # total clamp drops observed in the burst
    demand_max: Tuple[int, ...]   # exact per-tier max segment demand
    rounds: int                   # forwarding rounds the burst recorded
    retained: int = 0             # spill-and-retry row-rounds (overflow="retain")


@dataclasses.dataclass
class TuneReport:
    """The autotune trajectory: per-burst history + the convergence verdict."""

    steps: List[TuneStep]
    converged: bool

    @property
    def bursts(self) -> int:
        return len(self.steps)

    @property
    def final_drops(self) -> int:
        return self.steps[-1].drops if self.steps else 0


def _round_up(x: int, granularity: int) -> int:
    return -(-int(x) // granularity) * granularity


def solve_capacities(
    summary: Dict,
    current: Tuple[int, ...],
    policy: TunePolicy,
    *,
    bounds: Tuple[int, ...] = None,
) -> Tuple[int, ...]:
    """Per-tier capacity from one burst summary (see the module docstring's
    law).  Tiers with no recorded segments (extent-1 tiers skip their stage;
    a backend may be idle) keep their current capacity — no observation is
    not evidence of no demand.

    ``bounds`` is the optional per-tier PROVABLE worst-case segment demand
    (the paper's §6.3 upper bound, e.g. ``n_emit ×`` the source sub-segments
    feeding a slot): headroom never pushes a plan past what the workload
    could possibly present, so a tuned config is ≤ the static worst-case
    config tier by tier."""
    out = []
    for l, cap in enumerate(current):
        if int(summary["demand_hist"][l].sum()) == 0:
            out.append(int(cap))
            continue
        occ = TS.demand_quantile(summary, l, policy.quantile)
        new = _round_up(
            max(policy.min_capacity, math.ceil(occ * policy.headroom)),
            policy.granularity,
        )
        if not policy.allow_shrink:
            new = max(new, int(cap))
        if bounds is not None:
            new = min(new, int(bounds[l]))
        out.append(int(new))
    return tuple(out)


def plan_capacities(
    summary: Dict,
    cfg: ForwardConfig,
    *,
    policy: TunePolicy = TunePolicy(),
    bounds: Tuple[int, ...] = None,
) -> ForwardConfig:
    """Re-plan ``cfg``'s per-tier capacities from a burst summary.

    Returns a fresh ``ForwardConfig`` (same topology, marshal, telemetry
    knobs) with ``level_capacities`` (hierarchical) or ``peer_capacity``
    (flat padded) replaced by the solved sizes.  The receiver ``capacity``
    is deliberately NOT tuned — it is the application's queue shape (§3.2)
    and changing it re-shapes every kernel, not just the wire format.
    """
    if cfg.exchange not in ("padded", "hierarchical"):
        raise ValueError(
            f"exchange {cfg.exchange!r} has no per-peer segment capacities to "
            "tune (ragged segments are exact; onehot is the test oracle)"
        )
    current = TS.tier_capacities(cfg)
    solved = solve_capacities(summary, current, policy, bounds=bounds)
    # the reference's field list (less its axis_name and use_pallas, which
    # the port has not): pipeline_shards, flow and emit_reserve are NOT
    # carried over, as the reference does not carry them
    kw = dict(
        num_ranks=cfg.num_ranks,
        capacity=cfg.capacity,
        exchange=cfg.exchange,
        marshal=cfg.marshal,
        sort_method=cfg.sort_method,
        telemetry=cfg.telemetry,
        telemetry_window=cfg.telemetry_window,
        telemetry_buckets=cfg.telemetry_buckets,
        overflow=cfg.overflow,
    )
    if cfg.exchange == "hierarchical":
        kw.update(level_sizes=cfg.level_sizes, level_capacities=solved)
    else:
        kw.update(peer_capacity=solved[0])
    return ForwardConfig(**kw)


def autotune_forward(
    run_burst: Callable[[ForwardConfig], Tuple[Any, TS.StatsRing]],
    cfg: ForwardConfig,
    *,
    policy: TunePolicy = TunePolicy(),
    bounds: Tuple[int, ...] = None,
    max_bursts: int = 8,
    comm=None,
) -> Tuple[ForwardConfig, TuneReport]:
    """Converge the per-tier capacities over repeated bursts.

    ``run_burst(cfg) -> (drops, ring)`` runs one workload burst under the
    given config with telemetry on and returns the burst's CUMULATIVE §3.3
    drop count (the queue's drop counter summed over ranks) plus the
    recorded ``StatsRing``.  The drop count must come from the queue
    counter, not the ring: the ring only
    keeps the last ``telemetry_window`` rounds, so a burst longer than the
    window could clamp early, have the evidence overwritten, and read as
    drop-free from the summary alone.  Pass ``drops=None`` to explicitly
    accept the windowed ``summary["drops"]`` as the verdict (only sound when
    the window covers the whole burst).

    The loop re-plans after every burst and stops when the burst was
    drop-free AND the plan is a fixed point (re-planning from the new burst
    asks for the capacities it already ran with) — so the final config is
    *verified* drop-free on the measured workload, not just predicted.
    Under ``overflow="retain"`` clamped rows spill back into the queue
    instead of dropping, so a burst can be "drop-free" while still starved
    for capacity; the verdict therefore also requires the burst's summed
    ``retained_rows`` (spill pressure, recorded per round in telemetry) to
    be zero — retained demand keeps driving capacity growth exactly like
    drops do in drop mode.
    Returns ``(final_cfg, report)``; ``report.converged`` is False when
    ``max_bursts`` ran out first (e.g. a workload whose drift outruns the
    headroom).  With ``comm`` (a world) ``run_burst`` returns the process's
    drops and ring block; the verdict reads the world's.
    """
    if not cfg.telemetry:
        raise ValueError(
            "autotune needs ForwardConfig(telemetry=True) — the controller "
            "plans from the recorded StatsRing"
        )
    steps: List[TuneStep] = []
    converged = False
    with OT.span(
        "tune.autotune_forward", OT.CAT_TUNE,
        max_bursts=max_bursts, exchange=cfg.exchange,
    ) as sp:
        for burst in range(max_bursts):
            burst_drops, ring = run_burst(cfg)
            if comm is not None:
                ring = comm.gather_tree(ring)
                if burst_drops is not None:
                    local = torch.tensor([int(burst_drops)], dtype=torch.int64, device=ring.pos.device)
                    burst_drops = int(comm.gather_all(local).sum())
            summary = TS.summarize(ring, tier_capacities=TS.tier_capacities(cfg))
            drops = int(summary["drops"] if burst_drops is None else burst_drops)
            retained = int(summary.get("retained_rows", 0))
            planned = plan_capacities(summary, cfg, policy=policy, bounds=bounds)
            cur_caps = TS.tier_capacities(cfg)
            new_caps = TS.tier_capacities(planned)
            if new_caps != cur_caps:
                # the observation law's re-plan record: old → new capacities
                OT.event(
                    "tune.replan", OT.CAT_TUNE, burst=burst,
                    old=list(cur_caps), new=list(new_caps),
                    drops=drops, retained=retained,
                )
            steps.append(
                TuneStep(
                    burst=burst,
                    capacities=cur_caps,
                    planned=new_caps,
                    drops=drops,
                    demand_max=tuple(int(d) for d in summary["demand_max"]),
                    rounds=int(summary["rounds"]),
                    retained=retained,
                )
            )
            if drops == 0 and retained == 0 and new_caps == cur_caps:
                converged = True
                break
            cfg = planned
        sp.set(bursts=len(steps), converged=converged)
    return cfg, TuneReport(steps=steps, converged=converged)
