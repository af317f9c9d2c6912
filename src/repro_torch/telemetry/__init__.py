"""repro_torch.telemetry — the traffic flight recorder over rank-stacked
tensors (the counterpart of ``repro.telemetry``).

Enable with ``ForwardConfig(telemetry=True)`` (knobs ``telemetry_window``,
``telemetry_buckets``): ``forward_work`` then returns the round's
``RoundStats`` as its last output, and ``run_until_done`` / ``RafiContext``
the ``StatsRing`` of the drive's last ``window`` rounds.  Capture issues no
collective and no host sync; ``summarize`` reads a ring back between
bursts and feeds ``repro_torch.tune``.
"""
from repro_torch.telemetry.stats import (
    RoundStats,
    StatsRing,
    attach_emit_overflow,
    bucket_upper_edges,
    bucket_width,
    demand_quantile,
    make_ring,
    make_stats,
    num_tiers,
    occupancy_bucket,
    occupancy_histogram,
    ring_filled,
    ring_push,
    ring_trace,
    single_tier_stats,
    stack_ring,
    summarize,
    tier_capacities,
)

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
