"""Deterministic schedules and oracles for the lossless law, numpy only.

The port's own copies of ``repro.chaos.scenarios`` (seeded emission
schedules: capacity drought, rotating hot spot, burst storm, convergecast,
and the brownout and overload shapes) and of ``repro.chaos.oracle``
(:func:`expected_by_rank`, the checksums the schedule alone implies;
:func:`simulate_flat_retain`, the round-by-round numpy twin of the flat
padded retain drive, rank-health remap included; and
:func:`simulate_flat_credit`, the twin of the flat credit drive with the
cursor-gated emitter); and of ``repro.chaos.driver`` (:func:`run_scenario`,
the scenario through the port's drive loop, and
:func:`run_scenario_checkpointed`, through the recovery law's segmented
drive with preemption, resume and elastic restore, with
:func:`boundary_digests` as the bit-exactness witness).
"""
from repro_torch.chaos.driver import (
    ChaosItem,
    boundary_digests,
    chaos_proto,
    run_scenario,
    run_scenario_checkpointed,
)
from repro_torch.chaos.oracle import expected_by_rank, simulate_flat_credit, simulate_flat_retain
from repro_torch.chaos.scenarios import (
    Scenario,
    all_scenarios,
    brownout_mask,
    burst_storm,
    capacity_drought,
    convergecast,
    incast_collapse,
    overload_scenarios,
    rank_brownout,
    rotating_hotspot,
    sustained_overload,
)

__all__ = [
    "ChaosItem",
    "Scenario",
    "all_scenarios",
    "boundary_digests",
    "brownout_mask",
    "burst_storm",
    "chaos_proto",
    "capacity_drought",
    "convergecast",
    "expected_by_rank",
    "incast_collapse",
    "overload_scenarios",
    "rank_brownout",
    "rotating_hotspot",
    "run_scenario",
    "run_scenario_checkpointed",
    "simulate_flat_credit",
    "simulate_flat_retain",
    "sustained_overload",
]
