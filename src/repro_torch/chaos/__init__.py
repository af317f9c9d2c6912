"""Deterministic schedules and oracles for the lossless law, numpy only.

The port's own copies of ``repro.chaos.scenarios`` (seeded emission
schedules: capacity drought, rotating hot spot, burst storm, convergecast,
and the brownout and overload shapes) and of the retain half of
``repro.chaos.oracle`` (:func:`expected_by_rank`, the checksums the
schedule alone implies, and :func:`simulate_flat_retain`, the round-by-round
numpy twin of the flat padded retain drive).  The device drive
(``run_scenario``) and the credit twin come with ROADMAP Queue 1 items 13
and 10.
"""
from repro_torch.chaos.oracle import expected_by_rank, simulate_flat_retain
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
    "Scenario",
    "all_scenarios",
    "brownout_mask",
    "burst_storm",
    "capacity_drought",
    "convergecast",
    "expected_by_rank",
    "incast_collapse",
    "overload_scenarios",
    "rank_brownout",
    "rotating_hotspot",
    "simulate_flat_retain",
    "sustained_overload",
]
