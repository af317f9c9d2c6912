"""repro_torch.tune — the adaptive capacity controller (the counterpart of
``repro.tune``): reads ``repro_torch.telemetry`` ring summaries between
bursts and solves the per-tier segment capacities; ``autotune_forward``
drives run → re-plan → re-measure to a verified drop-free fixed point."""
from repro_torch.tune.controller import (
    TunePolicy,
    TuneReport,
    TuneStep,
    autotune_forward,
    plan_capacities,
    solve_capacities,
)

__all__ = [
    "TunePolicy",
    "TuneReport",
    "TuneStep",
    "autotune_forward",
    "plan_capacities",
    "solve_capacities",
]
