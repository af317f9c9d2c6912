"""Typed counter/gauge snapshots per burst — the metrics half of the
observation law (the port's copy of ``repro.obs.metrics``: the same
metrics, names and text).

Everything here is DERIVED from values the stack already surfaces — the
rank-stacked ``telemetry.StatsRing`` the drive returns, the recovery
carry's accounting leaves, a checkpoint manifest ``repro_torch.ckpt``
wrote — read back on the host after the drive, so a metered drive is the
same drive: no collective, no kernel launch.

The registry is deliberately tiny: a :class:`Metric` is a name, a kind
(``counter`` — monotone over the burst — or ``gauge``), a float value and a
label dict.  Two exporters cover the operational surface:

* :func:`to_prometheus` — the text exposition format a scrape endpoint
  serves (one ``# TYPE`` line per family, labels sorted);
* :func:`to_json` — the machine-readable capture ``obs.report``
  ingests.

:func:`burst_metrics` maps one recorded burst (a ring + its config) onto the
full per-law inventory: per-tier demand histograms and clamp drops (the telemetry law),
retained rows / spill ages (the lossless law), credit adverts, wasted-wire
rows and emission overflow (the backpressure law), receive totals and
goodput.
:func:`accounting_metrics` adds the conservation-watchdog terms of a
segmented drive, :func:`checkpoint_metrics` the bytes/leaves of a published
checkpoint manifest.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.telemetry import stats as TS

__all__ = [
    "Metric",
    "accounting_metrics",
    "burst_metrics",
    "checkpoint_metrics",
    "from_summary",
    "metrics_dict",
    "to_json",
    "to_prometheus",
]

_KINDS = ("counter", "gauge")


@dataclasses.dataclass(frozen=True)
class Metric:
    """One sample: ``name{labels} value`` with a Prometheus kind."""

    name: str
    kind: str  # "counter" | "gauge"
    value: float
    labels: Tuple[Tuple[str, str], ...] = ()
    help: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"metric kind must be one of {_KINDS}, got {self.kind!r}")


def _m(name: str, kind: str, value, help: str = "", **labels) -> Metric:
    return Metric(
        name=name, kind=kind, value=float(value),
        labels=tuple(sorted((k, str(v)) for k, v in labels.items())),
        help=help,
    )


def from_summary(summary: Dict[str, Any], *, prefix: str = "rafi") -> List[Metric]:
    """A ``telemetry.summarize`` dict → the per-burst metric inventory."""
    out: List[Metric] = []
    caps = summary["tier_capacities"]
    L = len(caps)
    out.append(_m(f"{prefix}_rounds_total", "counter", summary["rounds"],
                  "forwarding rounds recorded this burst"))
    for l in range(L):
        lab = dict(tier=l)
        out.append(_m(f"{prefix}_tier_capacity_rows", "gauge", caps[l],
                      "configured per-segment slot capacity", **lab))
        out.append(_m(f"{prefix}_demand_max_rows", "gauge",
                      int(summary["demand_max"][l]),
                      "max single-segment demand seen", **lab))
        out.append(_m(f"{prefix}_demand_rows_total", "counter",
                      int(summary["demand_total"][l]),
                      "rows presented to the tier pre-clamp", **lab))
        out.append(_m(f"{prefix}_sent_rows_total", "counter",
                      int(summary["sent_rows"][l]),
                      "rows shipped post-clamp", **lab))
        out.append(_m(f"{prefix}_stage_drops_total", "counter",
                      int(summary["stage_drops"][l]),
                      "rows the tier's send clamp cut", **lab))
        out.append(_m(f"{prefix}_credits_granted_total", "counter",
                      int(summary["credits_granted"][l]),
                      "credit allowance granted (flow=credit)", **lab))
        out.append(_m(f"{prefix}_rows_held_total", "counter",
                      int(summary["rows_held"][l]),
                      "rows the tier's clamp held locally", **lab))
        hist = np.asarray(summary["demand_hist"])[l]
        for b, cnt in enumerate(hist):
            out.append(_m(f"{prefix}_demand_bucket_total", "counter", int(cnt),
                          "segments per demand bucket", tier=l, bucket=b))
    out.append(_m(f"{prefix}_recv_drops_total", "counter", summary["recv_drops"],
                  "rows the receiver compaction cut"))
    out.append(_m(f"{prefix}_wasted_wire_rows_total", "counter",
                  summary["wasted_wire_rows"],
                  "rows that crossed a wire and were then discarded"))
    out.append(_m(f"{prefix}_drops_total", "counter", summary["drops"],
                  "all clamp drops (send + receive)"))
    out.append(_m(f"{prefix}_emit_overflow_total", "counter",
                  summary["emit_overflow"],
                  "local emission rows clipped by the drive"))
    out.append(_m(f"{prefix}_retained_rows_total", "counter",
                  summary["retained_rows"],
                  "row-rounds retained by spill-and-retry"))
    out.append(_m(f"{prefix}_spill_age_max_rounds", "gauge", summary["age_max"],
                  "oldest retained lane's rounds-waiting counter"))
    out.append(_m(f"{prefix}_recv_rows_max", "gauge", summary["recv_total_max"],
                  "max rows arriving in one round"))
    out.append(_m(f"{prefix}_goodput_ratio", "gauge", summary["goodput"],
                  "admitted wire rows / shipped wire rows"))
    return out


def burst_metrics(ring: TS.StatsRing, cfg: Any, *,
                  prefix: str = "rafi") -> List[Metric]:
    """One burst's rank-stacked ring → metrics, using the config's
    tier-capacity law for the demand buckets."""
    summary = TS.summarize(ring, tier_capacities=TS.tier_capacities(cfg))
    return from_summary(summary, prefix=prefix)


def accounting_metrics(res: Dict[str, Any], *, prefix: str = "rafi") -> List[Metric]:
    """Conservation-watchdog terms of a segmented-drive result dict
    (``recovery.run_checkpointed``/``resume_run``): Σ emitted, Σ delivered,
    in-flight residue, Σ drops — the ledger every boundary re-proves."""
    out: List[Metric] = []
    for key, kind, hlp in (
        ("emitted", "counter", "rows entering the system (drive-counted)"),
        ("delivered", "counter", "rows handed to round_fn as arrivals"),
    ):
        if key in res:
            out.append(_m(f"{prefix}_{key}_rows_total", kind,
                          int(_host(res[key]).astype(np.uint64).sum()), hlp))
    if "rounds" in res:
        out.append(_m(f"{prefix}_drive_rounds_total", "counter",
                      int(_host(res["rounds"])), "rounds driven"))
    if "q" in res:
        q = res["q"]
        out.append(_m(f"{prefix}_inflight_rows", "gauge",
                      int(_host(q.count).sum()), "rows still queued"))
        out.append(_m(f"{prefix}_queue_drops_total", "counter",
                      int(_host(q.drops).sum()), "queue-counted drops"))
    return out


def checkpoint_metrics(manifest: Dict[str, Any], *,
                       prefix: str = "rafi") -> List[Metric]:
    """A ``repro_torch.ckpt`` (or ``repro.ckpt``) manifest → checkpoint
    size/armature gauges."""
    leaves = manifest.get("leaves", [])
    # manifest leaves record shape+dtype, not byte counts — derive them
    total = sum(
        int(np.prod(e["shape"]) * np.dtype(e["dtype"]).itemsize)
        for e in leaves
        if "shape" in e and "dtype" in e
    )
    step = int(manifest.get("step", manifest.get("meta", {}).get("round", 0)))
    return [
        _m(f"{prefix}_checkpoint_bytes", "gauge", total,
           "bytes of the last published checkpoint", step=step),
        _m(f"{prefix}_checkpoint_leaves", "gauge", len(leaves),
           "carry leaves in the last published checkpoint", step=step),
    ]


def _host(x) -> np.ndarray:
    """A host array of a result leaf (tensors are copied off the device)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------- exporters
def to_prometheus(metrics: List[Metric]) -> str:
    """Prometheus text exposition: families sorted, one TYPE/HELP line per
    family, labels rendered sorted — deterministic output for goldens."""
    by_family: Dict[str, List[Metric]] = {}
    for m in metrics:
        by_family.setdefault(m.name, []).append(m)
    lines: List[str] = []
    for name in sorted(by_family):
        fam = by_family[name]
        if fam[0].help:
            lines.append(f"# HELP {name} {fam[0].help}")
        lines.append(f"# TYPE {name} {fam[0].kind}")
        for m in fam:
            if m.labels:
                lab = ",".join(f'{k}="{v}"' for k, v in m.labels)
                lines.append(f"{name}{{{lab}}} {_fmt(m.value)}")
            else:
                lines.append(f"{name} {_fmt(m.value)}")
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def to_json(metrics: List[Metric]) -> str:
    """The capture encoding ``obs.report`` reads back."""
    return json.dumps(
        [
            {"name": m.name, "kind": m.kind, "value": m.value,
             "labels": dict(m.labels)}
            for m in metrics
        ],
        sort_keys=True,
    )


def metrics_dict(metrics: List[Metric]) -> Dict[str, float]:
    """Flat ``{name{labels}: value}`` view for asserts and quick reads."""
    out: Dict[str, float] = {}
    for m in metrics:
        key = m.name
        if m.labels:
            key += "{" + ",".join(f"{k}={v}" for k, v in m.labels) + "}"
        out[key] = m.value
    return out
