"""The flight-data analyzer — ``python -m repro_torch.obs.report capture.json``
(the port's copy of ``repro.obs.report``: the same capture format, checks,
verdicts and text, so either package's analyzer reads either's capture).

The third leg of the observation law: :mod:`obs.trace` records WHEN,
:mod:`obs.metrics` records HOW MUCH, and this module reads one combined
capture back and answers IS IT HEALTHY — every check cross-referencing a
measured number against the law that governs it:

* **ledger identity** (the conservation law): per run,
  ``Σ emitted == Σ delivered + in-flight + Σ drops`` with zero unaccounted
  loss, straight off the accounting dict;
* **waste split** (the backpressure law): under open flow the counted
  drops must decompose exactly as ``emit_overflow + wasted_wire_rows`` —
  both first-class recorder fields;
* **saturation** (the telemetry law): per-tier max demand vs the
  configured segment capacity — a tier at ≥ 1.0 is being clamped;
* **spill age** (the lossless law): measured ``age_max`` vs the
  ``roofline.spill_drain_model`` bound for the observed peak backlog;
* **goodput** (the backpressure law): recomputed from the per-round trace
  (``1 - Σ wasted / Σ wire``) and checked against both the run's own
  recorded number and, when the capture carries the scenario's
  offered/drain rates, the ``goodput_model`` prediction;
* **overlap** (the overlap law): a measured ``phase_us`` split is
  bracketed by ``overlap_efficiency_model`` at ``async_fraction`` 0 and 1;
* **liveness**: livelock (rounds exhausted, backlog resident, nothing
  moving over the tail of the ring window), starvation (a rank's delivered
  share collapsed vs the per-rank median — only flagged when a healthy majority
  exists; a single-sink incast/convergecast shape is topology, not
  starvation), straggler spans from the host trace.

A run is flagged **degraded** when any of: the ledger does not balance,
goodput < ``GOODPUT_DEGRADED``, the spill-age bound is violated, or a
livelock signature is present.  The exit code of the CLI is the number of
degraded runs — scriptable as a health gate.

Capture format — one JSON object::

    {"meta": {...},
     "runs": [{"name", "flow", "ledger": {...}, "trace": {...},
               "tier_capacities", "capacity", "metrics": [...],
               "delivered_by_rank": [...], "model": {...}}, ...],
     "events": [...],            # optional obs.trace event list
     "phase_us": {...}, "phase_meta": {...}}   # optional obs.phases split

:func:`chaos_capture` builds a run entry from a
``repro_torch.chaos.run_scenario`` result dict; :func:`save_capture` / :func:`load_capture` round-trip the file.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np

GOODPUT_DEGRADED = 0.9  # the backpressure gate: open overload sits below, credit at 1
SATURATION_HOT = 1.0    # demand_max / capacity at or past the clamp
STARVATION_SHARE = 0.25  # rank delivered < this × median ⇒ starved
LIVELOCK_TAIL = 4        # trailing rounds with no receives ⇒ nothing moving

__all__ = [
    "analyze",
    "chaos_capture",
    "load_capture",
    "main",
    "render",
    "save_capture",
]


# ------------------------------------------------------------ capture side
def chaos_capture(
    name: str,
    res: Dict[str, Any],
    *,
    flow: str,
    tier_capacities,
    capacity: int,
    offered: Optional[int] = None,
    drain: Optional[int] = None,
    metrics: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """One ``repro_torch.chaos.run_scenario`` result → a capture run entry."""
    run: Dict[str, Any] = {
        "name": name,
        "flow": flow,
        "scenario": res.get("scenario", ""),
        "tier_capacities": [int(c) for c in tier_capacities],
        "capacity": int(capacity),
        "ledger": {
            "emitted": int(res["emitted"]),
            "delivered": int(res["delivered_total"]),
            "resident": int(res["resident"]),
            "drops": int(res["drops"]),
            "lost": int(res["lost"]),
            "rounds": int(res["rounds"]),
            "done": bool(res["done"]),
            "emit_overflow": int(res.get("emit_overflow", 0)),
            "wasted_wire_rows": int(res.get("wasted_wire_rows", 0)),
            "wire_rows": int(res.get("wire_rows", 0)),
            "goodput": float(res.get("goodput", 1.0)),
            "retained_rows": int(res.get("retained_rows", 0)),
            "age_max": int(res.get("age_max", 0)),
        },
        "trace": {
            k: np.asarray(res[src]).astype(int).tolist()
            for k, src in (
                ("recv_total", "recv_trace"),
                ("wasted_wire_rows", "wasted_trace"),
                ("retained_rows", "retained_trace"),
                ("age_max", "age_trace"),
            )
            if src in res
        },
    }
    if "delivered" in res:
        run["delivered_by_rank"] = (
            np.asarray(res["delivered"])[:, 0].astype(int).tolist()
        )
    model: Dict[str, Any] = {}
    if offered is not None:
        model["offered_rows_per_round"] = int(offered)
    if drain is not None:
        model["drain_rows_per_round"] = int(drain)
    if model:
        run["model"] = model
    if metrics is not None:
        run["metrics"] = metrics
    return run


def save_capture(path, runs: List[Dict[str, Any]], *, events=None,
                 phase_us=None, phase_meta=None, meta=None) -> str:
    cap: Dict[str, Any] = {"meta": dict(meta or {}), "runs": list(runs)}
    if events is not None:
        cap["events"] = [
            {**e, "args": {k: _plain(v) for k, v in (e.get("args") or {}).items()}}
            for e in events
        ]
    if phase_us is not None:
        cap["phase_us"] = {k: float(v) for k, v in phase_us.items()}
        cap["phase_meta"] = dict(phase_meta or {})
    with open(path, "w") as f:
        json.dump(cap, f)
    return str(path)


def _plain(v):
    a = np.asarray(v)
    if a.dtype == object:
        return str(v)
    return a.item() if a.ndim == 0 else a.tolist()


def load_capture(path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------------ analysis side
def _check(name: str, ok: bool, detail: str) -> Dict[str, Any]:
    return {"check": name, "ok": bool(ok), "detail": detail}


def _analyze_run(run: Dict[str, Any]) -> Dict[str, Any]:
    from repro_torch.roofline.analysis import goodput_model, spill_drain_model

    led = run["ledger"]
    flow = run.get("flow", "open")
    checks: List[Dict[str, Any]] = []
    flags: List[str] = []

    # 1. conservation: emitted == delivered + resident + drops, lost == 0
    balance = (
        led["emitted"] - led["delivered"] - led["resident"] - led["drops"]
    )
    ok = balance == 0 and led["lost"] == 0
    checks.append(_check(
        "ledger",
        ok,
        f"emitted {led['emitted']} = delivered {led['delivered']} + "
        f"resident {led['resident']} + drops {led['drops']} "
        f"(residual {balance}, lost {led['lost']})",
    ))
    if not ok:
        flags.append("ledger_violation")

    # 2. the open-flow waste split (credit must have nothing to split)
    split = led["emit_overflow"] + led["wasted_wire_rows"]
    ok = split == led["drops"]
    checks.append(_check(
        "waste_split",
        ok,
        f"drops {led['drops']} = emit_overflow {led['emit_overflow']} + "
        f"wasted_wire_rows {led['wasted_wire_rows']}",
    ))
    if not ok:
        flags.append("waste_split_violation")

    # 3. goodput — recomputed from the per-round trace when present, and
    # cross-checked against the model prediction when the capture carries
    # the scenario's offered/drain rates
    tr = run.get("trace", {})
    goodput = led["goodput"]
    if tr.get("recv_total") and "wasted_wire_rows" in tr:
        wire = int(np.sum(tr["recv_total"]))
        wasted = int(np.sum(tr["wasted_wire_rows"]))
        goodput = 1.0 if wire == 0 else 1.0 - wasted / wire
        ok = abs(goodput - led["goodput"]) < 1e-9
        checks.append(_check(
            "goodput_trace",
            ok,
            f"trace recomputation 1 - {wasted}/{wire} = {goodput:.4f} vs "
            f"recorded {led['goodput']:.4f}",
        ))
        if not ok:
            flags.append("goodput_mismatch")
    model = run.get("model", {})
    if "offered_rows_per_round" in model and "drain_rows_per_round" in model:
        gm = goodput_model(
            model["offered_rows_per_round"], model["drain_rows_per_round"]
        )
        predicted = gm["credit" if flow == "credit" else "open"]["goodput"]
        # the analytic number is a steady-state asymptote; ramp-up rounds
        # pull the measurement up, so the check is one-sided per flow
        ok = goodput >= predicted - 1e-9 if flow == "credit" else (
            goodput <= 1.0 and goodput >= min(predicted, GOODPUT_DEGRADED) - 0.35
        )
        checks.append(_check(
            "goodput_model",
            ok,
            f"{flow} flow measured {goodput:.4f} vs model {predicted:.4f} "
            f"(offered {model['offered_rows_per_round']}/round, drain "
            f"{model['drain_rows_per_round']}/round)",
        ))
    if goodput < GOODPUT_DEGRADED:
        flags.append("degraded_goodput")

    # 4. per-tier saturation from the metrics snapshot
    saturation = []
    for m in run.get("metrics", []):
        if m["name"].endswith("_demand_max_rows"):
            tier = int(m["labels"].get("tier", 0))
            cap_t = run["tier_capacities"][tier] if tier < len(
                run["tier_capacities"]) else run["capacity"]
            sat = m["value"] / cap_t if cap_t else 0.0
            saturation.append({"tier": tier, "demand_max": m["value"],
                               "capacity": cap_t, "ratio": sat})
    hot = [s for s in saturation if s["ratio"] >= SATURATION_HOT]
    if saturation:
        checks.append(_check(
            "saturation",
            True,  # informational: saturation is a cause, not a failure
            "; ".join(
                f"tier {s['tier']}: demand_max {int(s['demand_max'])} / "
                f"cap {s['capacity']} = {s['ratio']:.2f}"
                + (" HOT" if s["ratio"] >= SATURATION_HOT else "")
                for s in saturation
            ),
        ))
        if hot:
            flags.append("saturated")

    # 5. spill age vs the lossless-law drain bound: the backlog observed at
    # its peak must drain within ceil(backlog / allowance) rounds, plus the
    # rounds over which the backlog was still being fed (the model drains a
    # standing backlog; the scenario builds it incrementally)
    if tr.get("retained_rows"):
        backlog = int(np.max(tr["retained_rows"]))
        age = led["age_max"]
        if backlog > 0:
            allowance = max(1, min(run["tier_capacities"]))
            bound = spill_drain_model(backlog, allowance)["age_bound"]
            feed = int(np.sum(np.asarray(tr["retained_rows"]) > 0))
            ok = age <= bound + feed
            checks.append(_check(
                "spill_age",
                ok,
                f"age_max {age} vs drain bound ceil({backlog}/{allowance}) "
                f"= {bound} + {feed} feeding rounds",
            ))
            if not ok:
                flags.append("spill_age_exceeds_model")

    # 6. liveness: livelock / starvation signatures
    if not led["done"]:
        recv = tr.get("recv_total", [])
        tail = recv[-LIVELOCK_TAIL:] if recv else []
        moving = any(int(v) > 0 for v in tail)
        stuck = led["resident"] > 0 and not moving
        checks.append(_check(
            "liveness",
            not stuck,
            f"not done after {led['rounds']} rounds, resident "
            f"{led['resident']}, last {len(tail)} rounds receive "
            f"{[int(v) for v in tail]}",
        ))
        if stuck:
            flags.append("livelock")
    by_rank = run.get("delivered_by_rank")
    if by_rank and len(by_rank) > 1 and sum(by_rank) > 0:
        # baseline on the MEDIAN, not the mean: a couple of hot sinks
        # (sustained overload concentrates traffic by design) inflate the
        # mean until ordinary cold ranks read as starved
        med = float(np.median(np.asarray(by_rank, dtype=float)))
        starved = [r for r, n in enumerate(by_rank)
                   if n < STARVATION_SHARE * med]
        # starvation is a MINORITY collapsing against a healthy majority.
        # When fewer than half the ranks clear the line, the traffic matrix
        # itself is skewed (incast/convergecast delivers everything to one
        # sink) — that is topology, not a health defect, so the check passes
        # and the skew is reported in the detail only.
        skewed = (len(by_rank) - len(starved)) * 2 < len(by_rank)
        checks.append(_check(
            "fairness",
            not starved or skewed,
            f"per-rank delivered {by_rank} (median {med:.1f}"
            + (f"; starved ranks {starved}" if starved else "")
            + ("; skewed traffic matrix — single-sink shape" if skewed else "")
            + ")",
        ))
        if starved and not skewed:
            flags.append("starvation")

    return {
        "name": run.get("name", "?"),
        "flow": flow,
        "goodput": goodput,
        "wasted_wire_rows": led["wasted_wire_rows"],
        "wire_rows": led["wire_rows"],
        "rounds": led["rounds"],
        "checks": checks,
        "saturation": saturation,
        "flags": sorted(set(flags)),
        "degraded": bool(
            {"ledger_violation", "degraded_goodput",
             "spill_age_exceeds_model", "livelock"} & set(flags)
        ),
    }


def _analyze_phases(capture: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Bracket a measured phase split with the overlap law's model at
    async_fraction 0 (synchronous fabric) and 1 (DMA fabric)."""
    phase_us = capture.get("phase_us")
    if not phase_us:
        return None
    from repro_torch.roofline.analysis import overlap_efficiency_model

    meta = capture.get("phase_meta", {})
    shards = int(meta.get("shards", 1))
    bulk_keys = {k: v for k, v in phase_us.items()
                 if "_" not in k or not k.split("_")[0].startswith("shard")}
    sync = overlap_efficiency_model(bulk_keys, shards, async_fraction=0.0)
    ici = overlap_efficiency_model(bulk_keys, shards, async_fraction=1.0)
    wire = sync["wire_us"]
    comp = sync["compute_us"]
    total = wire + comp
    return {
        "phase_us": {k: float(v) for k, v in phase_us.items()},
        "shards": shards,
        "compute_us": comp,
        "wire_us": wire,
        "wire_fraction": wire / total if total else 0.0,
        "pipelined_bracket_us": [ici["pipelined_us"], sync["pipelined_us"]],
        "speedup_bracket": [sync["speedup"], ici["speedup"]],
    }


def _analyze_events(capture: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Host-trace digest: per-category counts, slowest spans, chaos faults,
    autotune re-plans, checkpoint cadence."""
    events = capture.get("events")
    if not events:
        return None
    by_cat: Dict[str, int] = {}
    spans = []
    for e in events:
        by_cat[e.get("cat", "?")] = by_cat.get(e.get("cat", "?"), 0) + 1
        if e.get("ph") == "X" and e.get("dur", 0) > 0:
            spans.append((float(e["dur"]), e.get("name", "?")))
    spans.sort(reverse=True)
    out: Dict[str, Any] = {
        "events": len(events),
        "by_category": dict(sorted(by_cat.items())),
        "slowest_spans": [
            {"name": n, "dur_us": round(d, 1)} for d, n in spans[:5]
        ],
    }
    saves = [e for e in events
             if e.get("cat") == "recovery" and "save" in e.get("name", "")]
    if saves:
        out["checkpoint_saves"] = len(saves)
    replans = [e for e in events if e.get("cat") == "tune"]
    if replans:
        out["autotune_replans"] = len(replans)
    faults = [e for e in events if e.get("cat") == "chaos"]
    if faults:
        out["chaos_events"] = len(faults)
    return out


def analyze(capture: Dict[str, Any]) -> Dict[str, Any]:
    """Capture → cross-law health report (see module docstring)."""
    runs = [_analyze_run(r) for r in capture.get("runs", [])]
    report: Dict[str, Any] = {
        "meta": capture.get("meta", {}),
        "runs": runs,
        "degraded_runs": [r["name"] for r in runs if r["degraded"]],
    }
    phases = _analyze_phases(capture)
    if phases:
        report["phases"] = phases
    events = _analyze_events(capture)
    if events:
        report["trace_digest"] = events
    return report


# ------------------------------------------------------------- text render
def render(report: Dict[str, Any]) -> str:
    lines: List[str] = ["# RAFI flight-data report", ""]
    for r in report["runs"]:
        verdict = "DEGRADED" if r["degraded"] else "healthy"
        lines.append(
            f"## run `{r['name']}` (flow={r['flow']}) — {verdict}"
        )
        lines.append(
            f"goodput {r['goodput']:.4f} · wasted wire rows "
            f"{r['wasted_wire_rows']} / {r['wire_rows']} · "
            f"rounds {r['rounds']}"
        )
        if r["flags"]:
            lines.append(f"flags: {', '.join(r['flags'])}")
        for c in r["checks"]:
            mark = "ok " if c["ok"] else "FAIL"
            lines.append(f"  [{mark}] {c['check']}: {c['detail']}")
        lines.append("")
    if "phases" in report:
        p = report["phases"]
        lines.append("## phase split (one round)")
        for k, v in p["phase_us"].items():
            lines.append(f"  {k}: {v:.1f} us")
        lines.append(
            f"  wire fraction {p['wire_fraction']:.2f}; pipelined x{p['shards']} "
            f"bracket [{p['pipelined_bracket_us'][0]:.1f}, "
            f"{p['pipelined_bracket_us'][1]:.1f}] us (ici..sync)"
        )
        lines.append("")
    if "trace_digest" in report:
        d = report["trace_digest"]
        lines.append("## host trace digest")
        lines.append(
            f"  {d['events']} events: "
            + ", ".join(f"{k}={v}" for k, v in d["by_category"].items())
        )
        for extra in ("checkpoint_saves", "autotune_replans", "chaos_events"):
            if extra in d:
                lines.append(f"  {extra}: {d[extra]}")
        for s in d["slowest_spans"]:
            lines.append(f"  span {s['name']}: {s['dur_us']} us")
        lines.append("")
    deg = report["degraded_runs"]
    lines.append(
        f"verdict: {len(deg)} degraded run(s)"
        + (f" — {', '.join(deg)}" if deg else " — all healthy")
    )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="cross-law health report over an obs capture",
    )
    ap.add_argument("capture", help="capture JSON (see module docstring)")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw report dict instead of text")
    args = ap.parse_args(argv)
    report = analyze(load_capture(args.capture))
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render(report), end="")
    return len(report["degraded_runs"])


if __name__ == "__main__":
    sys.exit(main())
