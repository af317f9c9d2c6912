"""The port's observation law (``repro_torch.obs``: ``metrics``, ``report``,
``phases``) against the JAX package's ``repro.obs``.

* **Metrics.** ``to_prometheus``, ``to_json`` and ``metrics_dict`` of the
  port's metrics equal, as text, the reference's ``repro.obs.metrics`` run
  on the same inputs: a summary dict; the ring of one round on both
  packages (flat, onehot, 2×4, 2×2×2) and of a 5-hop drive; a
  checkpointed drive's accounting dict and its checkpoint manifests.
* **Report.** For one capture file the port wrote (the incast pair of
  ``tests/test_obs.py`` through the port's chaos driver, with metrics, the
  host trace and a phase split), the port's ``analyze`` dict and
  ``render`` text equal ``repro.obs.report``'s (it uses no JAX, so it reads
  the port's capture directly); the CLI's exit code is the count of
  degraded runs; a tampered ledger is flagged.
* **Port versions of the reference cases that fail on JAX 0.9.0** (ROADMAP
  R4: the retain drives; R1: the flat credit round): the per-round drop
  chronology on both overload points, open and credit, and the flight
  report of the backpressure ledger, held against the port's own drives, the numpy
  twins (``simulate_flat_retain``, ``simulate_flat_credit``) and the pinned
  open baseline (534 delivered, 618 dropped = 169 emission cuts + 449
  wasted wire rows, 15 rounds); the chaos burst's span and health-mask
  event; the checkpointed drive's recovery events.
* **Phases.** ``profile_phases`` gives the reference's keys, in its order,
  for padded, pipelined at 2 shards, 2×4 and 2×2×2, with exactly one timed
  call per key; ``tier_of_phase`` and ``to_perfetto`` equal the
  reference's.
* **Observation adds no call**: the same drive with and without
  ``obs.trace.capture()`` gives equal ``StackedCollectives.calls`` and
  equal results.

Tolerance: none — everything here counts data or renders text.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import ForwardConfig as JForwardConfig
from repro.obs import metrics as JOM
from repro.obs import phases as JOP
from repro.obs import report as JOR
from repro.telemetry import stats as JTS
from repro_torch import chaos as TC
from repro_torch import ckpt
from repro_torch import telemetry as TM
from repro_torch.chaos import driver as TD
from repro_torch.core import ForwardConfig
from repro_torch.core import recovery as TREC
from repro_torch.obs import metrics as OM
from repro_torch.obs import phases as OP
from repro_torch.obs import report as OR
from repro_torch.obs import trace as OT

from test_obs import _toy_summary
from test_torch_telemetry import (
    _STAT_FIELDS, _hop_round_fn_port, _hop_seed_port, _inputs, _jax_hop_ring, jax_stats, port_stats,
)

R = 8
ROOT = pathlib.Path(__file__).resolve().parents[1]
OVERLOAD = [(TC.sustained_overload, 16, 4), (TC.incast_collapse, 32, 8)]
_IDS = ["sustained", "incast"]


def _same_text(ours, theirs):
    assert OM.to_prometheus(ours) == JOM.to_prometheus(theirs)
    assert OM.to_json(ours) == JOM.to_json(theirs)
    assert OM.metrics_dict(ours) == JOM.metrics_dict(theirs)


# ------------------------------------------------------------- metrics
def test_metrics_of_a_summary_equal_reference():
    ms = OM.from_summary(_toy_summary())
    _same_text(ms, JOM.from_summary(_toy_summary()))
    _same_text(OM.from_summary(_toy_summary(), prefix="x"), JOM.from_summary(_toy_summary(), prefix="x"))
    d = OM.metrics_dict(ms)
    assert d["rafi_wasted_wire_rows_total"] == 2 and d["rafi_demand_max_rows{tier=0}"] == 5
    with pytest.raises(ValueError, match="metric kind"):
        OM.Metric("m", "histogram", 1.0)


def _one_round_rings(tcfg, jcfg, kind):
    """Window-1 rings of the same round on both packages (leaves ``(R, 1,
    …)``, ``pos`` 1)."""
    dest, counts = _inputs(kind)
    got, want = port_stats(tcfg, dest, counts)[2], jax_stats(jcfg, dest, counts)[2]
    ring = TM.StatsRing(stats=TM.RoundStats(**{k: torch.from_numpy(got[k][:, None]) for k in _STAT_FIELDS}),
                        pos=torch.ones(R, dtype=torch.int32))
    jring = JTS.StatsRing(stats=JTS.RoundStats(**{k: want[k][:, None] for k in _STAT_FIELDS}),
                          pos=np.ones(R, np.int32))
    return ring, jring


_ROUND_CFGS = [
    ("flat_retain", dict(exchange="padded", peer_capacity=4, overflow="retain"), "data"),
    ("flat_scatter", dict(exchange="padded", marshal="scatter"), "data"),
    ("onehot", dict(exchange="onehot"), "data"),
    ("2x4", dict(exchange="hierarchical", level_sizes=(2, 4), level_capacities=(6, 8)), ("node", "device")),
    ("2x2x2", dict(exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(4, 6, 8), overflow="retain"),
     ("pod", "node", "device")),
]


@pytest.mark.parametrize("kind", ["spread", "hotspot"])
@pytest.mark.parametrize("name,kw,axes", _ROUND_CFGS, ids=[c[0] for c in _ROUND_CFGS])
def test_burst_metrics_of_one_round_equal_reference(name, kw, axes, kind):
    """The port's ring through the port's metrics == the JAX ring of the
    same round through the reference's, and the port's ring through the
    reference's too."""
    kw = dict(kw, telemetry=True, telemetry_buckets=8)
    tcfg, jcfg = ForwardConfig(R, 64, **kw), JForwardConfig(axes, R, 64, **kw)
    ring, jring = _one_round_rings(tcfg, jcfg, kind)
    ours = OM.burst_metrics(ring, tcfg)
    _same_text(ours, JOM.burst_metrics(jring, jcfg))
    port_ring_np = JTS.StatsRing(stats=JTS.RoundStats(**{k: getattr(ring.stats, k).numpy() for k in _STAT_FIELDS}),
                                 pos=ring.pos.numpy())
    _same_text(ours, JOM.burst_metrics(port_ring_np, jcfg))
    assert len(ours) == len(set((m.name, m.labels) for m in ours))


def test_burst_metrics_of_a_drive_ring_equal_reference(mesh8):
    """The window-4 ring of the 5-hop drive of ``test_torch_telemetry``."""
    cfg = ForwardConfig(R, 64, telemetry=True, telemetry_window=4, telemetry_buckets=8)
    from repro_torch.core import run_until_done

    *_rest, ring = run_until_done(_hop_round_fn_port, _hop_seed_port(), torch.zeros(R), cfg, max_rounds=16)
    jcfg = JForwardConfig("data", R, 64, telemetry=True, telemetry_window=4, telemetry_buckets=8)
    _jrounds, jring = _jax_hop_ring(mesh8, jcfg)
    _same_text(OM.burst_metrics(ring, cfg), JOM.burst_metrics(jring, jcfg))
    assert OM.metrics_dict(OM.burst_metrics(ring, cfg))["rafi_rounds_total"] == 6


def test_accounting_and_checkpoint_metrics_equal_reference(tmp_path):
    """A checkpointed retain drive of ``rotating_hotspot``: its result dict
    and every published manifest through both packages' metrics."""
    sc = TC.rotating_hotspot(num_ranks=R, rounds=8, emits_per_round=2, seed=0)
    ctx = TD._make_ctx(R, capacity=64, overflow="retain", device="cpu")
    res = TREC.run_checkpointed(ctx, TD._make_round_fn(ctx, sc), TD._seed_queue(sc, 64, device="cpu"),
                                TD._aux0(R, "cpu"), ckpt_dir=tmp_path, checkpoint_every=2, keep=99)
    ours = OM.accounting_metrics(res)
    _same_text(ours, JOM.accounting_metrics(res))
    d = OM.metrics_dict(ours)
    assert d["rafi_emitted_rows_total"] == sc.emitted == d["rafi_delivered_rows_total"]
    assert d["rafi_inflight_rows"] == 0 == d["rafi_queue_drops_total"]
    steps = TD._steps(tmp_path)
    assert len(steps) >= 3
    for step in steps:
        manifest = ckpt.load_manifest(tmp_path, step)
        ours = OM.checkpoint_metrics(manifest)
        _same_text(ours, JOM.checkpoint_metrics(manifest))
        assert OM.metrics_dict(ours)[f"rafi_checkpoint_leaves{{step={step}}}"] == len(manifest["leaves"])


# ------------------------------------------ the chaos drives the report reads
@pytest.fixture(scope="module")
def overload_runs():
    """Both overload points, open and credit, through the port's chaos
    driver (the retain drive and the credit drive), the incast pair under a
    span tracer."""
    out, events = {}, []
    for factory, cap, S in OVERLOAD:
        for flow in ("open", "credit"):
            sc = factory(R)
            with OT.capture() as tr:
                out[sc.name, flow] = TC.run_scenario(R, sc, capacity=cap, peer_capacity=S, overflow="retain",
                                                     flow=flow, max_rounds=256, device="cpu")
            events += tr.events
    return out, events


@pytest.mark.parametrize("flow", ["open", "credit"])
@pytest.mark.parametrize("factory,cap,S", OVERLOAD, ids=_IDS)
def test_per_round_drop_chronology_is_complete(overload_runs, factory, cap, S, flow):
    """``tests/test_obs.py``'s chronology case on the port: ``drops == Σ
    (emit_trace + wasted_trace)``, credit's waste zero elementwise; and the
    drive equal to its numpy twin (rounds, drops, checksums, retained rows
    round by round; the credit twin's receives too)."""
    sc = factory(R)
    res = overload_runs[0][sc.name, flow]
    emit_t = np.asarray(res["emit_trace"], np.int64)
    waste_t = np.asarray(res["wasted_trace"], np.int64)
    assert emit_t.shape == waste_t.shape and emit_t.size >= res["rounds"]
    assert not emit_t[res["rounds"] + 1:].any() and not waste_t[res["rounds"] + 1:].any()
    assert res["drops"] == int(emit_t.sum() + waste_t.sum())
    assert res["emit_overflow"] == int(emit_t.sum())
    assert res["wasted_wire_rows"] == int(waste_t.sum())
    if flow == "credit":
        assert not waste_t.any() and res["goodput"] == 1.0 and res["drops"] == 0
        twin = TC.simulate_flat_credit(sc, peer_capacity=S, capacity=cap, max_rounds=256)
        np.testing.assert_array_equal(np.asarray(res["recv_trace"])[:len(twin["recv_trace"])], twin["recv_trace"])
    else:
        assert waste_t.sum() > 0 and (waste_t >= 0).all() and (emit_t >= 0).all()
        twin = TC.simulate_flat_retain(sc, peer_capacity=S, capacity=cap, max_rounds=256)
    assert (res["rounds"], res["drops"], res["done"]) == (twin["rounds"], twin["drops"], twin["done"])
    np.testing.assert_array_equal(res["delivered"], twin["delivered"])
    np.testing.assert_array_equal(np.asarray(res["retained_trace"])[:len(twin["retained_trace"])],
                                  twin["retained_trace"])


def test_open_overload_chronology_pins_the_baseline(overload_runs):
    """``test_torch_credit.py::test_open_overload_baseline_pinned``'s numbers
    through the chaos driver's result dict."""
    res = overload_runs[0]["sustained_overload", "open"]
    assert (res["delivered_total"], res["drops"], res["rounds"]) == (534, 618, 15)
    assert (res["emit_overflow"], res["wasted_wire_rows"], res["wire_rows"]) == (169, 449, 983)


def _incast_capture(overload_runs, **extra):
    runs = [OR.chaos_capture(f"incast_collapse_{flow}", overload_runs[0]["incast_collapse", flow], flow=flow,
                             tier_capacities=(8,), capacity=32, **extra) for flow in ("open", "credit")]
    return runs


def test_flight_report_reproduces_the_backpressure_ledger(overload_runs, tmp_path, capsys):
    """``tests/test_obs.py``'s acceptance case on the port: from the
    round-tripped capture alone the analyzer re-derives the goodput and
    wasted-wire numbers and flags the open incast run, and only it; every
    check of both runs holds; the CLI exits with the degraded-run count."""
    results = {flow: overload_runs[0]["incast_collapse", flow] for flow in ("open", "credit")}
    path = str(tmp_path / "capture.json")
    OR.save_capture(path, _incast_capture(overload_runs), meta={"source": "test_torch_obs"})
    report = OR.analyze(OR.load_capture(path))
    assert report["degraded_runs"] == ["incast_collapse_open"]
    by_name = {r["name"]: r for r in report["runs"]}
    for flow in ("open", "credit"):
        r = by_name[f"incast_collapse_{flow}"]
        assert abs(r["goodput"] - results[flow]["goodput"]) < 1e-9
        assert r["wasted_wire_rows"] == results[flow]["wasted_wire_rows"]
        assert all(c["ok"] for c in r["checks"]), [c for c in r["checks"] if not c["ok"]]
    assert "degraded_goodput" in by_name["incast_collapse_open"]["flags"]
    assert "starvation" not in by_name["incast_collapse_open"]["flags"]
    text = OR.render(report)
    assert "DEGRADED" in text and "healthy" in text
    assert OR.main([path]) == 1
    assert "flight-data report" in capsys.readouterr().out


def test_report_equals_reference_on_the_same_capture(overload_runs, tmp_path):
    """A capture with every section the analyzer reads — the four overload
    runs (one with a metrics snapshot, one with the scenario's rates), the
    drives' host trace and a pipelined phase split — gives the same report
    dict and the same text in both packages."""
    runs = []
    for (name, flow), res in sorted(overload_runs[0].items()):
        cap, S = (16, 4) if name == "sustained_overload" else (32, 8)
        extra = {}
        if flow == "open" and name == "sustained_overload":
            extra["metrics"] = json.loads(OM.to_json(OM.from_summary(_toy_summary())))
        if name == "incast_collapse":
            extra.update(offered=64, drain=8)
        runs.append(OR.chaos_capture(f"{name}_{flow}", res, flow=flow, tier_capacities=(S,), capacity=cap, **extra))
    cfg = ForwardConfig(R, 64, peer_capacity=8, pipeline_shards=2)
    phase_us = OP.profile_phases(cfg, n_emit=8, cap=64, proto=TD.chaos_proto(), device="cpu")
    path = str(tmp_path / "capture.json")
    OR.save_capture(path, runs, events=overload_runs[1], phase_us=phase_us, phase_meta={"shards": 2},
                    meta={"source": "test_torch_obs"})
    cap = OR.load_capture(path)
    ours, theirs = OR.analyze(cap), JOR.analyze(json.loads(json.dumps(cap)))
    assert ours == theirs
    assert OR.render(ours) == JOR.render(theirs)
    assert {"phases", "trace_digest"} <= set(ours) and ours["trace_digest"]["chaos_events"] > 0
    assert ours["degraded_runs"] == ["incast_collapse_open", "sustained_overload_open"]


def test_cli_exit_code_counts_degraded_runs(overload_runs, tmp_path):
    path = str(tmp_path / "capture.json")
    OR.save_capture(path, _incast_capture(overload_runs))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", path, "--json"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr[-2000:]
    assert json.loads(out.stdout) == json.loads(json.dumps(OR.analyze(OR.load_capture(path))))
    assert JOR.main([path]) == 1


def test_analyzer_flags_ledger_violation(overload_runs):
    bad = json.loads(json.dumps(_incast_capture(overload_runs)[1]))  # the healthy credit run
    bad["name"] = "tampered"
    bad["ledger"]["emitted"] += 5
    report = OR.analyze({"runs": [bad]})
    (r,) = report["runs"]
    assert "ledger_violation" in r["flags"] and r["degraded"]
    assert report["degraded_runs"] == ["tampered"]
    assert report == JOR.analyze({"runs": [bad]})


def test_chaos_burst_records_span_and_health_mask():
    sc = TC.sustained_overload(R)
    health = np.ones((R,), bool)
    health[3] = False
    with OT.capture() as tr:
        res = TC.run_scenario(R, sc, capacity=64, max_rounds=64, overflow="retain", health=health, device="cpu")
    (sp,) = tr.select(name="chaos.run_scenario")
    assert sp["cat"] == OT.CAT_CHAOS and sp["ph"] == "X"
    a = sp["args"]
    assert a["scenario"] == sc.name and a["flow"] == "open"
    assert a["done"] is True and a["rounds"] >= 1 and a["delivered_total"] > 0
    (hm,) = tr.select(name="chaos.health_mask")
    assert hm["args"]["unhealthy"] == [3]
    twin = TC.simulate_flat_retain(sc, peer_capacity=16, capacity=64, max_rounds=64, health=health)
    np.testing.assert_array_equal(res["delivered"], twin["delivered"])
    assert (res["rounds"], res["drops"]) == (twin["rounds"], twin["drops"])


def test_checkpointed_drive_records_recovery_events(tmp_path):
    sc = TC.rotating_hotspot(num_ranks=R, rounds=8, emits_per_round=2, seed=0)
    with OT.capture() as tr:
        res = TC.run_scenario_checkpointed(R, sc, capacity=64, ckpt_dir=tmp_path, checkpoint_every=2, preempt_at=4,
                                           max_rounds=64, device="cpu")
    assert res["done"] and res["lost"] == 0
    np.testing.assert_array_equal(res["delivered"], TC.expected_by_rank(sc))
    names = {e["name"] for e in tr.events}
    assert {
        "chaos.run_scenario_checkpointed", "chaos.preempt_scheduled", "chaos.elastic_resume",
        "recovery.run_checkpointed", "recovery.boundary", "recovery.save", "recovery.preempt",
        "recovery.resume_run",
    } <= names
    saves = tr.select(name="recovery.save")
    assert all(s["args"]["bytes"] > 0 for s in saves)
    assert all(len(s["args"]["digest"]) == 16 for s in saves)
    (top,) = tr.select(name="chaos.run_scenario_checkpointed")
    assert top["args"]["preempted"] is True


# ---------------------------------------------------------------- phases
_PHASE_CFGS = [
    ("padded", dict(exchange="padded", peer_capacity=8), "data"),
    ("pipelined", dict(exchange="padded", peer_capacity=8, pipeline_shards=2), "data"),
    ("2x4", dict(exchange="hierarchical", level_sizes=(2, 4), level_capacities=(8, 8)), ("node", "device")),
    ("2x2x2", dict(exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(8, 8, 8)),
     ("pod", "node", "device")),
]


@pytest.fixture(scope="module")
def reference_phase_keys(mesh8, mesh_nodes24, mesh_pods222):
    """The reference's ``profile_phases`` keys, in order, and its timed
    programs a key."""
    from helpers import ray_proto

    meshes = {"data": mesh8, ("node", "device"): mesh_nodes24, ("pod", "node", "device"): mesh_pods222}
    out = {}
    for name, kw, axes in _PHASE_CFGS:
        calls = []

        def timeit(f, x):
            calls.append(f)
            return 1.0, f(x)

        keys = list(JOP.profile_phases(JForwardConfig(axes, R, 64, **kw), meshes[axes], n_emit=8, cap=64,
                                       proto=ray_proto(), timeit=timeit))
        out[name] = (keys, len(calls))
    return out


@pytest.mark.parametrize("marshal", ["sort", "scatter"])
@pytest.mark.parametrize("name,kw,axes", _PHASE_CFGS, ids=[c[0] for c in _PHASE_CFGS])
def test_profile_phases_keys_equal_reference(reference_phase_keys, name, kw, axes, marshal):
    """Same keys in the same order; one timed call per key, each handed the
    ``(R, 1)`` rank tensor; every tier the reference's."""
    from test_torch_retain import _tproto

    calls = []

    def timeit(fn, x):
        assert x.shape == (R, 1) and x.dtype == torch.int32
        calls.append(fn)
        return float(len(calls)), fn(x)

    cfg = ForwardConfig(R, 64, marshal=marshal, **kw)
    phase_us = OP.profile_phases(cfg, n_emit=8, cap=64, proto=_tproto(), timeit=timeit, device="cpu")
    want, n_calls = reference_phase_keys[name]
    assert list(phase_us) == want and len(calls) == n_calls == len(want)
    assert list(phase_us.values()) == [float(i + 1) for i in range(len(want))]
    assert [OP.tier_of_phase(k) for k in phase_us] == [JOP.tier_of_phase(k) for k in want]


def test_profile_phases_default_timer_runs_every_stage():
    """The default timer on the CPU (``time.perf_counter``): positive
    microseconds for every key; the marshal phase's send buffer equals the
    union of the shard phases' buffers."""
    cfg = ForwardConfig(R, 64, peer_capacity=8, pipeline_shards=2)
    us = OP.profile_phases(cfg, n_emit=8, cap=64, proto=TD.chaos_proto(), device="cpu")
    assert len(us) == 10 and all(v > 0 for v in us.values())
    q, _words = OP._setup(cfg, 8, 64, TD.chaos_proto(), torch.device("cpu"))
    bulk = OP._send_side(cfg, q)
    shards = [OP._send_side(cfg, q, shards=2, k=k) for k in range(2)]
    assert torch.equal(torch.cat(shards, dim=2), bulk) and bulk.shape == (R, R, 8, 3)


def test_profile_phases_refuses_ragged():
    """Despite its name, kept from when ragged was refused: the ragged
    round's phases are the reference's three keys, each stage run."""
    cfg = ForwardConfig(R, 64, exchange="ragged")
    us = OP.profile_phases(cfg, n_emit=8, cap=64, proto=TD.chaos_proto(), device="cpu")
    assert list(us) == ["marshal", "count_collective", "payload_collective"] and all(v > 0 for v in us.values())


@pytest.mark.parametrize("phase_us", [
    {"marshal": 10.0, "tier1_payload_collective": 20.0},
    {"tier2_marshal": 1.5, "tier0_count_collective": 2.0, "unmarshal": 3.0, "shard1_marshal": 4.0},
])
def test_to_perfetto_equals_reference(phase_us):
    for kw in (dict(num_ranks=2, tag="t", t0_us=0.0), dict(num_ranks=8, tag="round", t0_us=5.0)):
        assert OP.to_perfetto(phase_us, **kw) == JOP.to_perfetto(phase_us, **kw)
    rows = [r for r in OP.to_perfetto(phase_us, num_ranks=2)["traceEvents"] if r["ph"] == "X"]
    assert {r["pid"] for r in rows} == {0, 1}
    assert [r["tid"] for r in rows if r["pid"] == 0] == [OP.tier_of_phase(k) for k in phase_us]


# ---------------------------------------------------- observation is free
@pytest.mark.parametrize("flow", ["open", "credit"])
def test_tracing_adds_no_call_and_changes_no_result(flow):
    """The incast drive through ``RafiContext.run_until_done`` with and
    without a capture: the same collective calls, queue, aux, rounds and
    ring; the capture holds the drive's span."""
    sc = TC.incast_collapse(R)

    def drive():
        ctx = TD._make_ctx(R, capacity=32, peer_capacity=8, overflow="retain", flow=flow, max_rounds=256,
                           device="cpu")
        rfn, aux0 = TD._drive_parts(ctx, sc)
        out = ctx.run_until_done(rfn, max_rounds=256)(TD._seed_queue(sc, 32, device="cpu"), aux0)
        return ctx.comm.calls, out

    OT.uninstall()
    calls0, out0 = drive()
    with OT.capture() as tr:
        calls1, out1 = drive()
    assert calls1 == calls0 and sum(calls0.values()) > 0
    (sp,) = tr.select(name="drive.run_until_done")
    assert sp["args"]["rounds"] == out0[2] and sp["args"]["flow"] == flow
    q0, q1 = out0[0], out1[0]
    for a, b in ((q0.count, q1.count), (q0.drops, q1.drops), (q0.dest, q1.dest), (q0.items.uid, q1.items.uid)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(out0[1], out1[1]))
    assert out0[2:4] == out1[2:4]
    assert TM.summarize(out0[-1], tier_capacities=(8,)).keys() == TM.summarize(out1[-1], tier_capacities=(8,)).keys()
    for k in _STAT_FIELDS:
        assert torch.equal(getattr(out0[-1].stats, k), getattr(out1[-1].stats, k)), k
