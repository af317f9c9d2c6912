"""The port's capacity controller (``repro_torch.tune``) against the JAX
reference.

* The solver and ``plan_capacities`` cases of ``tests/test_tune.py`` on
  both packages, including the fields ``plan_capacities`` does not carry
  over (``pipeline_shards``, ``emit_reserve``: the reference's field list).
* ``autotune_forward`` on the drifting hot-spot of ``tests/test_tune.py``
  (CAP 1,024, N_EMIT 96, 8 rounds), flat padded and 2×2×2: the port's
  ``TuneReport`` equals the JAX report step for step — capacities, planned
  capacities, drops, demand maxima, rounds — and the final configs agree.
  The drift bursts run through the port's ``run_until_done`` with the
  telemetry ring; the JAX bursts are ``test_tune._make_run_burst``'s.

Tolerance: none — everything here counts data.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ForwardConfig as JForwardConfig
from repro.roofline.analysis import occupancy_waste_model
from repro.tune import TunePolicy as JTunePolicy
from repro.tune import autotune_forward as j_autotune_forward
from repro.tune import plan_capacities as j_plan_capacities
from repro.tune import solve_capacities as j_solve_capacities
from repro_torch.core import DISCARD, ForwardConfig, enqueue, make_queue, run_until_done, work_item
from repro_torch.obs import trace as OT
from repro_torch.tune import TunePolicy, autotune_forward, plan_capacities, solve_capacities

from test_tune import CAP, N_EMIT, ROUNDS, _make_run_burst, _summary

R, B = 8, 8
AXES3 = ("pod", "node", "device")

_SOLVER_CASES = [
    # (hist rows, demand max, caps, current, policy kwargs, bounds, the reference test's answer)
    ([[10, 2, 0, 0, 0, 0, 0, 1]], [37], (16,), (16,), dict(headroom=1.0, granularity=1, min_capacity=1), None, (37,)),
    ([[0, 0, 3, 0, 0, 0, 0, 0]], [20], (64,), (64,), dict(headroom=1.25, granularity=8, min_capacity=8), None, (32,)),
    ([[0, 0, 0, 0, 0, 0, 0, 4]], [120], (64,), (64,), dict(headroom=1.5, granularity=8), None, (184,)),
    ([[0, 0, 0, 0, 0, 0, 0, 4]], [120], (64,), (64,), dict(headroom=1.5, granularity=8), (128,), (128,)),
    ([[0] * 8, [5, 0, 0, 0, 0, 0, 0, 0]], [0, 3], (32, 16), (32, 16),
     dict(headroom=1.0, granularity=1, min_capacity=1), None, (32, 3)),
    ([[6, 0, 0, 0, 0, 0, 0, 0]], [2], (64,), (64,),
     dict(headroom=1.0, granularity=1, min_capacity=1, allow_shrink=False), None, (64,)),
    ([[6, 0, 0, 0, 0, 0, 0, 0]], [2], (64,), (64,),
     dict(headroom=1.0, granularity=1, min_capacity=1, allow_shrink=True), None, (2,)),
    ([[30, 20, 10, 5, 0, 0, 0, 0]], [25], (32,), (32,), dict(quantile=0.8, headroom=1.0, granularity=1), None, None),
]


@pytest.mark.parametrize("case", range(len(_SOLVER_CASES)))
def test_solver_equals_reference(case):
    hist, dmax, caps, current, pol, bounds, want = _SOLVER_CASES[case]
    s = _summary(hist, dmax, caps)
    got = solve_capacities(s, current, TunePolicy(**pol), bounds=bounds)
    assert got == j_solve_capacities(s, current, JTunePolicy(**pol), bounds=bounds)
    if want is not None:
        assert got == want


def test_policy_validation_equals_reference():
    for bad in (dict(quantile=0.0), dict(quantile=1.5), dict(headroom=0.9), dict(granularity=0),
                dict(min_capacity=0)):
        for cls in (TunePolicy, JTunePolicy):
            with pytest.raises(ValueError):
                cls(**bad)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ForwardConfig)}


def _jfields(cfg):
    return {k: getattr(cfg, k) for k in _fields(ForwardConfig(R, 64))}


def test_plan_capacities_equals_reference():
    """``test_tune.test_plan_capacities_builds_valid_configs`` on both
    packages: the planned configs agree field for field."""
    pol = TunePolicy(headroom=1.0, granularity=8)
    jpol = JTunePolicy(headroom=1.0, granularity=8)
    s = _summary([[0, 0, 0, 0, 0, 0, 0, 8]], [40], caps=(4,))
    flat = plan_capacities(s, ForwardConfig(R, 64, peer_capacity=4, telemetry=True), policy=pol)
    jflat = j_plan_capacities(s, JForwardConfig("data", R, 64, peer_capacity=4, telemetry=True), policy=jpol)
    assert flat.peer_capacity == 40 and flat.telemetry and _fields(flat) == _jfields(jflat)
    kw = dict(exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(4, 4, 4), telemetry=True)
    s3 = _summary([[0] * 7 + [2]] * 3, [30, 20, 10], caps=(4, 4, 4))
    pol3, jpol3 = TunePolicy(headroom=1.0, granularity=8, min_capacity=8), JTunePolicy(headroom=1.0, granularity=8,
                                                                                        min_capacity=8)
    hier = plan_capacities(s3, ForwardConfig(R, 64, **kw), policy=pol3)
    jhier = j_plan_capacities(s3, JForwardConfig(AXES3, R, 64, **kw), policy=jpol3)
    assert hier.level_capacities == (32, 24, 16) and hier.level_sizes == (2, 2, 2)
    assert _fields(hier) == _jfields(jhier)
    for plan, cfg in ((plan_capacities, ForwardConfig(R, 64, exchange="onehot", telemetry=True)),
                      (j_plan_capacities, JForwardConfig("data", R, 64, exchange="onehot", telemetry=True))):
        with pytest.raises(ValueError, match="no per-peer segment capacities"):
            plan(s, cfg)


def test_plan_capacities_drops_the_fields_the_reference_drops():
    """The reference rebuilds the config from a field list without
    ``pipeline_shards``, ``flow`` and ``emit_reserve``: a planned config
    runs unpipelined with the default reserve, on both packages."""
    s = _summary([[0, 0, 0, 0, 0, 0, 0, 8]], [40], caps=(8,))
    kw = dict(peer_capacity=8, telemetry=True, pipeline_shards=2, emit_reserve=5, overflow="retain",
              marshal="scatter", telemetry_window=5, telemetry_buckets=4)
    got = plan_capacities(s, ForwardConfig(R, 64, **kw))
    want = j_plan_capacities(s, JForwardConfig("data", R, 64, **kw))
    assert _fields(got) == _jfields(want)
    assert (got.pipeline_shards, got.emit_reserve, got.flow) == (1, -1, "open")
    assert (got.overflow, got.marshal, got.telemetry_window, got.telemetry_buckets) == ("retain", "scatter", 5, 4)


def test_autotune_requires_telemetry():
    with pytest.raises(ValueError, match="telemetry=True"):
        autotune_forward(lambda c: (None, None), ForwardConfig(R, 64))


# ------------------------------------------- end-to-end drifting hot-spot
@work_item
@dataclasses.dataclass
class Unit:
    val: torch.Tensor


PROTO = Unit(val=torch.zeros(()))


def drift_emits(rnd, num_ranks, n_emit, device=None):
    """``test_tune._drift_emits`` for all ranks: half of each rank's emits
    chase a hot destination that moves every second round."""
    me = torch.arange(num_ranks, device=device)[:, None]
    lane = torch.arange(n_emit, device=device)[None, :]
    hot = (rnd // 2) % num_ranks
    dest = torch.where(lane % 2 == 0, hot, (me + lane) % num_ranks).to(torch.int32)
    return Unit(val=torch.ones(num_ranks, n_emit, device=device)), dest


def make_run_burst(capacity=CAP, n_emit=N_EMIT, rounds=ROUNDS, device="cpu", proto=PROTO, emits=drift_emits):
    """The drift burst through the port's drive: round 0's emissions seed
    the queue, body round ``rnd`` emits round ``rnd + 1``'s (DISCARD from
    ``rounds`` on).  ``run_burst(cfg) -> (cumulative drops, ring)``."""
    ones = torch.ones(R, n_emit, dtype=torch.bool, device=device)

    def round_fn(q_in, acc, rnd):
        items, dest = emits(rnd + 1, R, n_emit, device=device)
        dest = dest if rnd + 1 < rounds else torch.full_like(dest, DISCARD)
        return enqueue(make_queue(proto, capacity, num_ranks=R, device=device), items, dest, ones), acc

    def run_burst(cfg):
        items, dest = emits(0, R, n_emit, device=device)
        q0 = enqueue(make_queue(proto, capacity, num_ranks=R, device=device), items, dest, ones)
        q, _acc, _rounds, _done, ring = run_until_done(round_fn, q0, torch.zeros(R, device=device), cfg,
                                                       max_rounds=rounds + 2)
        return int(q.drops.sum()), ring

    return run_burst


def _same_report(got, want):
    assert got.converged == want.converged and got.bursts == want.bursts
    for a, b in zip(got.steps, want.steps):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_autotune_converges_like_the_reference_flat(mesh8):
    kw = dict(exchange="padded", peer_capacity=8, telemetry=True, telemetry_window=ROUNDS + 2,
              telemetry_buckets=B)
    bounds = (N_EMIT,)
    with OT.capture() as tr:
        final, report = autotune_forward(make_run_burst(), ForwardConfig(R, CAP, **kw),
                                         policy=TunePolicy(headroom=1.25, granularity=8), bounds=bounds, max_bursts=6)
    jfinal, jreport = j_autotune_forward(_make_run_burst(mesh8, "data"), JForwardConfig("data", R, CAP, **kw),
                                         policy=JTunePolicy(headroom=1.25, granularity=8), bounds=bounds,
                                         max_bursts=6)
    _same_report(report, jreport)
    assert _fields(final) == _jfields(jfinal)
    assert report.converged and report.steps[0].drops > 0 and report.final_drops == 0
    assert final.peer_capacity >= report.steps[-1].demand_max[0]
    assert occupancy_waste_model((R,), (final.peer_capacity,), 36)["wire_B"] < \
        occupancy_waste_model((R,), bounds, 36)["wire_B"]
    span = tr.select(name="tune.autotune_forward")
    assert len(span) == 1 and span[0]["args"]["bursts"] == report.bursts and span[0]["args"]["converged"]
    replans = tr.select(name="tune.replan")
    assert [e["args"]["new"] for e in replans] == [list(s.planned) for s in report.steps if s.planned != s.capacities]


def test_autotune_converges_like_the_reference_hierarchical(mesh_pods222):
    kw = dict(exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(8, 8, 8), telemetry=True,
              telemetry_window=ROUNDS + 2, telemetry_buckets=B)
    bounds = (4 * N_EMIT, 2 * N_EMIT, N_EMIT)
    final, report = autotune_forward(make_run_burst(), ForwardConfig(R, CAP, **kw),
                                     policy=TunePolicy(headroom=1.25, granularity=8), bounds=bounds, max_bursts=8)
    jfinal, jreport = j_autotune_forward(_make_run_burst(mesh_pods222, AXES3), JForwardConfig(AXES3, R, CAP, **kw),
                                         policy=JTunePolicy(headroom=1.25, granularity=8), bounds=bounds,
                                         max_bursts=8)
    _same_report(report, jreport)
    assert _fields(final) == _jfields(jfinal)
    assert report.converged and report.steps[0].drops > 0 and report.final_drops == 0 and report.bursts > 2
    assert all(c <= b for c, b in zip(final.level_capacities, bounds))
    assert occupancy_waste_model((2, 2, 2), final.level_capacities, 36)["wire_B"] < \
        occupancy_waste_model((2, 2, 2), bounds, 36)["wire_B"]
    np.testing.assert_array_equal(np.asarray(report.steps[-1].demand_max), np.asarray(jreport.steps[-1].demand_max))
