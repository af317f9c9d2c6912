"""The port's chaos driver (``repro_torch.chaos.run_scenario``) against
``repro.chaos`` and the numpy twins.

* Drop mode, where the JAX drive runs (``padded`` on every scenario,
  ``onehot`` and the 2×4 hierarchical route): the port's accounting dict
  equals the reference's key for key — checksums, rounds, drops, ``lost``
  and every per-round ring trace.
* Retain mode (whose JAX drive does not run on this JAX, ROADMAP R4): the
  flat and pipelined drives follow ``simulate_flat_retain`` round for
  round, the hierarchical drives deliver ``expected_by_rank``, the ring
  accounts for every delivery, and ``age_max`` respects the drain bound.
* The ragged exchange, no ``peer_capacity``, drops nothing it does not
  count: its drop-mode drive conserves every emission.

Tolerance: none — every value here is moved or counted, never reduced.
"""
import numpy as np
import pytest

from repro.chaos import driver as JD
from repro.chaos import scenarios as JS
from repro.roofline.analysis import spill_drain_model
from repro_torch import chaos as TC

pytestmark = pytest.mark.chaos

R, S, FLAT_CAP, HIER_CAP = 8, 2, 128, 256
SCENARIOS = {sc.name: sc for sc in TC.all_scenarios(R)}
J_SCENARIOS = {sc.name: sc for sc in JS.all_scenarios(R)}
SCENARIO_IDS = sorted(SCENARIOS)
CPU = dict(device="cpu")


def assert_same_dict(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k], k
        else:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.shape == b.shape and np.array_equal(a, b), (k, got[k], want[k])


# ------------------------------------------------------ drop mode, with JAX
@pytest.mark.parametrize("name", SCENARIO_IDS)
def test_drop_mode_conserves_padded(mesh8, name):
    kw = dict(capacity=FLAT_CAP, peer_capacity=S, overflow="drop", max_rounds=64)
    res = TC.run_scenario(R, SCENARIOS[name], **kw, **CPU)
    assert res["lost"] == 0 and res["done"]
    assert_same_dict(res, JD.run_scenario(mesh8, J_SCENARIOS[name], **kw))


def test_drop_mode_conserves_onehot(mesh8):
    kw = dict(capacity=32, overflow="drop", exchange="onehot", max_rounds=64)
    res = TC.run_scenario(R, SCENARIOS["convergecast"], **kw, **CPU)
    assert res["drops"] > 0 and res["lost"] == 0
    assert_same_dict(res, JD.run_scenario(mesh8, J_SCENARIOS["convergecast"], **kw))


def test_drop_mode_conserves_hierarchical(mesh_nodes24):
    kw = dict(capacity=FLAT_CAP, exchange="hierarchical", level_capacities=(2, 2), overflow="drop", max_rounds=64)
    res = TC.run_scenario(R, SCENARIOS["convergecast"], level_sizes=(2, 4), **kw, **CPU)
    assert res["drops"] > 0 and res["lost"] == 0
    assert_same_dict(res, JD.run_scenario(mesh_nodes24, J_SCENARIOS["convergecast"], axis_name=("node", "device"),
                                          **kw))


def test_ragged_exchange_is_refused():
    """Despite its name, kept from when the ragged case was refused: the
    ragged drop-mode drive of ``convergecast`` conserves every emission, its receiver cuts counted
    as drops (``tests/test_torch_ragged.py`` holds it against the JAX drive)."""
    res = TC.run_scenario(R, SCENARIOS["convergecast"], capacity=32, overflow="drop", exchange="ragged", **CPU)
    assert res["lost"] == 0 and res["done"] and res["drops"] > 0
    assert res["delivered_total"] + res["drops"] == res["emitted"]


def test_scenario_rank_count_must_match():
    with pytest.raises(ValueError, match="laid out for 8 ranks"):
        TC.run_scenario(4, SCENARIOS["convergecast"], capacity=FLAT_CAP, **CPU)


# ------------------------------------------------------- flat retain, twin
def _assert_twin(res, sim, sc):
    np.testing.assert_array_equal(res["delivered"], TC.expected_by_rank(sc))
    np.testing.assert_array_equal(res["delivered"], sim["delivered"])
    assert res["drops"] == 0 and res["lost"] == 0 and res["done"] and res["resident"] == 0
    assert res["rounds"] == sim["rounds"]
    assert res["retained_rows"] == sim["retained_rows"] and res["age_max"] == sim["age_max"]


@pytest.mark.parametrize("shards", [1, 2], ids=["bulk", "pipelined"])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
@pytest.mark.parametrize("name", SCENARIO_IDS)
def test_flat_retain_matches_numpy_twin(name, marshal, shards):
    """``test_flat_retain_matches_numpy_twin`` and
    ``test_flat_retain_pipelined_matches_numpy_twin``: deliveries, rounds,
    retained rows and worst age equal ``simulate_flat_retain``'s."""
    sc = SCENARIOS[name]
    sim = TC.simulate_flat_retain(sc, peer_capacity=S, capacity=FLAT_CAP)
    assert sim["done"] and sim["drops"] == 0
    res = TC.run_scenario(R, sc, capacity=FLAT_CAP, peer_capacity=S, overflow="retain", marshal=marshal,
                          pipeline_shards=shards, **CPU)
    _assert_twin(res, sim, sc)


@pytest.mark.parametrize("name", SCENARIO_IDS)
def test_flat_retain_trace_matches_twin_per_round(name):
    sc = SCENARIOS[name]
    sim = TC.simulate_flat_retain(sc, peer_capacity=S, capacity=FLAT_CAP)
    res = TC.run_scenario(R, sc, capacity=FLAT_CAP, peer_capacity=S, overflow="retain", **CPU)
    assert len(res["retained_trace"]) == res["rounds"] + 1
    np.testing.assert_array_equal(res["retained_trace"], sim["retained_trace"])
    np.testing.assert_array_equal(res["age_trace"], sim["age_trace"])
    assert int(np.sum(res["recv_trace"])) == res["delivered_total"]


def test_flat_retain_age_respects_drain_bound():
    """Bounded delay: the oldest row waits at most the reference's
    ``spill_drain_model`` age bound for the backlog plus the emission span."""
    sc = SCENARIOS["convergecast"]
    res = TC.run_scenario(R, sc, capacity=FLAT_CAP, peer_capacity=S, overflow="retain", **CPU)
    backlog = sc.rounds * sc.emits_per_round
    bound = spill_drain_model(backlog, S)["age_bound"] + sc.rounds
    assert 0 < res["age_max"] <= bound, (res["age_max"], bound)


def test_retain_beats_drop_where_it_matters():
    sc = TC.convergecast(R)
    kw = dict(capacity=FLAT_CAP, peer_capacity=S, max_rounds=64, **CPU)
    dropped = TC.run_scenario(R, sc, overflow="drop", **kw)
    retained = TC.run_scenario(R, sc, overflow="retain", **kw)
    assert dropped["drops"] > 0.2 * sc.emitted
    assert retained["drops"] == 0 and retained["lost"] == 0 and retained["delivered_total"] == sc.emitted
    assert retained["rounds"] > dropped["rounds"]


# ---------------------------------------------------- hierarchical retain
HIER = [((2, 4), (8, 8)), ((2, 2, 2), (8, 8, 8))]


@pytest.mark.parametrize("sizes,caps", HIER, ids=["2level", "3level"])
@pytest.mark.parametrize("name", SCENARIO_IDS)
def test_hierarchical_retain_is_lossless(name, sizes, caps):
    sc = SCENARIOS[name]
    res = TC.run_scenario(R, sc, capacity=HIER_CAP, exchange="hierarchical", level_sizes=sizes, level_capacities=caps,
                          overflow="retain", marshal="sort", max_rounds=128, **CPU)
    np.testing.assert_array_equal(res["delivered"], TC.expected_by_rank(sc))
    assert res["drops"] == 0 and res["lost"] == 0 and res["done"] and res["resident"] == 0


@pytest.mark.parametrize("sizes,caps", HIER, ids=["2level", "3level"])
def test_hierarchical_retain_scatter_and_ring(sizes, caps):
    """The scatter marshal on the worst-case convergecast, and the ring's
    arrivals sum to exactly the delivered total, retention fired and
    drained, and the summary agrees with the trace it was folded from."""
    sc = SCENARIOS["convergecast"]
    kw = dict(capacity=HIER_CAP, exchange="hierarchical", level_sizes=sizes, level_capacities=caps,
              overflow="retain", max_rounds=128, **CPU)
    res = TC.run_scenario(R, sc, marshal="scatter", **kw)
    np.testing.assert_array_equal(res["delivered"], TC.expected_by_rank(sc))
    assert res["drops"] == 0 and res["lost"] == 0 and res["done"]
    assert len(res["recv_trace"]) == res["rounds"] + 1
    assert int(np.sum(res["recv_trace"])) == res["delivered_total"] == sc.emitted
    assert res["retained_trace"][-1] == 0 and int(np.sum(res["retained_trace"])) > 0
    assert res["retained_rows"] == int(np.sum(res["retained_trace"]))
    assert res["age_max"] == int(np.max(res["age_trace"]))
    sort = TC.run_scenario(R, sc, marshal="sort", **kw)
    assert all(np.array_equal(np.asarray(res[k]), np.asarray(sort[k])) for k in res)
