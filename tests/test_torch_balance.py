"""The port's health remap, rebalancing and queue cycling against the JAX
reference, on the same seeded inputs.

* ``health_table`` for every mask of R=8 and ``remap_dest`` (DISCARD and
  out-of-range lanes included) against the JAX functions.
* Health-masked rounds (padded sort and scatter, 2×2×2, drop and retain)
  against the JAX rounds, with the unmasked round's calls; an all-True
  mask bit-equal to no mask (the port's own check: the JAX retain drive
  does not run on JAX 0.9.0, ROADMAP R4); ``rank_brownout`` under
  ``brownout_mask`` through the drive against the port's
  ``simulate_flat_retain(health=)``.
* ``rebalance``: every case of ``tests/test_core_rebalance.py``,
  ``test_rebalance_evacuates_unhealthy_rank``,
  ``test_rebalance_equalizes_load`` and ``test_rebalance_scatter_matches_sort``
  run through both packages: counts, drops, totals, dest and item bits on
  lanes < count equal, and each test's own claims on the port's result;
  the intra round calls the last tier only.
* ``deliver_by_cycling`` on flat, 4×2 and 2×2×2 in sort and scatter, drop
  and retain, with the telemetry ring: the absorbed queues and rings equal
  JAX's; one payload and one count ``ppermute`` a hop; pipelining refused.

Tolerance: none — everything here moves or counts data.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.core import ForwardConfig as JForwardConfig
from repro.core import WorkQueue as JWorkQueue
from repro.core import deliver_by_cycling as j_deliver_by_cycling
from repro.core import forward_work as j_forward_work
from repro.core import health_table as j_health_table
from repro.core import rebalance as j_rebalance
from repro.core import remap_dest as j_remap_dest
from repro.core import work_item as j_work_item
from repro.obs import trace as JOT
from repro_torch import chaos as TC
from repro_torch.core import (
    DISCARD,
    ForwardConfig,
    StackedCollectives,
    WorkQueue,
    cycle_step,
    deliver_by_cycling,
    forward_work,
    health_table,
    make_queue,
    rebalance,
    remap_dest,
    work_item,
)
from repro_torch.obs import trace as TOT

from test_torch_retain import scenario_drive

R, CAP = 8, 64
AXES = {"flat": "data", "2x4": ("node", "device"), "4x2": ("node", "device"), "2x2x2": ("pod", "node", "device")}
SIZES = {"flat": None, "2x4": (2, 4), "4x2": (4, 2), "2x2x2": (2, 2, 2)}
MESH = {"flat": "mesh8", "2x4": "mesh_nodes24", "4x2": "mesh_nodes42", "2x2x2": "mesh_pods222"}


@j_work_item
@dataclasses.dataclass
class JItem:
    val: jax.Array
    src: jax.Array


@work_item
@dataclasses.dataclass
class TItem:
    val: torch.Tensor
    src: torch.Tensor


def _cfgs(layout, **kw):
    """The JAX and the port config of one layout."""
    sizes = SIZES[layout]
    hier = dict(exchange="hierarchical", level_sizes=sizes) if sizes else {}
    kw = {**hier, **kw}
    return JForwardConfig(AXES[layout], R, CAP, **kw), ForwardConfig(R, CAP, **kw)


# ------------------------------------------------------------ the runners
_JAX_FNS = {}


def _leaves(x):
    if x is None:
        return []
    if dataclasses.is_dataclass(x):
        return [l for f in dataclasses.fields(x) for l in _leaves(getattr(x, f.name))]
    return [x]


def jax_run(request, layout, key, fn, val, dest, count, health=None):
    """Run ``fn(q, health) -> (queue, total, *extras)`` per rank on the
    layout's mesh, the queue built from the ``(R, CAP)`` inputs (``src`` =
    the rank).  Returns ``{val, src, dest, count, drops, total, extras}``
    with per-rank extras flattened to ``(R, -1)``."""
    axes = AXES[layout]
    if key not in _JAX_FNS:
        def kern(v, d, c, h):
            me = jax.lax.axis_index(axes)
            q = JWorkQueue(items=JItem(val=v, src=me * jnp.ones(CAP, jnp.int32)), dest=d, count=c[0],
                           drops=jnp.zeros((), jnp.int32))
            nq, total, *extra = fn(q, h)
            ex = tuple(x.reshape(-1) for e in extra for x in _leaves(e))
            return (nq.items.val, nq.items.src, nq.dest, nq.count[None], nq.drops[None], total[None]) + ex

        mesh = request.getfixturevalue(MESH[layout])
        _JAX_FNS[key] = jax.jit(compat.shard_map(kern, mesh=mesh, in_specs=(P(axes),) * 3 + (P(),),
                                                 out_specs=P(axes)))
    out = [np.asarray(x) for x in _JAX_FNS[key](*_args(val, dest, count, health))]
    return {"val": out[0].reshape(R, CAP), "src": out[1].reshape(R, CAP), "dest": out[2].reshape(R, CAP),
            "count": out[3], "drops": out[4], "total": int(out[5][0]), "extras": [x.reshape(R, -1) for x in out[6:]]}


def _args(val, dest, count, health):
    h = np.ones(R, bool) if health is None else np.asarray(health, bool)
    return (jnp.asarray(val.reshape(-1)), jnp.asarray(dest.reshape(-1)), jnp.asarray(count), jnp.asarray(h))


def port_queue(val, dest, count):
    return WorkQueue(
        items=TItem(val=torch.from_numpy(np.ascontiguousarray(val)),
                    src=torch.arange(R, dtype=torch.int32)[:, None].expand(R, CAP).contiguous()),
        dest=torch.from_numpy(np.ascontiguousarray(dest)), count=torch.from_numpy(count),
        drops=torch.zeros(R, dtype=torch.int32))


def port_result(nq, total, *extras):
    ex = [x.reshape(R, -1).numpy() for e in extras for x in _leaves(e)]
    return {"val": nq.items.val.numpy(), "src": nq.items.src.numpy(), "dest": nq.dest.numpy(),
            "count": nq.count.numpy(), "drops": nq.drops.numpy(), "total": int(total.reshape(-1)[0]) if total.dim() else int(total),
            "extras": ex}


def assert_same(got, want, *, extras=True):
    np.testing.assert_array_equal(got["count"], want["count"], err_msg="counts")
    np.testing.assert_array_equal(got["drops"], want["drops"], err_msg="drops")
    assert got["total"] == want["total"]
    for r in range(R):
        n = int(want["count"][r])
        np.testing.assert_array_equal(got["val"][r, :n].view(np.uint32), want["val"][r, :n].view(np.uint32))
        np.testing.assert_array_equal(got["src"][r, :n], want["src"][r, :n])
        np.testing.assert_array_equal(got["dest"][r, :n], want["dest"][r, :n])
    if extras:
        assert len(got["extras"]) == len(want["extras"])
        for i, (a, b) in enumerate(zip(got["extras"], want["extras"])):
            np.testing.assert_array_equal(a, b, err_msg=f"extra {i}")


def _random_inputs(seed, hot=None):
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(R, CAP)).astype(np.float32)
    dest = rng.integers(0, R, (R, CAP)).astype(np.int32)
    if hot is not None:
        dest[:, ::2] = hot
    count = rng.integers(8, 40, R).astype(np.int32)
    dest = np.where(np.arange(CAP)[None, :] < count[:, None], dest, DISCARD).astype(np.int32)
    return val, dest, count


# ------------------------------------------------------------ health law
def test_health_table_every_mask_equals_reference():
    """All 256 masks of R=8: the table equals JAX's and the law."""
    for bits in range(256):
        h = np.array([(bits >> i) & 1 for i in range(R)], bool)
        got = health_table(torch.from_numpy(h)).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_health_table(jnp.asarray(h))))
        healthy = np.nonzero(h)[0]
        want = np.arange(R) if healthy.size == 0 else np.where(h, np.arange(R), healthy[np.arange(R) % max(healthy.size, 1)])
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32


def test_remap_dest_equals_reference():
    rng = np.random.default_rng(3)
    dest = rng.integers(-1, R + 2, (R, CAP)).astype(np.int32)  # DISCARD, valid and out-of-range lanes
    for bits in (0, 0b11111111, 0b11011011, 0b00000001, 0b10100110):
        h = np.array([(bits >> i) & 1 for i in range(R)], bool)
        got = remap_dest(torch.from_numpy(dest), torch.from_numpy(h)).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_remap_dest(jnp.asarray(dest), jnp.asarray(h))))
        assert (got[dest == DISCARD] == DISCARD).all()


# ------------------------------------------------------- masked rounds
MASKED = [("flat", "sort"), ("flat", "scatter"), ("2x2x2", "sort"), ("2x2x2", "scatter")]


@pytest.mark.parametrize("overflow", ["drop", "retain"])
@pytest.mark.parametrize("layout,marshal", MASKED, ids=[f"{a}-{b}" for a, b in MASKED])
def test_masked_round_equals_reference(request, layout, marshal, overflow):
    """A round with ranks 2 and 5 unhealthy against the JAX round (ages
    too under retain), the same calls as the unmasked round, and nothing
    delivered to the drained ranks."""
    h = np.ones(R, bool)
    h[[2, 5]] = False
    jcfg, tcfg = _cfgs(layout, marshal=marshal, overflow=overflow)
    val, dest, count = _random_inputs(11, hot=2)
    retain = overflow == "retain"

    def fn(q, hh):
        out = j_forward_work(q, jcfg, health=hh)
        return (out[0], out[1]) + ((out[2],) if retain else ())

    want = jax_run(request, layout, ("masked", jcfg), fn, val, dest, count, health=h)
    comm, plain = StackedCollectives(), StackedCollectives()
    out = forward_work(port_queue(val, dest, count), tcfg, health=torch.from_numpy(h), comm=comm)
    got = port_result(out[0], out[1], *out[2:])
    assert_same(got, want)
    forward_work(port_queue(val, dest, count), tcfg, comm=plain)
    assert comm.calls == plain.calls
    arrived = got["count"] - (((got["dest"] >= 0) & (np.arange(CAP)[None] < got["count"][:, None])).sum(1))
    assert arrived[2] == 0 and arrived[5] == 0 and arrived.sum() > 0


@pytest.mark.parametrize("layout", ["flat", "2x2x2"])
def test_all_true_mask_is_bitidentical_to_no_mask(layout):
    """``health=None`` and an all-True mask: the same round, every lane."""
    _j, cfg = _cfgs(layout, overflow="retain", telemetry=True)
    val, dest, count = _random_inputs(5, hot=3)
    a = forward_work(port_queue(val, dest, count), cfg)
    b = forward_work(port_queue(val, dest, count), cfg, health=torch.ones(R, dtype=torch.bool))
    for x, y in zip(_leaves(a[0]) + list(a[1:3]) + _leaves(a[3]), _leaves(b[0]) + list(b[1:3]) + _leaves(b[3])):
        assert torch.equal(x, y)


def test_all_true_mask_drive_is_bitidentical_to_no_mask():
    """``test_all_healthy_mask_is_bitidentical_to_no_mask`` (which fails on
    JAX 0.9.0, R4) on the port's retain drive of ``capacity_drought``."""
    sc = TC.capacity_drought(R)
    cfg = ForwardConfig(R, 128, peer_capacity=2, overflow="retain")
    a = scenario_drive(sc, cfg)
    b = scenario_drive(sc, cfg, health=np.ones(R, bool))
    for k in ("delivered", "rounds", "retained_trace", "age_trace", "drops"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    assert torch.equal(a["final_q"].dest, b["final_q"].dest)


@pytest.mark.parametrize("marshal", ["sort", "scatter"])
@pytest.mark.parametrize("case", ["brownout", "constant"])
def test_health_drive_equals_twin(case, marshal):
    """``rank_brownout`` under ``brownout_mask`` (ranks 2 and 5 go dark at
    round 3), and ``capacity_drought`` drained from the start, through the
    port's retain drive against ``simulate_flat_retain(health=)`` forward
    for forward; nothing is lost, and a rank drained from the start
    receives nothing."""
    if case == "brownout":
        sc, health = TC.rank_brownout(R), TC.brownout_mask(R)
    else:
        sc, health = TC.capacity_drought(R), np.ones(R, bool)
        health[[2, 5]] = False
    sim = TC.simulate_flat_retain(sc, peer_capacity=2, capacity=128, health=health)
    res = scenario_drive(sc, ForwardConfig(R, 128, peer_capacity=2, marshal=marshal, overflow="retain"),
                         health=health)
    np.testing.assert_array_equal(res["delivered"], sim["delivered"])
    assert (res["rounds"], res["drops"], res["done"]) == (sim["rounds"], 0, True) and sim["done"]
    assert res["retained_trace"] == sim["retained_trace"] and res["age_trace"] == sim["age_trace"]
    assert int(res["delivered"][:, 0].sum()) == sc.emitted
    if case == "constant":
        assert res["delivered"][2].sum() == 0 and res["delivered"][5].sum() == 0


# ------------------------------------------------------------- rebalance
def _queue_from(count, dest_of, val_of):
    me, k = np.arange(R)[:, None], np.arange(CAP)[None, :]
    count = np.asarray(count, np.int32)
    dest = np.where(k < count[:, None], dest_of(me, k), DISCARD).astype(np.int32)
    return np.broadcast_to(val_of(me, k), (R, CAP)).astype(np.float32), dest, count


RESIDENT = lambda me, k: np.full(np.broadcast(me, k).shape, DISCARD)
LANE_VAL = lambda me, k: k + 0 * me

REBALANCE_CASES = {
    # test_core_rebalance.py
    "preserves_pending": ("flat", "global", {}, _queue_from(
        5 + np.array([30, 0, 0, 0, 0, 0, 0, 0]), lambda me, k: np.where(k < 5, (me + 1) % R, DISCARD),
        lambda me, k: np.where(k < 5, 1000.0 + me * 100.0 + k, 5000.0 + k))),
    "all_resident": ("flat", "global", {}, _queue_from([40, 8, 0, 0, 0, 0, 0, 0], RESIDENT, LANE_VAL)),
    "node_local_skew": ("2x4", "global", {}, _queue_from([20, 0, 0, 0, 20, 0, 0, 0], RESIDENT, LANE_VAL)),
    "moves_only_surplus": ("2x4", "global", {}, _queue_from([10] * 4 + [0] * 4, RESIDENT, LANE_VAL)),
    "intra_zero_slow": ("2x2x2", "intra", {}, _queue_from(
        np.where(np.arange(R) % 2 == 0, 12, 0), RESIDENT, LANE_VAL)),
    "intra_in_group_and_cross": ("2x4", "intra", {}, _queue_from(
        np.where(np.arange(R) % 4 == 0, 4, 2),
        lambda me, k: np.select([k == 0, k == 1], [(me // 4) * 4 + (me + 1) % 4, (me + 4) % R], DISCARD),
        lambda me, k: me * 100.0 + k)),
    "3level_equalizes": ("2x2x2", "global", dict(level_capacities=(4 * CAP, 2 * CAP, CAP)), _queue_from(
        [41, 0, 0, 7, 0, 0, 0, 0], RESIDENT, LANE_VAL)),
    # test_core_forwarding.py::test_rebalance_equalizes_load
    "equalizes_load": ("flat", "global", {}, _queue_from([40, 8, 0, 0, 0, 0, 0, 0], RESIDENT,
                                                         lambda me, k: me * 1000.0 + k)),
    # test_core_scatter.py::test_rebalance_scatter_matches_sort (both scopes, both marshals)
    "scatter_global": ("2x2x2", "global", dict(marshal="scatter"), _queue_from(
        np.where(np.arange(R) % 2 == 0, 40, 2), RESIDENT, lambda me, k: k + me * 1000.0)),
    "scatter_intra": ("2x2x2", "intra", dict(marshal="scatter"), _queue_from(
        np.where(np.arange(R) % 2 == 0, 40, 2), RESIDENT, lambda me, k: k + me * 1000.0)),
    # beyond the reference tests: intra retain with the fast clamp firing
    # (retained rows translated back to global ranks), and telemetry
    "intra_retain_clamped": ("2x4", "intra", dict(overflow="retain", level_capacities=(64, 3)), _queue_from(
        np.where(np.arange(R) % 4 == 0, 30, 3),
        lambda me, k: np.where(k == 1, (me + 4) % R, DISCARD), lambda me, k: me * 100.0 + k)),
    "global_telemetry": ("2x2x2", "global", dict(telemetry=True), _queue_from(
        [41, 0, 0, 7, 0, 3, 0, 0], RESIDENT, LANE_VAL)),
    "intra_telemetry": ("2x2x2", "intra", dict(telemetry=True), _queue_from(
        np.where(np.arange(R) % 2 == 0, 12, 1), RESIDENT, LANE_VAL)),
}


@pytest.mark.parametrize("case", sorted(REBALANCE_CASES))
def test_rebalance_equals_reference(request, case):
    layout, scope, kw, (val, dest, count) = REBALANCE_CASES[case]
    jcfg, tcfg = _cfgs(layout, **kw)

    def fn(q, _h):
        return j_rebalance(q, jcfg, scope=scope)

    want = jax_run(request, layout, ("rebalance", case), fn, val, dest, count)
    comm = StackedCollectives()
    out = rebalance(port_queue(val, dest, count), tcfg, scope=scope, comm=comm)
    got = port_result(*out)
    assert_same(got, want)
    n_res = int(((np.arange(CAP)[None] < count[:, None]) & (dest == DISCARD)).sum())
    pending = int(count.sum()) - n_res
    if kw.get("overflow") != "retain" and case != "intra_in_group_and_cross":
        assert int(got["count"].sum()) == int(count.sum()) == got["total"] and got["drops"].sum() == 0
    # each reference test's own claim, on the port
    counts, src = got["count"], got["src"]
    if case == "preserves_pending":
        for r in range(R):
            vals = got["val"][r, :counts[r]]
            assert sorted(v for v in vals if v < 5000) == [1000.0 + ((r - 1) % R) * 100.0 + k for k in range(5)]
            assert 0 <= counts[r] - 5 <= 4
    if case in ("all_resident", "equalizes_load"):
        assert counts.max() <= -(-48 // R)
    if case == "node_local_skew":
        assert counts.tolist() == [5] * R
        assert all((src[r, :counts[r]] // 4 == r // 4).all() for r in range(R))
    if case == "moves_only_surplus":
        assert counts.tolist() == [5] * R
        assert sum(int((src[r, :counts[r]] // 4 != r // 4).sum()) for r in range(R)) == 20
    if case == "intra_zero_slow":
        assert counts.tolist() == [6] * R and got["total"] == 48
        assert all((src[r, :counts[r]] // 2 == r // 2).all() for r in range(R))
    if case == "intra_in_group_and_cross":
        assert got["drops"].sum() == 0 and got["total"] == 20 == counts.sum()
        for r in range(R):
            vals, dests = got["val"][r, :counts[r]].tolist(), got["dest"][r, :counts[r]].tolist()
            assert ((r // 4) * 4 + (r - 1) % 4) * 100.0 in vals
            assert [d for v, d in zip(vals, dests) if v == r * 100.0 + 1.0] == [(r + 4) % R]
    if case == "3level_equalizes":
        assert counts.sum() == 48 and counts.max() <= -(-48 // R)
    if case == "intra_retain_clamped":
        held = (np.arange(CAP)[None] < counts[:, None]) & (got["dest"] >= 0)
        assert held.sum() > pending and (got["dest"][held] // 4 == np.nonzero(held)[0] // 4).sum() > 0
    # the intra round calls the last tier only; the total is the one global psum
    if scope == "intra":
        fast = len(SIZES[layout]) - 1
        tiers = sorted((c.kind, -1 if c.tier is None else c.tier) for c in comm.calls.elements())
        assert tiers == sorted([("all_gather", fast), ("all_to_all", fast), ("all_to_all", fast),
                                ("psum", fast), ("psum", -1)]), tiers


def test_rebalance_scatter_matches_sort():
    """Port scatter == port sort on the reference test's queue, both scopes."""
    _layout, _scope, _kw, (val, dest, count) = REBALANCE_CASES["scatter_global"]
    for scope in ("global", "intra"):
        res = [port_result(*rebalance(port_queue(val, dest, count), _cfgs("2x2x2", marshal=m)[1], scope=scope))
               for m in ("sort", "scatter")]
        assert_same(res[1], res[0])


def test_rebalance_evacuates_unhealthy_rank(request):
    """The drain recipe against the JAX round: rank 3 unhealthy, every rank
    holding 16 residents; rank 3 ends empty, nothing dropped, all conserved;
    intra-scope health is refused."""
    h = np.ones(R, bool)
    h[3] = False
    jcfg = JForwardConfig("data", R, 128, peer_capacity=32, exchange="padded")
    tcfg = ForwardConfig(R, 128, peer_capacity=32, exchange="padded")
    rng = np.random.default_rng(2)
    val = rng.normal(size=(R, 128)).astype(np.float32)
    dest, count = np.full((R, 128), DISCARD, np.int32), np.full(R, 16, np.int32)

    global CAP
    saved, CAP = CAP, 128
    try:
        want = jax_run(request, "flat", "evacuate", lambda q, hh: j_rebalance(q, jcfg, health=hh), val, dest, count,
                       health=h)
        got = port_result(*rebalance(port_queue(val, dest, count), tcfg, health=torch.from_numpy(h)))
        assert_same(got, want)
    finally:
        CAP = saved
    assert got["count"][3] == 0 and got["drops"].sum() == 0 and got["count"].sum() == R * 16 == got["total"]
    hier = ForwardConfig(R, 128, exchange="hierarchical", fast_size=4)
    with pytest.raises(ValueError, match="global"):
        rebalance(make_queue(TItem(val=torch.zeros(()), src=torch.zeros((), dtype=torch.int32)), 128, num_ranks=R,
                             device="cpu"), hier, scope="intra", health=torch.ones(R, dtype=torch.bool))


def test_rebalance_refusals():
    q = make_queue(TItem(val=torch.zeros(()), src=torch.zeros((), dtype=torch.int32)), CAP, num_ranks=R, device="cpu")
    with pytest.raises(ValueError, match="intra"):
        rebalance(q, ForwardConfig(R, CAP), scope="intra")
    with pytest.raises(ValueError, match="scope"):
        rebalance(q, ForwardConfig(R, CAP), scope="bogus")


# --------------------------------------------------------------- cycling
def _cycle_inputs(overflow):
    """Six rows a rank to ``(3·me + k) % R``; under retain nine more to rank
    0, so rank 0's absorbed queue fills and the rest is parked."""
    n = 6 if overflow == "drop" else 15
    me, k = np.arange(R)[:, None], np.arange(CAP)[None, :]
    d = np.where(k < 6, (me * 3 + k) % R, 0)
    val = (me * 100 + k).astype(np.float32)
    return _queue_from(np.full(R, n), lambda me_, k_: d, lambda me_, k_: val)


CYCLE = [(l, m, o) for l in ("flat", "4x2", "2x2x2") for m in ("sort", "scatter") for o in ("drop", "retain")]


@pytest.mark.parametrize("layout,marshal,overflow", CYCLE, ids=["-".join(c) for c in CYCLE])
def test_deliver_by_cycling_equals_reference(request, layout, marshal, overflow):
    """The absorbed queues and the per-hop ring against JAX's; the same
    queues with telemetry off; R payload and R count ``ppermute`` calls."""
    jcfg, tcfg = _cfgs(layout, marshal=marshal, overflow=overflow, telemetry=True, telemetry_window=2)
    val, dest, count = _cycle_inputs(overflow)

    def fn(q, _h):
        absorbed, total, ring = j_deliver_by_cycling(q, jcfg)
        return absorbed, total, ring.stats, ring.pos[None]

    want = jax_run(request, layout, ("cycle", jcfg), fn, val, dest, count)
    comm = StackedCollectives()
    absorbed, total, ring = deliver_by_cycling(port_queue(val, dest, count), tcfg, comm=comm)
    got = port_result(absorbed, total, ring.stats, ring.pos)
    assert_same(got, want)
    assert (ring.pos == R).all() and ring.window == R
    plain = deliver_by_cycling(port_queue(val, dest, count), _cfgs(layout, marshal=marshal, overflow=overflow)[1])
    assert_same(port_result(*plain), got, extras=False)
    kinds = sorted((c.kind, c.shape) for c in comm.calls.elements())
    W = 2  # val + src words
    assert kinds == sorted([("ppermute", (R, CAP, W + 1))] * R + [("ppermute", (R,))] * R + [("psum", (R,))])
    if overflow == "retain":
        assert got["drops"].sum() == 0 and got["total"] == int(count.sum())
        assert got["count"][0] == CAP and (got["dest"][1:] >= 0).any()  # rows parked at their sources
    else:
        assert got["drops"][0] == 0 and got["total"] == int(count.sum())


def test_cycling_delivers_what_the_padded_round_delivers():
    """Each rank's delivered set, sorted, equals the padded round's."""
    val, dest, count = _cycle_inputs("drop")
    for marshal in ("sort", "scatter"):
        cfg = ForwardConfig(R, CAP, marshal=marshal)
        absorbed, total = deliver_by_cycling(port_queue(val, dest, count), cfg)
        nq, ftotal = forward_work(port_queue(val, dest, count), cfg)
        assert int(total) == int(ftotal) == 48
        for r in range(R):
            a = np.sort(absorbed.items.val[r, :absorbed.count[r]].numpy())
            b = np.sort(nq.items.val[r, :nq.count[r]].numpy())
            np.testing.assert_array_equal(a, b)


def test_cycle_step_ships_one_packed_buffer_and_refuses_pipelining():
    """A hop: one ``ppermute`` of the packed ``(R, C, W+1)`` buffer and one
    of the count, nothing else; ``pipeline_shards > 1`` is refused."""
    val, dest, count = _cycle_inputs("drop")
    q = port_queue(val, dest, count)
    absorbed = make_queue(TItem(val=torch.zeros(()), src=torch.zeros((), dtype=torch.int32)), CAP, num_ranks=R,
                          device="cpu")
    comm = StackedCollectives()
    cycle_step(q, absorbed, ForwardConfig(R, CAP), comm=comm)
    assert sorted((c.kind, c.shape) for c in comm.calls.elements()) == [("ppermute", (R,)), ("ppermute", (R, CAP, 3))]
    with pytest.raises(ValueError, match="cycling"):
        cycle_step(q, absorbed, ForwardConfig(R, CAP, pipeline_shards=2))


def test_route_events_match_reference(mesh8):
    """``route.rebalance`` and ``route.deliver_by_cycling``: one event
    each, with the reference's arguments."""
    jcfg, tcfg = _cfgs("flat")
    val, dest, count = _cycle_inputs("drop")

    def kern(v, d, c):
        q = JWorkQueue(items=JItem(val=v, src=jnp.zeros(CAP, jnp.int32)), dest=d, count=c[0],
                       drops=jnp.zeros((), jnp.int32))
        nq, _ = j_rebalance(q, jcfg)
        absorbed, total = j_deliver_by_cycling(nq, jcfg)
        return absorbed.count[None], total

    with JOT.capture() as jtr:
        jax.jit(compat.shard_map(kern, mesh=mesh8, in_specs=(P("data"),) * 3, out_specs=(P("data"), P()))).lower(
            *_args(val, dest, count, None)[:3])
    with TOT.capture() as ttr:
        nq, _ = rebalance(port_queue(val, dest, count), tcfg)
        deliver_by_cycling(nq, tcfg)
    for name in ("route.rebalance", "route.deliver_by_cycling"):
        (j,), (t,) = jtr.select(name=name), ttr.select(name=name)
        assert t["cat"] == j["cat"] == TOT.CAT_ROUTE and t["args"] == j["args"], name


def test_rafi_context_drive_takes_health():
    """``RafiContext.run_until_done``'s drive takes the mask as a third
    argument (the reference's ``with_health``): rank 3 receives nothing."""
    from repro_torch.core import RafiContext

    ctx = RafiContext(R, TItem(val=torch.zeros(()), src=torch.zeros((), dtype=torch.int32)), capacity=CAP,
                      device="cpu")
    val, dest, count = _cycle_inputs("drop")
    got = {}

    def round_fn(q_in, aux, rnd):
        empty = WorkQueue(items=q_in.items, dest=torch.full_like(q_in.dest, DISCARD),
                          count=torch.zeros_like(q_in.count), drops=torch.zeros_like(q_in.drops))
        return empty, aux + q_in.count

    h = torch.ones(R, dtype=torch.bool)
    h[3] = False
    for label, args in (("plain", ()), ("masked", (h,))):
        q, aux, rounds, done = ctx.run_until_done(round_fn)(port_queue(val, dest, count), torch.zeros(R, dtype=torch.int32),
                                                            *args)
        assert done and int(aux.sum()) == int(count.sum())
        got[label] = aux
    assert got["plain"][3] > 0 and got["masked"][3] == 0
