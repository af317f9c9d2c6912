"""The port's flight recorder (``repro_torch.telemetry``) against the JAX
reference.

* One ``forward_work`` round with ``telemetry=True`` on both packages, the
  same queue (``helpers.make_rays`` rows, destinations and counts from a
  numpy seed): every field of the port's ``RoundStats`` equals the JAX
  round's rank-stacked stats, bit for bit — flat padded (sort and scatter,
  drop and retain, roomy and tight peer slots), onehot, and the
  hierarchical route on 2×4 and 2×2×2 (both marshals, both overflow modes,
  tight and ample tier capacities) — and the queue's counts and drops
  agree.  In drop mode ``stage_drops + recv_drops`` is the queue's drops.
* The reference's pinned cases: the 48 + 16 + 8 per-stage drops of a
  (2, 2, 2) route, an extent-1 tier that records nothing, the bucketing law
  at ``occ == capacity`` with ``capacity % (B−1) != 0``, and the window-4
  ring of a 5-hop drive (``pos`` 6, ``demand_total [3, 0, 3, 3]``), the
  last also against the JAX drive's ring.
* The host view: ``summarize``, ``ring_trace`` and ``demand_quantile`` of a
  port ring equal the JAX functions fed the same ring; a retain drive's
  ``ring_trace`` equals the numpy oracle's traces round for round.
* Telemetry and tracing add no collective call.

Tolerance: none — everything here counts data.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from helpers import make_rays, ray_proto
from repro import compat
from repro import telemetry as JTM
from repro.core import DISCARD as J_DISCARD
from repro.core import ForwardConfig as JForwardConfig
from repro.core import WorkQueue as JWorkQueue
from repro.core import enqueue as j_enqueue
from repro.core import forward_work as j_forward_work
from repro.core import make_queue as j_make_queue
from repro.core import run_until_done as j_run_until_done
from repro.launch.mesh import make_pod_mesh
from repro_torch import chaos as TC
from repro_torch import telemetry as TM
from repro_torch.core import (
    DISCARD,
    ForwardConfig,
    RafiContext,
    StackedCollectives,
    WorkQueue,
    enqueue,
    forward_work,
    make_queue,
    queue_from_reference,
    run_until_done,
    work_item,
)
from repro_torch.obs import trace as OT

from test_torch_retain import _FIELDS, _tproto, scenario_drive

R, CAP, B = 8, 64, 8
AXES2, AXES3 = ("node", "device"), ("pod", "node", "device")
_STAT_FIELDS = [f.name for f in dataclasses.fields(TM.RoundStats)]


# ---------------------------------------------------------------- plumbing
def _inputs(kind, seed=1):
    """(dest (R, CAP), counts (R,)): ``spread`` is ``test_telemetry.
    _spread_dest`` (counts 4..12, a 40% hot spot on rank 3); ``hotspot``
    floods rank 0 with every lane; ``random`` mixes DISCARD and
    out-of-range destinations with counts 0..CAP."""
    rng = np.random.default_rng(seed)
    if kind == "spread":
        counts = rng.integers(4, 13, R).astype(np.int32)
        dest = rng.integers(0, R, (R, CAP)).astype(np.int32)
        return np.where(rng.random((R, CAP)) < 0.4, 3, dest).astype(np.int32), counts
    if kind == "hotspot":
        return np.zeros((R, CAP), np.int32), np.full(R, CAP, np.int32)
    return rng.integers(-1, R + 2, (R, CAP)).astype(np.int32), rng.integers(0, CAP + 1, R).astype(np.int32)


_JAX_FNS = {}


def _mesh_of(cfg):
    if cfg.exchange != "hierarchical":
        return compat.make_mesh((R,), ("data",)), "data"
    sizes = tuple(cfg.level_sizes)
    return (make_pod_mesh(*sizes), AXES3) if len(sizes) == 3 else (compat.make_mesh(sizes, AXES2), AXES2)


def jax_stats(cfg, dest, counts):
    """The JAX round of ``test_telemetry._forward_fn`` (any overflow mode):
    ``(count, drops, {field: (R, …)})`` as numpy."""
    if cfg not in _JAX_FNS:
        mesh, axes = _mesh_of(cfg)
        proto = JTM.make_stats(JTM.num_tiers(cfg), cfg.telemetry_buckets)

        def fwd(d, c):
            q = JWorkQueue(items=make_rays(CAP), dest=d, count=c[0], drops=jnp.zeros((), jnp.int32))
            res = j_forward_work(q, cfg)
            return res[0].count[None], res[0].drops[None], JTM.stack_ring(res[-1])

        _JAX_FNS[cfg] = jax.jit(compat.shard_map(
            fwd, mesh=mesh, in_specs=(P(axes), P(axes)),
            out_specs=(P(axes), P(axes), jax.tree.map(lambda _: P(axes), proto))))
    cnt, drops, st = _JAX_FNS[cfg](jnp.asarray(dest).reshape(-1), jnp.asarray(counts))
    return np.asarray(cnt), np.asarray(drops), {k: np.asarray(getattr(st, k)) for k in _STAT_FIELDS}


def _port_queue(dest, counts):
    rays = make_rays(CAP)
    fields = {k: np.tile(np.asarray(getattr(rays, k)), (R,) + (1,) * (np.asarray(getattr(rays, k)).ndim - 1))
              for k in _FIELDS}
    return queue_from_reference(fields, dest.reshape(-1), counts, np.zeros(R, np.int32), R, _tproto(), device="cpu")


def port_stats(cfg, dest, counts, comm=None):
    res = forward_work(_port_queue(dest, counts), cfg, comm=comm)
    st = res[-1]
    return res[0].count.numpy(), res[0].drops.numpy(), {k: getattr(st, k).numpy() for k in _STAT_FIELDS}


def _assert_same_stats(got, want):
    for i, what in ((0, "count"), (1, "drops")):
        np.testing.assert_array_equal(got[i], want[i], err_msg=what)
    for k in _STAT_FIELDS:
        assert got[2][k].shape == want[2][k].shape, k
        np.testing.assert_array_equal(got[2][k], want[2][k], err_msg=k)


def _pair(jcfg, tcfg, kind):
    dest, counts = _inputs(kind)
    got, want = port_stats(tcfg, dest, counts), jax_stats(jcfg, dest, counts)
    _assert_same_stats(got, want)
    if tcfg.overflow == "drop":  # the stats' drops are the queue's, counted once
        assert int(got[2]["stage_drops"].sum() + got[2]["recv_drops"].sum()) == int(got[1].sum())
    return got


# ------------------------------------------------------- rounds vs the JAX round
@pytest.mark.parametrize("kind", ["spread", "hotspot", "random"])
@pytest.mark.parametrize("peer_capacity", [0, 4], ids=["slots16", "slots4"])
@pytest.mark.parametrize("overflow", ["drop", "retain"])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_padded_stats_equal_reference(marshal, overflow, peer_capacity, kind):
    kw = dict(exchange="padded", marshal=marshal, overflow=overflow, peer_capacity=peer_capacity,
              telemetry=True, telemetry_buckets=B)
    got = _pair(JForwardConfig("data", R, CAP, **kw), ForwardConfig(R, CAP, **kw), kind)
    if overflow == "retain" and kind == "hotspot":
        assert got[2]["rows_held"].sum() > 0 and got[2]["retained_rows"].sum() > 0
        assert got[2]["age_max"].max() == 1


@pytest.mark.parametrize("kind", ["spread", "hotspot"])
@pytest.mark.parametrize("overflow", ["drop", "retain"])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_onehot_stats_equal_reference(marshal, overflow, kind):
    kw = dict(exchange="onehot", marshal=marshal, overflow=overflow, telemetry=True, telemetry_buckets=B)
    _pair(JForwardConfig("data", R, CAP, **kw), ForwardConfig(R, CAP, **kw), kind)


def _ample(sizes):
    """Tier capacities so large that no stage clamp fires."""
    caps, mult = [], 1
    for a in reversed(sizes):
        caps.append(CAP * mult)
        mult *= a
    return tuple(reversed(caps))


_HIER = [((2, 4), AXES2, (6, 8)), ((2, 2, 2), AXES3, (4, 6, 8))]


@pytest.mark.parametrize("kind", ["spread", "hotspot", "random"])
@pytest.mark.parametrize("caps,overflow", [("tight", "drop"), ("tight", "retain"), ("ample", "drop")])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
@pytest.mark.parametrize("layout", _HIER, ids=["2x4", "2x2x2"])
def test_hierarchical_stats_equal_reference(layout, marshal, caps, overflow, kind):
    """Tier rows at their ``level_sizes`` index, stages fastest first,
    demand after the faster tiers' clamps, waste past the first hop (with
    ample capacities no clamp fires, so retain would add nothing)."""
    sizes, axes, tight = layout
    kw = dict(exchange="hierarchical", level_sizes=sizes, level_capacities=tight if caps == "tight" else _ample(sizes),
              marshal=marshal, overflow=overflow, telemetry=True, telemetry_buckets=B)
    got = _pair(JForwardConfig(axes, R, CAP, **kw), ForwardConfig(R, CAP, **kw), kind)
    if caps == "ample":
        assert got[2]["stage_drops"].sum() == 0


@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_stage_drops_reproduce_the_48_16_8_clamp_numbers(marshal):
    """``test_telemetry.test_stage_drops_reproduce_multi_tier_clamp_numbers``
    on both packages: everyone sends 10 rows to rank 0 through (2, 2, 2)
    with capacities (4, 4, 4)."""
    kw = dict(exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(4, 4, 4), marshal=marshal,
              telemetry=True, telemetry_buckets=B)
    dest, counts = np.zeros((R, CAP), np.int32), np.full(R, 10, np.int32)
    got = port_stats(ForwardConfig(R, CAP, **kw), dest, counts)
    _assert_same_stats(got, jax_stats(JForwardConfig(AXES3, R, CAP, **kw), dest, counts))
    sdrop, dmax = got[2]["stage_drops"], got[2]["demand_max"]  # tier 0 = pod (slowest)
    np.testing.assert_array_equal(sdrop[:, 2], np.full(R, 6))
    np.testing.assert_array_equal(sdrop[:, 1], [4, 0, 4, 0, 4, 0, 4, 0])
    np.testing.assert_array_equal(sdrop[:, 0], [4, 0, 0, 0, 4, 0, 0, 0])
    assert sdrop.sum() == 48 + 16 + 8 and got[2]["recv_drops"].sum() == 0 and int(got[1].sum()) == 72
    np.testing.assert_array_equal(dmax[:, 2], np.full(R, 10))
    np.testing.assert_array_equal(dmax[:, 1], [8, 0, 8, 0, 8, 0, 8, 0])
    np.testing.assert_array_equal(dmax[:, 0], [8, 0, 0, 0, 8, 0, 0, 0])
    # rows clamped after the first hop had crossed a wire: 16 + 8 of them
    assert got[2]["wasted_wire_rows"].sum() == 16 + 8


def test_extent1_tier_records_nothing():
    kw = dict(exchange="hierarchical", level_sizes=(2, 1, 4), telemetry=True, telemetry_buckets=B)
    dest, counts = _inputs("spread", seed=4)
    got = port_stats(ForwardConfig(R, CAP, **kw), dest, counts)
    _assert_same_stats(got, jax_stats(JForwardConfig(AXES3, R, CAP, **kw), dest, counts))
    hist = got[2]["demand_hist"]
    assert hist[:, 1].sum() == 0 and got[2]["demand_max"][:, 1].max() == 0
    assert hist[:, 0].sum() > 0 and hist[:, 2].sum() > 0


def test_one_rank_layout_records_only_the_local_compaction():
    """A layout without a non-trivial tier runs no stage: only
    ``recv_total`` and ``recv_drops`` are recorded (the reference's early
    return)."""
    cfg = ForwardConfig(1, 16, exchange="hierarchical", level_sizes=(1, 1), telemetry=True, telemetry_buckets=B)
    q = make_queue(_tproto(), 16, num_ranks=1, device="cpu")
    rays = _tproto().__class__(origin=torch.ones(1, 20, 3), direction=torch.ones(1, 20, 3), tmin=torch.zeros(1, 20),
                               pixel=torch.arange(20, dtype=torch.int32)[None], integral=torch.zeros(1, 20))
    q = enqueue(q, rays, torch.zeros(1, 20, dtype=torch.int32), torch.ones(1, 20, dtype=torch.bool))
    nq, _total, st = forward_work(q, cfg)
    assert int(st.recv_total) == 16 and int(st.recv_drops) == 0 == int(nq.drops[0]) - 4
    for k in _STAT_FIELDS:
        if k not in ("recv_total", "recv_drops"):
            assert int(getattr(st, k).abs().sum()) == 0, k


def test_overflow_bucket_collects_exactly_at_capacity_demand():
    """The bucketing law against the reference's, including ``occ ==
    capacity`` where ``capacity % (B−1) != 0`` (reference test ``:131``)."""
    hist = TM.occupancy_histogram(torch.tensor([7, 8, 9]), 8, 8)
    assert hist.tolist() == np.asarray(JTM.occupancy_histogram(jnp.array([7, 8, 9]), 8, 8)).tolist()
    assert hist[-1] == 2 and hist.sum() == 3 and int(TM.occupancy_bucket(torch.tensor([8]), 8, 8)[0]) == 7
    for cap, nb in ((8, 8), (16, 8), (13, 4), (1, 2), (100, 7)):
        occ = np.arange(3 * cap + 2, dtype=np.int32)
        np.testing.assert_array_equal(TM.occupancy_bucket(torch.from_numpy(occ), cap, nb).numpy(),
                                      np.asarray(JTM.occupancy_bucket(jnp.asarray(occ), cap, nb)))
        np.testing.assert_array_equal(TM.bucket_upper_edges(cap, nb), JTM.bucket_upper_edges(cap, nb))
        rows = np.random.default_rng(cap).integers(0, 2 * cap, (3, 5)).astype(np.int32)
        want = np.stack([np.asarray(JTM.occupancy_histogram(jnp.asarray(r), cap, nb)) for r in rows])
        np.testing.assert_array_equal(TM.occupancy_histogram(torch.from_numpy(rows), cap, nb).numpy(), want)


# ----------------------------------------------------------------- the ring
def _hop_round_fn_port(q_in, acc, rnd):
    me = torch.arange(R, dtype=torch.int32)[:, None]
    lane = torch.arange(CAP)[None, :]
    valid = lane < q_in.count[:, None]
    keep = valid & (rnd < 4)
    dest = torch.where(keep, (me + 1) % R, DISCARD).to(torch.int32)
    return enqueue(make_queue(_tproto(), CAP, num_ranks=R, device="cpu"), q_in.items, dest, valid), acc


def _hop_seed_port():
    rays = make_rays(3)
    fields = {k: np.tile(np.asarray(getattr(rays, k)), (R,) + (1,) * (np.asarray(getattr(rays, k)).ndim - 1))
              for k in _FIELDS}
    items = queue_from_reference(fields, np.zeros(R * 3, np.int32), np.full(R, 3, np.int32),
                                 np.zeros(R, np.int32), R, _tproto(), device="cpu").items
    q0 = make_queue(_tproto(), CAP, num_ranks=R, device="cpu")
    return enqueue(q0, items, torch.arange(R, dtype=torch.int32)[:, None].expand(R, 3).contiguous(),
                   torch.ones(R, 3, dtype=torch.bool))


def _jax_hop_ring(mesh8, cfg):
    """The drive of ``test_telemetry.test_run_until_done_carries_ring_and_
    overwrites_window`` on the JAX package."""

    def round_fn(q_in, acc, rnd):
        me = jax.lax.axis_index("data")
        valid = jnp.arange(CAP) < q_in.count
        dest = jnp.where(valid & (rnd < 4), (me + 1) % R, J_DISCARD).astype(jnp.int32)
        return j_enqueue(j_make_queue(ray_proto(), CAP), q_in.items, dest, valid), acc

    def drive(_x):
        me = jax.lax.axis_index("data")
        q0 = j_enqueue(j_make_queue(ray_proto(), CAP), make_rays(3), me * jnp.ones(3, jnp.int32), jnp.ones(3, bool))
        q, _acc, rounds, _done, ring = j_run_until_done(round_fn, q0, jnp.zeros(()), cfg, max_rounds=16)
        return rounds[None], JTM.stack_ring(ring)

    proto = JTM.make_ring(1, window=cfg.telemetry_window, buckets=B)
    f = jax.jit(compat.shard_map(drive, mesh=mesh8, in_specs=P("data"),
                                 out_specs=(P("data"), jax.tree.map(lambda _: P("data"), proto))))
    return f(jnp.arange(8.0))


def test_run_until_done_carries_the_ring_and_overwrites_the_window(mesh8):
    """5 hops + the initial routing round through a window of 4: ``pos`` 6,
    slots holding rounds [4, 5, 2, 3], ``demand_total [3, 0, 3, 3]`` on
    every rank, and every leaf equal to the JAX drive's ring."""
    cfg = ForwardConfig(R, CAP, telemetry=True, telemetry_window=4, telemetry_buckets=B)
    q, _acc, rounds, done, ring = run_until_done(_hop_round_fn_port, _hop_seed_port(), torch.zeros(R), cfg,
                                                 max_rounds=16)
    assert rounds == 5 and done and ring.window == 4
    assert ring.pos.tolist() == [6] * R
    np.testing.assert_array_equal(ring.stats.demand_total.reshape(R, 4).numpy(), np.tile([3, 0, 3, 3], (R, 1)))
    summary = TM.summarize(ring, tier_capacities=TM.tier_capacities(cfg))
    assert (summary["rounds"], summary["window_filled"], summary["demand_max"][0], summary["drops"]) == (6, 4, 3, 0)
    jrounds, jring = _jax_hop_ring(mesh8, JForwardConfig("data", R, CAP, telemetry=True, telemetry_window=4,
                                                         telemetry_buckets=B))
    assert int(np.asarray(jrounds)[0]) == rounds
    np.testing.assert_array_equal(ring.pos.numpy(), np.asarray(jring.pos))
    for k in _STAT_FIELDS:
        np.testing.assert_array_equal(getattr(ring.stats, k).numpy(), np.asarray(getattr(jring.stats, k)), err_msg=k)


def _as_jax_ring(ring):
    return JTM.StatsRing(stats=JTM.RoundStats(**{k: getattr(ring.stats, k).numpy() for k in _STAT_FIELDS}),
                         pos=ring.pos.numpy())


def _same_dict(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, float):
            assert g == w, k
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=k)


S_CHAOS, FLAT_CAP = 2, 128  # test_torch_retain: every scenario spills


@pytest.mark.parametrize("window", [4, 64])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_retain_drive_ring_equals_oracle_and_host_view_equals_reference(marshal, window):
    """A lossless drive of ``rotating_hotspot`` with telemetry: the ring's
    per-round ``retained_rows`` and ``age_max`` equal the numpy oracle's
    ``retained_trace`` and ``age_trace`` (the last ``window`` of them), the
    drive is otherwise unchanged, and ``summarize``, ``ring_trace`` and
    ``demand_quantile`` of the port's ring equal the JAX functions fed the
    same ring."""
    sc = TC.rotating_hotspot(R, seed=0)
    sim = TC.simulate_flat_retain(sc, peer_capacity=S_CHAOS, capacity=FLAT_CAP)
    kw = dict(peer_capacity=S_CHAOS, marshal=marshal, overflow="retain")
    off = scenario_drive(sc, ForwardConfig(R, FLAT_CAP, **kw))
    res = scenario_drive(sc, ForwardConfig(R, FLAT_CAP, telemetry=True, telemetry_window=window, **kw))
    for k in ("rounds", "done", "drops", "retained_trace", "age_trace"):
        assert res[k] == off[k], k
    np.testing.assert_array_equal(res["delivered"], off["delivered"])
    assert res["comm"].calls == off["comm"].calls  # the ring adds no collective
    ring = res["ring"]
    tr = TM.ring_trace(ring)
    n = sim["rounds"] + 1
    assert int(ring.pos[0]) == n
    assert tr["retained_rows"].tolist() == sim["retained_trace"][-window:]
    assert tr["age_max"].tolist() == sim["age_trace"][-window:]
    jring = _as_jax_ring(ring)
    caps = TM.tier_capacities(ForwardConfig(R, FLAT_CAP, **kw))
    summary = TM.summarize(ring, tier_capacities=caps)
    jsummary = JTM.summarize(jring, tier_capacities=caps)
    _same_dict(summary, jsummary)
    _same_dict(tr, JTM.ring_trace(jring))
    for q in (0.1, 0.5, 0.8, 0.95, 0.999, 1.0):
        assert TM.demand_quantile(summary, 0, q) == JTM.demand_quantile(jsummary, 0, q), q
    assert summary["retained_rows"] > 0 and summary["drops"] == 0


def test_summarize_and_quantile_roundtrip():
    """``test_telemetry.test_summarize_and_quantile_roundtrip`` on the port,
    and its summary equal to the reference's."""
    ring = TM.make_ring(1, window=8, buckets=B)
    jring = JTM.make_ring(1, window=8, buckets=B)
    for occ in (1, 2, 2, 3, 3, 3, 50):
        i = lambda v: torch.tensor([v], dtype=torch.int32)
        ring = TM.ring_push(ring, TM.single_tier_stats(
            i(occ)[None], 32, B, sent_rows=i(occ), stage_drops=i(0), recv_total=i(occ), recv_drops=i(0)))
        jring = JTM.ring_push(jring, JTM.single_tier_stats(
            jnp.array([occ], jnp.int32), 32, B, sent_rows=jnp.int32(occ), stage_drops=jnp.int32(0),
            recv_total=jnp.int32(occ), recv_drops=jnp.int32(0)))
    summary = TM.summarize(ring, tier_capacities=(32,))
    _same_dict(summary, JTM.summarize(jring, tier_capacities=(32,)))
    assert summary["demand_max"][0] == 50 and TM.demand_quantile(summary, 0, 1.0) == 50
    assert 3 <= TM.demand_quantile(summary, 0, 0.8) <= TM.bucket_width(32, B)
    assert TM.demand_quantile(summary, 0, 0.999) == 50


def test_ring_trace_refuses_diverging_positions():
    ring = TM.make_ring(1, window=4, buckets=B, num_ranks=2)
    ring = dataclasses.replace(ring, pos=torch.tensor([3, 4], dtype=torch.int32))
    with pytest.raises(ValueError, match="diverge"):
        TM.ring_trace(ring)


# ------------------------------------------------------- no collective added
_CALL_CASES = [
    dict(exchange="padded"),
    dict(exchange="padded", overflow="retain", peer_capacity=4),
    dict(exchange="onehot"),
    dict(exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(4, 6, 8), overflow="retain"),
    dict(exchange="hierarchical", level_sizes=(2, 4), pipeline_shards=2),
]


@pytest.mark.parametrize("kw", _CALL_CASES, ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_telemetry_and_tracing_add_no_collective(kw):
    """The call recorder sees the same calls with telemetry on and off, and
    with a tracer installed around a traced drive."""
    dest, counts = _inputs("hotspot")
    calls = {}
    for telemetry in (False, True):
        comm = StackedCollectives()
        forward_work(_port_queue(dest, counts), ForwardConfig(R, CAP, telemetry=telemetry, **kw), comm=comm)
        calls[telemetry] = comm.calls
    assert calls[False] == calls[True]
    drives = {}
    for traced in (False, True):
        ctx = RafiContext(R, _tproto(), capacity=CAP, telemetry=traced, device="cpu", **kw)
        if traced:
            with OT.capture() as tr:
                out = ctx.run_until_done(_hop_round_fn_port, max_rounds=16)(_hop_seed_port(), torch.zeros(R))
            spans = tr.select(name="drive.run_until_done")
            assert len(spans) == 1 and spans[0]["args"]["rounds"] == out[2] and spans[0]["args"]["done"]
        else:
            out = ctx.run_until_done(_hop_round_fn_port, max_rounds=16)(_hop_seed_port(), torch.zeros(R))
        drives[traced] = (ctx.comm.calls, out)
    assert drives[False][0] == drives[True][0]
    assert drives[False][1][2] == drives[True][1][2] == 5
    assert torch.equal(drives[False][1][0].count, drives[True][1][0].count)


def test_rafi_context_returns_stats_and_ring():
    ctx = RafiContext(R, _tproto(), capacity=CAP, telemetry=True, telemetry_window=8, device="cpu")
    q = _port_queue(*_inputs("spread"))
    nq, total, st = ctx.forward_rays()(q)
    assert st.tiers == 1 and st.demand_hist.shape == (R, 1, 8)
    out = ctx.run_until_done(_hop_round_fn_port, max_rounds=16)(_hop_seed_port(), torch.zeros(R))
    assert len(out) == 5 and out[4].pos.tolist() == [6] * R


def test_vopat_telemetry_summary_is_drop_free_and_marshal_independent():
    """``vopat.render(..., telemetry=True)``: the summary has no drops,
    records every round (the routing round included) and is the same for
    the sort and the scatter marshal; the image is the telemetry-off one."""
    from repro_torch.apps import vopat

    scene = vopat.VopatScene(width=16, height=16)
    img, st = vopat.render(scene, num_ranks=8, marshal="scatter", telemetry=True, device="cpu")
    img_s, st_s = vopat.render(scene, num_ranks=8, marshal="sort", telemetry=True, device="cpu")
    img_off, st_off = vopat.render(scene, num_ranks=8, marshal="scatter", device="cpu")
    assert np.array_equal(img, img_off) and np.array_equal(img, img_s) and "telemetry" not in st_off
    summ = st["telemetry"]
    assert summ["drops"] == 0 and summ["rounds"] == st["rounds"] + 1 and summ["demand_max"][0] > 0
    _same_dict(summ, st_s["telemetry"])


# ------------------------------------------------------------- on the card
@work_item
@dataclasses.dataclass
class Words:
    w: torch.Tensor  # (11,) i32: the Fig-8 ray's 44 bytes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from repro_torch import compat as tcompat

    if tcompat.nvcc_path() is None:
        pytest.skip("needs nvcc to build the CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_cuda_fig8_telemetry_round_equals_cpu(cuda_device, marshal):
    """A telemetry-on round of the Fig-8 shape (R=8, C=262,144, 11 words,
    S=65,536) on the card: stats equal to the CPU round's field by field,
    the queue equal to the telemetry-off round's on every lane."""
    C, S = 262144, 65536
    gen = torch.Generator().manual_seed(18)
    words = torch.randint(-(2**31), 2**31 - 1, (R, C, 11), generator=gen, dtype=torch.int32)
    dest = torch.randint(-1, R, (R, C), generator=gen, dtype=torch.int32)
    mk = lambda dev: WorkQueue(items=Words(w=words.to(dev)), dest=dest.to(dev),
                               count=torch.full((R,), C, dtype=torch.int32, device=dev),
                               drops=torch.zeros(R, dtype=torch.int32, device=dev))
    cfg = ForwardConfig(R, C, peer_capacity=S, marshal=marshal, telemetry=True)
    nq, total, st = forward_work(mk(cuda_device), cfg)
    cq, ctotal, cst = forward_work(mk("cpu"), cfg)
    oq, ototal = forward_work(mk(cuda_device), dataclasses.replace(cfg, telemetry=False))
    for k in _STAT_FIELDS:
        assert torch.equal(getattr(st, k).cpu(), getattr(cst, k)), k
    assert int(total) == int(ctotal) == int(ototal)
    assert torch.equal(nq.items.w.cpu(), oq.items.w.cpu()) and torch.equal(nq.count.cpu(), cq.count)
    assert torch.equal(nq.drops.cpu(), cq.drops)
