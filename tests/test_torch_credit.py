"""The port's credit flow control (``flow="credit"``, the backpressure law)
against the JAX reference and its numpy twin.

* The grant law (floor share plus rank-ordered residual) of
  ``stages.CreditGate`` for R in {2, 3, 8, 16}, and the config refusals of
  ``tests/test_backpressure.py::test_credit_requires_retain_and_padded``
  with the reference's own ``ValueError`` messages.
* The port's copy of ``simulate_flat_credit`` equal to the JAX package's on
  both overload scenarios and every scenario of ``all_scenarios(8)``.
* The port's flat credit drive against that twin, round for round: a flat
  credit round does not run on JAX 0.9.0 (ROADMAP R1), so the twin is the
  reference there.  Sort, scatter and two micro-shards give the twin's
  trajectory; the first forward ships no payload; nothing is dropped.
* The open-flow baseline of ``test_open_overload_baseline_pinned`` from the
  port's ring (``repro.chaos.run_scenario`` does not run it on this JAX, R1)
  and from the retain twin.
* One hierarchical credit round on 2×4 and 2×2×2 (both marshals, 1 and 2
  shards) equal to the JAX round bit for bit: queues, ages, credits and
  stats — a single hierarchical credit round does run on JAX 0.9.0.
* The hierarchical credit drive delivering ``expected_by_rank``.
* The recorder: a credit round makes the open retain round's calls, each
  count call one int32 column wider.
* ``_merge_retained``'s emission cut (``limit=``) against the JAX function.

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
from repro.chaos import oracle as JO
from repro.chaos import scenarios as JS
from repro.core import ForwardConfig as JForwardConfig
from repro.core import WorkQueue as JWorkQueue
from repro.core import forward_work as j_forward_work
from repro.core import termination as JTERM
from repro.core import work_item as j_work_item
from repro.launch.mesh import make_node_mesh, make_pod_mesh
from repro_torch import chaos as TC
from repro_torch.core import ForwardConfig, StackedCollectives, WorkQueue, forward_work, work_item
from repro_torch.core import stages as ST
from repro_torch.core import termination as TTERM
from repro_torch.telemetry import stats as TS

from test_torch_retain import flat_schedule, scenario_drive

R, CAP = 8, 64
OVERLOAD = [("sustained_overload", 16, 4, 73), ("incast_collapse", 32, 8, 80)]
_IDS = ["sustained", "incast"]


# ------------------------------------------------------- the grant law
def _grants_law(free, num_ranks):
    f = max(int(free), 0)
    return [f // num_ranks + (me < f % num_ranks) for me in range(num_ranks)]


@pytest.mark.parametrize("num_ranks", [2, 3, 8, 16])
def test_grants_sum_exactly_to_advertised_free(num_ranks):
    """``CreditGate``'s grants, every rank toward every destination: the
    host law of ``test_backpressure._grants``, summing over the senders to
    exactly the clipped advert, fair to one row, rank-ordered."""
    frees = list(range(-3, 3 * num_ranks + 2)) + [10**6, 10**6 + num_ranks - 1]
    credits = torch.tensor(frees, dtype=torch.int32)[None, :].expand(num_ranks, -1).contiguous()
    st = ST.CreditGate(num_ranks)(ST.RoundState(credits=credits, flow="credit"))
    allow = st.credit_allow.numpy()
    assert st.credits_out is credits
    for j, free in enumerate(frees):
        g = allow[:, j].tolist()
        assert g == _grants_law(free, num_ranks)
        assert sum(g) == max(free, 0) and max(g) - min(g) <= 1 and g == sorted(g, reverse=True)


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_credit_requires_retain_and_padded():
    """The refusals of the reference test, with the reference's messages."""
    cases = [dict(overflow="drop", flow="credit"),
             dict(exchange="onehot", overflow="retain", flow="credit"),
             dict(flow="closed"),
             dict(overflow="retain", flow="credit", emit_reserve=CAP)]
    for kw in cases:
        want = _error(lambda: JForwardConfig("data", R, CAP, **kw))
        assert _error(lambda: ForwardConfig(R, CAP, **kw)) == want, kw


# ------------------------------------------------------------ the twin
def _twin_pair(name, S, C, **kw):
    sc_t = getattr(TC, name)(R) if isinstance(name, str) else name[0]
    sc_j = getattr(JS, name)(R) if isinstance(name, str) else name[1]
    return (TC.simulate_flat_credit(sc_t, peer_capacity=S, capacity=C, **kw),
            JO.simulate_flat_credit(sc_j, peer_capacity=S, capacity=C, **kw))


def _same_dict(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("name,C,S,rounds", OVERLOAD, ids=_IDS)
def test_credit_twin_copy_equals_reference_on_overload(name, C, S, rounds):
    got, want = _twin_pair(name, S, C, max_rounds=256)
    _same_dict(got, want)
    assert (got["rounds"], got["drops"], got["done"]) == (rounds, 0, True)


@pytest.mark.parametrize("idx", range(4))
def test_credit_twin_copy_equals_reference_on_all_scenarios(idx):
    pair = (TC.all_scenarios(R)[idx], JS.all_scenarios(R)[idx])
    for S, C, reserve in ((2, 128, -1), (1, 16, 3)):
        got, want = _twin_pair(pair, S, C, emit_reserve=reserve, max_rounds=128)
        _same_dict(got, want)


@pytest.mark.parametrize("health", ["constant", "brownout"])
def test_retain_twin_health_copy_equals_reference(health):
    """``simulate_flat_retain(health=)`` and ``_health_table_np``, copied."""
    if health == "constant":
        h = np.ones(R, bool)
        h[[2, 5]] = False
        ht = hj = h
    else:
        ht, hj = TC.brownout_mask(R), JS.brownout_mask(R)
    for name in ("capacity_drought", "rank_brownout"):
        got = TC.simulate_flat_retain(getattr(TC, name)(R), peer_capacity=2, capacity=128, health=ht)
        want = JO.simulate_flat_retain(getattr(JS, name)(R), peer_capacity=2, capacity=128, health=hj)
        _same_dict(got, want)
    for bits in range(0, 256, 7):
        m = np.array([(bits >> i) & 1 for i in range(R)], bool)
        np.testing.assert_array_equal(TC.oracle._health_table_np(m), JO._health_table_np(m))


# ------------------------------------------------ the flat credit drive
def _credit_cfg(C, S, max_rounds=256, **kw):
    return ForwardConfig(R, C, peer_capacity=S, overflow="retain", flow="credit", telemetry=True,
                         telemetry_window=max_rounds + 1, **kw)


MODES = [dict(marshal="sort"), dict(marshal="scatter"), dict(marshal="sort", pipeline_shards=2)]


@pytest.mark.parametrize("mode", MODES, ids=["sort", "scatter", "sort-S2"])
@pytest.mark.parametrize("name,C,S,rounds", OVERLOAD, ids=_IDS)
def test_flat_credit_drive_equals_twin(name, C, S, rounds, mode):
    """The port's flat credit drive (the cursor-gated emitter) against the
    port's twin (equal to the reference's, above), round for round:
    rounds, delivered checksums, the retained, age and receive traces; no
    drop, no emission cut, no wasted wire; the first forward ships nothing."""
    sc = getattr(TC, name)(R)
    tw = TC.simulate_flat_credit(sc, peer_capacity=S, capacity=C, max_rounds=256)
    res = scenario_drive(sc, _credit_cfg(C, S, **mode), max_rounds=256, gated=True)
    tr = TS.ring_trace(res["ring"])
    assert res["rounds"] == tw["rounds"] == rounds and res["done"] and tw["done"]
    np.testing.assert_array_equal(res["delivered"], tw["delivered"])
    np.testing.assert_array_equal(res["delivered"], TC.expected_by_rank(sc))
    assert res["emitted"] == tw["emitted"] == sc.emitted
    assert res["retained_trace"] == tw["retained_trace"] == tr["retained_rows"].tolist()
    assert res["age_trace"] == tw["age_trace"] == tr["age_max"].tolist()
    assert tr["recv_total"].tolist() == tw["recv_trace"] and tw["recv_trace"][0] == 0
    summary = TS.summarize(res["ring"], tier_capacities=(S,))
    assert res["drops"] == 0 and summary["emit_overflow"] == 0 and summary["wasted_wire_rows"] == 0
    assert summary["goodput"] == 1.0 and res["bad_ballast"] == 0
    # the grants of a forward never exceed the slots: Σ min(grant, S)
    assert (res["ring"].stats.credits_granted <= R * S).all()
    # one payload and one (widened) count all_to_all a forward, per shard
    shards = mode.get("pipeline_shards", 1)
    a2a = [c for c in res["comm"].calls.elements() if c.kind == "all_to_all"]
    assert len(a2a) == 2 * shards * (rounds + 1)
    assert {c.shape for c in a2a} == {(R, R, 2), (R, R, S // shards, 3)}  # counts + advert; uid + val words


def test_open_overload_baseline_pinned():
    """``test_open_overload_baseline_pinned``'s numbers from the port's
    open retain drive and its ring, and from the retain twin: the hot pair
    hoards the deliveries, nearly half the wire is thrown away, and every
    drop is an emission cut or a wasted wire row."""
    sc = TC.sustained_overload(R)
    cfg = ForwardConfig(R, 16, peer_capacity=4, overflow="retain", telemetry=True, telemetry_window=257)
    res = scenario_drive(sc, cfg, max_rounds=256)
    summary = TS.summarize(res["ring"], tier_capacities=(4,))
    tr = TS.ring_trace(res["ring"])
    assert res["delivered"][:, 0].sum() == 534 and res["rounds"] == 15 and res["done"]
    assert res["delivered"][:, 0].tolist() == [159, 143, 36, 29, 39, 44, 41, 43]
    assert res["drops"] == 618 and sc.emitted == 534 + res["resident"] + 618
    assert summary["emit_overflow"] == 169
    assert int(tr["recv_total"].sum()) == 983 and summary["wasted_wire_rows"] == 449
    assert res["drops"] == summary["emit_overflow"] + summary["wasted_wire_rows"]
    assert abs(summary["goodput"] - (1 - 449 / 983)) < 1e-9
    tw = JO.simulate_flat_retain(JS.sustained_overload(R), peer_capacity=4, capacity=16, max_rounds=256)
    assert (tw["rounds"], tw["drops"]) == (15, 618) and tw["delivered"][:, 0].tolist() == res["delivered"][:, 0].tolist()


@work_item
@dataclasses.dataclass
class TItem:
    val: torch.Tensor
    src: torch.Tensor


@j_work_item
@dataclasses.dataclass
class JItem:
    val: jax.Array
    src: jax.Array


def _tqueue(val, dest, count):
    return WorkQueue(
        items=TItem(val=torch.from_numpy(val), src=torch.arange(R, dtype=torch.int32)[:, None].expand(R, CAP).contiguous()),
        dest=torch.from_numpy(dest), count=torch.from_numpy(count), drops=torch.zeros(R, dtype=torch.int32))


def _ring_inputs(n=10):
    """Each rank holds ``n`` rows to ``(me + 1 + k) % R`` (all off-rank)."""
    me, k = np.arange(R)[:, None], np.arange(CAP)[None, :]
    dest = np.where(k < n, (me + 1 + k) % R, -1).astype(np.int32)
    return (me * 100 + k).astype(np.float32), dest, np.full(R, n, np.int32)


def test_zero_credit_round_ships_no_payload():
    """An all-zero credit tensor retains everything at the source: no row
    arrives, nothing drops, every rank still advertises, the held rows age
    one round."""
    cfg = ForwardConfig(R, CAP, overflow="retain", flow="credit", telemetry=True)
    nq, total, age, credits_out, stats = forward_work(
        _tqueue(*_ring_inputs()), cfg, credits=torch.zeros(R, R, dtype=torch.int32))
    assert int(total) == 80
    assert nq.count.tolist() == [10] * R and int(nq.drops.sum()) == 0
    assert stats.recv_total.tolist() == [0] * R and stats.credits_granted.sum() == 0
    assert (credits_out > 0).all()
    assert (age[:, :10] == 1).all()
    assert stats.rows_held[:, 0].tolist() == [10] * R  # the un-credited tails are held


# ---------------------------------------------- the hierarchical round
LAYOUTS = {(2, 4): ("node", "device"), (2, 2, 2): ("pod", "node", "device")}
_MESHES = {}


def _mesh(sizes):
    if sizes not in _MESHES:
        _MESHES[sizes] = make_node_mesh(*sizes) if len(sizes) == 2 else make_pod_mesh(*sizes)
    return _MESHES[sizes]


_JAX_FNS = {}


def _jax_credit_round(jcfg, axes, val, dest, count, credits):
    key = jcfg
    if key not in _JAX_FNS:
        def fwd(v, d, c, cr):
            me = jax.lax.axis_index(axes)
            q = JWorkQueue(items=JItem(val=v, src=me * jnp.ones(CAP, jnp.int32)), dest=d, count=c[0],
                           drops=jnp.zeros((), jnp.int32))
            nq, total, age, cr_out, st = j_forward_work(q, jcfg, credits=cr)
            return (nq.items.val, nq.items.src, nq.dest, nq.count[None], nq.drops[None], total, age, cr_out,
                    st.credits_granted[None], st.rows_held[None], st.sent_rows[None], st.stage_drops[None],
                    st.recv_total[None], st.demand_total[None])

        _JAX_FNS[key] = jax.jit(compat.shard_map(
            fwd, mesh=_mesh(jcfg.level_sizes), in_specs=(P(axes),) * 4,
            out_specs=(P(axes),) * 5 + (P(),) + (P(axes),) * 8))
    out = _JAX_FNS[key](*(jnp.asarray(a.reshape(-1)) for a in (val, dest, count, credits)))
    return [np.asarray(x) for x in out]


def _credit_inputs(case):
    if case == "pinned":
        val, dest, count = _ring_inputs()
        return val, dest, count, np.full((R, R), 5, np.int32)
    rng = np.random.default_rng(7)
    val = rng.normal(size=(R, CAP)).astype(np.float32)
    dest = rng.integers(0, R, (R, CAP)).astype(np.int32)
    dest[::3] = 5  # a hot destination
    count = rng.integers(20, CAP + 1, R).astype(np.int32)
    credits = rng.integers(-3, 40, (R, R)).astype(np.int32)  # each rank its own stale view
    return val, dest, count, credits


@pytest.mark.parametrize("case", ["pinned", "random"])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
@pytest.mark.parametrize("sizes", list(LAYOUTS), ids=["2x4", "2x2x2"])
def test_hierarchical_credit_round_equals_reference(sizes, marshal, shards, case):
    """One hierarchical credit round against the JAX round, bit for bit:
    counts, drops, total, dest, items and ages on lanes < count, the
    ``(R, R)`` credits out and the stats.  The pinned case: counts
    ``[7]*5 + [15]*3``, rank 0's credits ``[30, 5, …]``."""
    axes = LAYOUTS[sizes]
    caps = (8,) * len(sizes)
    kw = dict(exchange="hierarchical", level_sizes=sizes, level_capacities=caps, overflow="retain",
              flow="credit", marshal=marshal, pipeline_shards=shards, telemetry=True)
    val, dest, count, credits = _credit_inputs(case)
    want = _jax_credit_round(JForwardConfig(axes, R, CAP, **kw), axes, val, dest, count, credits)
    comm = StackedCollectives()
    nq, total, age, cr, st = forward_work(_tqueue(val, dest, count), ForwardConfig(R, CAP, **kw),
                                          credits=torch.from_numpy(credits), comm=comm)
    wv, ws, wd, wc, wdr, wt, wa, wcr = (want[0].reshape(R, CAP), want[1].reshape(R, CAP), want[2].reshape(R, CAP),
                                        want[3], want[4], int(want[5]), want[6].reshape(R, CAP), want[7].reshape(R, R))
    np.testing.assert_array_equal(nq.count.numpy(), wc)
    np.testing.assert_array_equal(nq.drops.numpy(), wdr)
    assert int(total) == wt
    np.testing.assert_array_equal(cr.numpy(), wcr)
    for r in range(R):
        n = int(wc[r])
        np.testing.assert_array_equal(nq.items.val[r, :n].numpy().view(np.uint32), wv[r, :n].view(np.uint32))
        np.testing.assert_array_equal(nq.items.src[r, :n].numpy(), ws[r, :n])
        np.testing.assert_array_equal(nq.dest[r, :n].numpy(), wd[r, :n])
        np.testing.assert_array_equal(age[r, :n].numpy(), wa[r, :n])
    for got, w in zip((st.credits_granted, st.rows_held, st.sent_rows, st.stage_drops, st.recv_total, st.demand_total),
                      want[8:]):
        np.testing.assert_array_equal(got.numpy(), w.reshape(got.shape))
    if case == "pinned":
        assert wc.tolist() == [7] * 5 + [15] * 3 and wcr[0].tolist() == [30] + [5] * 7
    # calls: the open retain round's, each count call one column wider
    open_comm = StackedCollectives()
    forward_work(_tqueue(val, dest, count), ForwardConfig(R, CAP, **dict(kw, flow="open")), comm=open_comm)
    assert _widened(open_comm) == _calls(comm)


def _calls(comm):
    return sorted((c.kind, c.tier, c.shape) for c in comm.calls.elements())


def _widened(comm):
    """The open round's calls with every count call (a 3-d all_to_all) one
    int32 column wider."""
    out = []
    for c in comm.calls.elements():
        shape = c.shape
        if c.kind == "all_to_all" and len(shape) == 3:
            shape = shape[:-1] + (shape[-1] + 1,)
        out.append((c.kind, c.tier, shape))
    return sorted(out)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_flat_credit_round_calls_widen_one_column(marshal, shards):
    """The flat credit round: one payload and one count call a shard, the
    count call ``(R, R, 2)`` instead of ``(R, R, 1)``, nothing else."""
    val, dest, count, credits = _credit_inputs("random")
    calls = {}
    for flow in ("open", "credit"):
        comm = StackedCollectives()
        forward_work(_tqueue(val, dest, count), ForwardConfig(R, CAP, overflow="retain", flow=flow, marshal=marshal,
                                                              pipeline_shards=shards),
                     **({"credits": torch.from_numpy(credits)} if flow == "credit" else {}), comm=comm)
        calls[flow] = comm
    assert _widened(calls["open"]) == _calls(calls["credit"])
    assert calls["credit"].count("all_to_all") == 2 * shards and calls["credit"].count("psum") == 1


@pytest.mark.parametrize("sizes", list(LAYOUTS), ids=["2x4", "2x2x2"])
def test_hierarchical_credit_drive_drains_overload(sizes):
    """``test_hierarchical_credit_drains_overload`` on the port: the hot-
    pair overload through the tiered credit relay delivers
    ``expected_by_rank`` with no drop, sort and scatter alike."""
    sc = TC.sustained_overload(R)
    out = []
    for marshal in ("sort", "scatter"):
        cfg = ForwardConfig(R, 256, exchange="hierarchical", level_sizes=sizes, level_capacities=(8,) * len(sizes),
                            overflow="retain", flow="credit", marshal=marshal)
        res = scenario_drive(sc, cfg, max_rounds=512, gated=True)
        np.testing.assert_array_equal(res["delivered"], TC.expected_by_rank(sc))
        assert res["drops"] == 0 and res["done"] and res["resident"] == 0 and res["emitted"] == sc.emitted
        out.append((res["rounds"], res["retained_trace"], res["age_trace"]))
    assert out[0] == out[1]


def test_flat_schedule_equals_reference():
    from repro.chaos.driver import _flat_schedule

    for sc_t, sc_j in zip(TC.all_scenarios(R) + TC.overload_scenarios(R), JS.all_scenarios(R) + JS.overload_scenarios(R)):
        for a, b in zip(flat_schedule(sc_t), _flat_schedule(sc_j)):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------- the emission cut
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_limit_equals_reference(seed):
    """``_merge_retained(limit=)`` against the JAX function per rank: the
    merged count is ``min(n_ret + emitted, max(limit, n_ret))``, the cut is
    counted in drops, retained rows are never cut."""
    SC = 16
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(2, R, SC)).astype(np.float32)
    lane = np.arange(SC)[None, :]
    n_ret = rng.integers(0, SC + 1, R).astype(np.int32)
    count = np.minimum(n_ret + rng.integers(0, SC, R), SC).astype(np.int32)
    dest = np.where(lane < n_ret[:, None], rng.integers(0, R, (R, SC)), -1).astype(np.int32)
    age = np.where(lane < n_ret[:, None], rng.integers(1, 5, (R, SC)), 0).astype(np.int32)
    oc = rng.integers(0, SC + 1, R).astype(np.int32)
    odest = np.where(lane < oc[:, None], rng.integers(0, R, (R, SC)), -1).astype(np.int32)
    limit = rng.integers(0, SC + 1, R).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    src = t(np.zeros((R, SC), np.int32))
    tq = WorkQueue(TItem(t(val[0]), src), t(dest), t(count), t(np.zeros(R, np.int32)))
    tout = WorkQueue(TItem(t(val[1]), src), t(odest), t(oc), t(np.zeros(R, np.int32)))
    t_nret, _view = TTERM._split_retained(tq)
    merged, t_age = TTERM._merge_retained(tq, t_nret, tout, t(age), t(limit))
    assert (merged.drops > 0).any()
    for r in range(R):
        z = jnp.zeros((SC,), jnp.int32)
        jq = JWorkQueue(JItem(jnp.asarray(val[0, r]), z), jnp.asarray(dest[r]), jnp.asarray(count[r]), jnp.int32(0))
        jout = JWorkQueue(JItem(jnp.asarray(val[1, r]), z), jnp.asarray(odest[r]), jnp.asarray(oc[r]), jnp.int32(0))
        j_nret, _ = JTERM._split_retained(jq)
        jm, j_age = JTERM._merge_retained(jq, j_nret, jout, jnp.asarray(age[r]), jnp.int32(limit[r]))
        assert int(merged.count[r]) == int(jm.count) and int(merged.drops[r]) == int(jm.drops)
        n = int(jm.count)
        np.testing.assert_array_equal(merged.dest[r, :n].numpy(), np.asarray(jm.dest)[:n])
        np.testing.assert_array_equal(t_age[r].numpy(), np.asarray(j_age))
        np.testing.assert_array_equal(merged.items.val[r, :n].numpy().view(np.uint32),
                                      np.asarray(jm.items.val)[:n].view(np.uint32))


def test_rafi_context_credit_entry_points():
    """``RafiContext(flow="credit", emit_reserve=)``: ``forward_rays`` returns
    the ``(R, R)`` credits after the ages (fully credited single shot), and
    the drive cold-starts at zero credit, so its first forward ships nothing
    and the rows still arrive."""
    from repro_torch.core import RafiContext

    ctx = RafiContext(R, TItem(val=torch.zeros(()), src=torch.zeros((), dtype=torch.int32)), capacity=CAP,
                      overflow="retain", flow="credit", emit_reserve=8, telemetry=True, device="cpu")
    assert ctx.cfg.flow == "credit" and ctx.cfg.emit_reserve == 8
    val, dest, count = _ring_inputs()
    q = _tqueue(val, dest, count)
    nq, total, age, credits, stats = ctx.forward_rays()(q)
    assert int(total) == 80 and credits.shape == (R, R) and int(stats.recv_total.sum()) == 80

    def round_fn(q_in, aux, rnd):
        return make_queue_like(q_in), aux + q_in.count

    def make_queue_like(q_in):
        return WorkQueue(items=q_in.items, dest=torch.full_like(q_in.dest, -1), count=torch.zeros_like(q_in.count),
                         drops=torch.zeros_like(q_in.drops))

    out = ctx.run_until_done(round_fn, max_rounds=16)(q, torch.zeros(R, dtype=torch.int32))
    q_end, aux, rounds, done, _age, ring = out
    assert done and int(aux.sum()) == 80 and int(q_end.drops.sum()) == 0
    assert int(TS.ring_trace(ring)["recv_total"][0]) == 0  # the cold start: the first forward ships nothing
