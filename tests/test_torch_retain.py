"""The port's lossless law (``overflow="retain"``) against the JAX reference.

* One retain ``forward_work`` round against the JAX round (run as
  ``tests/test_pipeline.py::_run`` runs it: ``mesh8``, ``uniform`` and
  ``hotspot`` traffic, both marshals, ``padded`` and ``onehot``): counts,
  drops, totals, destinations, item bits and ages on lanes ``< count``,
  bit for bit.
* The drive's split and merge against the JAX functions called standalone
  (outside ``shard_map``, where the reference's ``lax.cond`` runs).
* The port's copy of the numpy oracle against ``repro.chaos``, and the
  port's drive against that oracle round for round (retained rows and
  their largest age after every forward) and against ``expected_by_rank``.
  A JAX retain drive does not run on this JAX (ROADMAP R4), so the oracle
  is the reference here.

Tolerance: none — everything here moves or counts data.
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
from repro.chaos import oracle as JO
from repro.chaos import scenarios as JS
from repro.core import ForwardConfig as JForwardConfig
from repro.core import WorkQueue as JWorkQueue
from repro.core import enqueue as j_enqueue
from repro.core import forward_work as j_forward_work
from repro.core import make_queue as j_make_queue
from repro.core import termination as JTERM
from repro.core import work_item as j_work_item
from repro_torch import chaos as TC
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
    work_item,
)
from repro_torch.core import termination as TTERM

R, CAP, N_EMIT = 8, 64, 24


@work_item
@dataclasses.dataclass
class TRay:
    origin: torch.Tensor
    direction: torch.Tensor
    tmin: torch.Tensor
    pixel: torch.Tensor
    integral: torch.Tensor


_FIELDS = ("origin", "direction", "tmin", "pixel", "integral")


def _tproto():
    return TRay(origin=torch.zeros(3), direction=torch.zeros(3), tmin=torch.zeros(()),
                pixel=torch.zeros((), dtype=torch.int32), integral=torch.zeros(()))


def pattern_dest(pattern, seed, num_ranks=R, n_emit=N_EMIT):
    """``tests/test_pipeline.py::_dest_fn`` in numpy, all ranks at once."""
    me = np.arange(num_ranks)[:, None]
    i = np.arange(n_emit)[None, :]
    if pattern == "uniform":  # includes out-of-range dests (R, R+1)
        return ((me * 7 + seed + i**2) % (num_ranks + 2)).astype(np.int32)
    return np.full((num_ranks, n_emit), seed % num_ranks, np.int32)  # hotspot


_JAX_FNS = {}


def jax_round(mesh, cfg, dest):
    """One JAX round on ``mesh``: each rank enqueues ``make_rays(N_EMIT)``
    toward its row of ``dest`` and forwards, as ``test_pipeline._run``.
    Returns numpy arrays: the input queue (fields, dest, count) and the
    result (count, drops, dest, fields, total, age under retain)."""
    retain = cfg.overflow == "retain"
    if cfg not in _JAX_FNS:
        axes = cfg.axis_name
        flat = axes if isinstance(axes, str) else tuple(axes)

        def kernel(d):
            q = j_enqueue(j_make_queue(ray_proto(), CAP), make_rays(N_EMIT), d, jnp.ones(N_EMIT, bool))
            res = j_forward_work(q, cfg)
            nq = res[0]
            out = (tuple(getattr(q.items, k) for k in _FIELDS) + (q.dest, q.count[None])
                   + (nq.count[None], nq.drops[None], nq.dest)
                   + tuple(getattr(nq.items, k) for k in _FIELDS) + (res[1][None],))
            return out + ((res[2],) if retain else ())

        n_out = 2 * len(_FIELDS) + 6 + retain
        _JAX_FNS[cfg] = jax.jit(compat.shard_map(
            kernel, mesh=mesh, in_specs=P(flat), out_specs=(P(flat),) * n_out))
    out = [np.asarray(x) for x in _JAX_FNS[cfg](jnp.asarray(dest.reshape(-1)))]
    k = len(_FIELDS)
    inp = (dict(zip(_FIELDS, out[:k])), out[k], out[k + 1])
    res = {"count": out[k + 2], "drops": out[k + 3], "dest": out[k + 4].reshape(R, CAP),
           "fields": dict(zip(_FIELDS, out[k + 5:2 * k + 5])), "total": int(out[2 * k + 5][0])}
    if retain:
        res["age"] = out[2 * k + 6].reshape(R, CAP)
    return inp, res


def port_round(cfg, inp, comm=None):
    fields, dest, count = inp
    q = queue_from_reference(fields, dest, count, np.zeros(R, np.int32), R, _tproto(), device="cpu")
    out = forward_work(q, cfg, comm=comm)
    nq = out[0]
    res = {"count": nq.count.numpy(), "drops": nq.drops.numpy(), "dest": nq.dest.numpy(),
           "fields": {k: getattr(nq.items, k).numpy() for k in _FIELDS}, "total": int(out[1])}
    if len(out) == 3:
        res["age"] = out[2].numpy()
    return res


def assert_same_round(got, want):
    """Counts, drops, totals; dest, item bits and ages on lanes < count."""
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["drops"], want["drops"])
    assert got["total"] == want["total"]
    assert ("age" in got) == ("age" in want)
    for r in range(R):
        n = int(want["count"][r])
        np.testing.assert_array_equal(got["dest"][r, :n], want["dest"][r, :n])
        if "age" in want:
            np.testing.assert_array_equal(got["age"][r, :n], want["age"][r, :n])
        for k in _FIELDS:
            a = got["fields"][k][r, :n]
            b = want["fields"][k].reshape((R, CAP) + a.shape[1:])[r, :n]
            np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=k)


_TRAFFIC = [("uniform", 0), ("uniform", 3), ("hotspot", 0), ("hotspot", 3)]


@pytest.mark.parametrize("traffic", _TRAFFIC, ids=lambda t: f"{t[0]}{t[1]}")
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
@pytest.mark.parametrize("exchange", ["padded", "onehot"])
def test_retain_round_equals_reference(mesh8, exchange, marshal, traffic):
    dest = pattern_dest(*traffic)
    inp, want = jax_round(mesh8, JForwardConfig("data", R, CAP, exchange=exchange, marshal=marshal,
                                                overflow="retain"), dest)
    got = port_round(ForwardConfig(R, CAP, exchange=exchange, marshal=marshal, overflow="retain"), inp)
    assert_same_round(got, want)
    if exchange == "padded" and traffic[0] == "hotspot":
        hot = traffic[1] % R
        assert got["drops"][hot] == 72 and got["count"][hot] == 64  # the receiver clamp fired
        assert (got["dest"][np.arange(R) != hot, :8] == hot).all()  # the spill kept its dest


@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_retain_round_pins_the_recorded_numbers(mesh8, marshal):
    """The numbers recorded for seed 3 (ROADMAP Queue 1 item 6), on both
    packages: uniform counts and total; hotspot counts, drops and age."""
    jcfg = JForwardConfig("data", R, CAP, marshal=marshal, overflow="retain")
    tcfg = ForwardConfig(R, CAP, marshal=marshal, overflow="retain")
    for pattern, counts, total in (
        ("uniform", [14, 22, 20, 19, 22, 15, 21, 19], 152),
        ("hotspot", [8, 8, 8, 64, 8, 8, 8, 8], 120),
    ):
        inp, want = jax_round(mesh8, jcfg, pattern_dest(pattern, 3))
        got = port_round(tcfg, inp)
        for res in (want, got):
            assert res["count"].tolist() == counts and res["total"] == total
        if pattern == "hotspot":
            for res in (want, got):
                assert res["drops"].tolist() == [0, 0, 0, 72, 0, 0, 0, 0]
                assert max(int(res["age"][r, :counts[r]].max()) for r in range(R)) == 1


def test_retain_adds_no_collective():
    """Retention is local compaction: the recorder sees the drop round's
    calls, one payload and one count ``all_to_all`` and the psum."""
    dest = pattern_dest("hotspot", 3)
    inp = ({k: np.zeros((R * CAP,) + s, np.float32) for k, s in
            (("origin", (3,)), ("direction", (3,)), ("tmin", ()), ("integral", ()))},
           np.zeros(R * CAP, np.int32), np.full(R, N_EMIT, np.int32))
    inp[0]["pixel"] = np.arange(R * CAP, dtype=np.int32)
    inp[1].reshape(R, CAP)[:, :N_EMIT] = dest
    calls = {}
    for overflow in ("drop", "retain"):
        comm = StackedCollectives()
        port_round(ForwardConfig(R, CAP, overflow=overflow), inp, comm=comm)
        calls[overflow] = comm.calls
    assert calls["drop"] == calls["retain"]
    assert sorted(c.kind for c in calls["retain"].elements()) == ["all_to_all", "all_to_all", "psum"]


# ------------------------------------------------------------ split / merge
@j_work_item
@dataclasses.dataclass
class JItem:
    val: jax.Array  # (2,) f32
    uid: jax.Array  # () i32


@work_item
@dataclasses.dataclass
class TItem:
    val: torch.Tensor
    uid: torch.Tensor


SC = 16


def _split_merge_inputs(seed, n_ret, out_count):
    """A queue whose first ``n_ret[r]`` lanes are retained (dest >= 0, ages
    > 0) and an emission queue of ``out_count[r]`` rows."""
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(2, R, SC, 2)).astype(np.float32)
    uid = rng.integers(0, 10**6, (2, R, SC)).astype(np.int32)
    lane = np.arange(SC)[None, :]
    n_ret = np.asarray(n_ret, np.int32)
    count = np.minimum(n_ret + rng.integers(0, SC, R), SC).astype(np.int32)
    dest = np.where(lane < n_ret[:, None], rng.integers(0, R, (R, SC)), DISCARD).astype(np.int32)
    age = np.where(lane < n_ret[:, None], rng.integers(1, 5, (R, SC)), 0).astype(np.int32)
    out_count = np.asarray(out_count, np.int32)
    out_dest = np.where(lane < out_count[:, None], rng.integers(0, R, (R, SC)), DISCARD).astype(np.int32)
    drops = rng.integers(0, 3, R).astype(np.int32)
    return val, uid, count, dest, age, out_count, out_dest, drops


@pytest.mark.parametrize("case", ["nothing_retained", "some_retained", "emissions_overflow"])
def test_split_and_merge_equal_reference(case):
    """``_split_retained`` and ``_merge_retained`` (limit=None) against the
    JAX functions called per rank outside ``shard_map``: views, merged
    queues, ages and the emission cut, bit for bit.  The port's versions
    are branch-free; the reference's pass-through branch runs where
    nothing is retained."""
    n_ret = {"nothing_retained": [0] * R,
             "some_retained": [0, 3, 5, 1, 0, 7, 2, 4],
             "emissions_overflow": [9, 12, 4, 15, 16, 0, 8, 10]}[case]
    out_count = {"nothing_retained": [5, 0, 16, 3, 8, 1, 2, 9],
                 "some_retained": [2, 4, 6, 8, 10, 0, 1, 3],
                 "emissions_overflow": [16, 10, 14, 3, 5, 16, 9, 12]}[case]
    val, uid, count, dest, age, oc, odest, drops = _split_merge_inputs(len(case), n_ret, out_count)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    tq = WorkQueue(TItem(t(val[0]), t(uid[0])), t(dest), t(count), t(drops))
    tout = WorkQueue(TItem(t(val[1]), t(uid[1])), t(odest), t(oc), t(drops))
    t_nret, t_view = TTERM._split_retained(tq)
    t_merged, t_age = TTERM._merge_retained(tq, t_nret, tout, t(age))
    if case == "emissions_overflow":
        assert (t_merged.drops - tout.drops).sum() > 0  # the emission cut fired
    for r in range(R):
        jq = JWorkQueue(JItem(jnp.asarray(val[0, r]), jnp.asarray(uid[0, r])), jnp.asarray(dest[r]),
                        jnp.asarray(count[r]), jnp.asarray(drops[r]))
        jout = JWorkQueue(JItem(jnp.asarray(val[1, r]), jnp.asarray(uid[1, r])), jnp.asarray(odest[r]),
                          jnp.asarray(oc[r]), jnp.asarray(drops[r]))
        j_nret, j_view = JTERM._split_retained(jq)
        assert int(t_nret[r]) == int(j_nret) == n_ret[r]
        assert int(t_view.count[r]) == int(j_view.count) and int(t_view.drops[r]) == 0
        nv = int(j_view.count)
        np.testing.assert_array_equal(t_view.dest[r].numpy(), np.asarray(j_view.dest))
        np.testing.assert_array_equal(t_view.items.uid[r, :nv].numpy(), np.asarray(j_view.items.uid)[:nv])
        np.testing.assert_array_equal(t_view.items.val[r, :nv].numpy().view(np.uint32),
                                      np.asarray(j_view.items.val)[:nv].view(np.uint32))
        j_merged, j_age = JTERM._merge_retained(jq, j_nret, jout, jnp.asarray(age[r]))
        for got, want in ((t_merged.count[r], j_merged.count), (t_merged.drops[r], j_merged.drops)):
            assert int(got) == int(want)
        np.testing.assert_array_equal(t_merged.dest[r].numpy(), np.asarray(j_merged.dest))
        np.testing.assert_array_equal(t_age[r].numpy(), np.asarray(j_age))
        n = int(j_merged.count)
        np.testing.assert_array_equal(t_merged.items.uid[r, :n].numpy(), np.asarray(j_merged.items.uid)[:n])
        np.testing.assert_array_equal(t_merged.items.val[r, :n].numpy().view(np.uint32),
                                      np.asarray(j_merged.items.val)[:n].view(np.uint32))


# ---------------------------------------------------------- the numpy oracle
S_CHAOS, FLAT_CAP = 2, 128  # tests/test_chaos.py: every scenario spills
SCENARIOS = {sc.name: sc for sc in TC.all_scenarios(R)}
SCENARIO_IDS = sorted(SCENARIOS)


def test_scenario_copies_equal_reference():
    """Every generator of the port's copy gives the reference's schedule,
    array for array, and the same uid law."""
    gens = ["capacity_drought", "rotating_hotspot", "burst_storm", "convergecast",
            "rank_brownout", "sustained_overload", "incast_collapse"]
    for name in gens:
        for seed in (0, 5):
            a, b = getattr(TC, name)(R, seed=seed), getattr(JS, name)(R, seed=seed)
            assert (a.name, a.num_ranks, a.rounds, a.emits_per_round) == (
                b.name, b.num_ranks, b.rounds, b.emits_per_round)
            np.testing.assert_array_equal(a.dests, b.dests)
            assert a.uid(2, 3, 4) == b.uid(2, 3, 4) and a.emitted == b.emitted
    assert [s.name for s in TC.all_scenarios(R)] == [s.name for s in JS.all_scenarios(R)]
    assert [s.name for s in TC.overload_scenarios(R)] == [s.name for s in JS.overload_scenarios(R)]
    for rnd in (0, 3, 7):
        np.testing.assert_array_equal(TC.brownout_mask(R)(rnd), JS.brownout_mask(R)(rnd))


@pytest.mark.parametrize("name", SCENARIO_IDS)
def test_oracle_copy_equals_reference(name):
    sc_t, sc_j = SCENARIOS[name], {s.name: s for s in JS.all_scenarios(R)}[name]
    np.testing.assert_array_equal(TC.expected_by_rank(sc_t), JO.expected_by_rank(sc_j))
    for S, cap in ((S_CHAOS, FLAT_CAP), (1, 16)):  # lossless, and receiver-drop territory
        got = TC.simulate_flat_retain(sc_t, peer_capacity=S, capacity=cap)
        want = JO.simulate_flat_retain(sc_j, peer_capacity=S, capacity=cap)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# --------------------------------------------------------------- the drive
@work_item
@dataclasses.dataclass
class ChaosItem:
    uid: torch.Tensor  # () i32: the scenario's (round, rank, lane) identity
    val: torch.Tensor  # (2,) f32 ballast derived from the uid


def _chaos_proto():
    return ChaosItem(uid=torch.zeros((), dtype=torch.int32), val=torch.zeros(2))


def _val_of(uid):
    f = uid.to(torch.float32)
    return torch.stack([f * 0.5, f % 7.0], dim=-1)


M32 = (1 << 32) - 1


def scenario_drive(sc, cfg, *, max_rounds=64):
    """Drive ``sc`` through the port: round 0's emissions seed the queue,
    body round ``rnd`` consumes its arrivals into per-rank (count, Σuid,
    Σuid²) mod 2³² checksums and emits schedule row ``rnd + 1`` (the
    ``repro.chaos.run_scenario``'s law).  One segment per round, so the retained
    rows and their largest age are read after every forward.  Returns the
    accounting dict."""
    R_, C, E = sc.num_ranks, cfg.capacity, sc.emits_per_round
    dests = torch.from_numpy(np.asarray(sc.dests, np.int32))
    me = torch.arange(R_, dtype=torch.int64)[:, None]
    lane = torch.arange(C)[None, :]
    bad = []

    def emit(q, rnd):
        row = dests[min(max(rnd, 0), sc.rounds - 1)]
        mask = (row >= 0) & (rnd < sc.rounds)
        uid = ((rnd * R_ + me) * E + torch.arange(E)).to(torch.int32)
        return enqueue(q, ChaosItem(uid=uid, val=_val_of(uid)), torch.where(mask, row, DISCARD), mask)

    def round_fn(q_in, acc, rnd):
        valid = lane < q_in.count[:, None]
        u = q_in.items.uid.to(torch.int64)
        bad.append(int((valid[:, :, None] & (q_in.items.val != _val_of(q_in.items.uid))).sum()))
        acc = acc + torch.stack([valid.sum(1), torch.where(valid, u, 0).sum(1),
                                 torch.where(valid, u * u, 0).sum(1)], dim=1)
        out = emit(make_queue(_chaos_proto(), C, num_ranks=R_, device="cpu"), rnd + 1)
        return out, acc & M32

    q0 = emit(make_queue(_chaos_proto(), C, num_ranks=R_, device="cpu"), 0)
    comm = StackedCollectives()
    carry = TTERM.drive_start(q0, torch.zeros(R_, 3, dtype=torch.int64), cfg, comm=comm)
    retained, ages = [], []

    def observe(c):
        q = c["q"]
        retained.append(int(((lane < q.count[:, None]) & (q.dest >= 0)).sum()))
        ages.append(int(c["age"].max()))

    observe(carry)
    while carry["rnd"] < max_rounds and int(carry["total"]) > 0:
        carry = TTERM.drive_segment(round_fn, carry, cfg, seg_end=carry["rnd"] + 1, comm=comm)
        observe(carry)
    q, acc, rounds, done, age = TTERM.drive_finalize(carry, cfg)
    return {"delivered": acc.numpy().astype(np.uint32), "drops": int(q.drops.sum()),
            "rounds": rounds, "done": done, "resident": int(q.count.sum()),
            "retained_trace": retained, "age_trace": ages, "bad_ballast": sum(bad),
            "final_age": age, "final_q": q, "comm": comm}


@pytest.mark.parametrize("marshal", ["sort", "scatter"])
@pytest.mark.parametrize("name", SCENARIO_IDS)
def test_flat_retain_drive_equals_oracle(name, marshal):
    """The port's flat padded retain drive against the port's oracle (equal
    to the reference's, above), round for round: rounds, the retained rows
    and their largest age after every forward, drops, ``done``, and the
    delivered checksums, which equal ``expected_by_rank``."""
    sc = SCENARIOS[name]
    sim = TC.simulate_flat_retain(sc, peer_capacity=S_CHAOS, capacity=FLAT_CAP)
    assert sim["done"] and sim["drops"] == 0
    res = scenario_drive(sc, ForwardConfig(R, FLAT_CAP, peer_capacity=S_CHAOS, marshal=marshal,
                                           overflow="retain"))
    np.testing.assert_array_equal(res["delivered"], TC.expected_by_rank(sc))
    np.testing.assert_array_equal(res["delivered"], sim["delivered"])
    assert (res["rounds"], res["done"], res["drops"], res["resident"]) == (sim["rounds"], True, 0, 0)
    assert res["retained_trace"] == sim["retained_trace"]
    assert res["age_trace"] == sim["age_trace"]
    assert res["bad_ballast"] == 0
    # one payload and one count all_to_all a forward: retention adds no call
    assert res["comm"].count("all_to_all") == 2 * (res["rounds"] + 1)


def test_truncated_retain_drive_returns_live_ages():
    """``run_until_done``'s fifth output: on a truncated run, the ages of
    the rows still retained (the oracle's age trace at that forward)."""
    sc = SCENARIOS["convergecast"]
    cfg = ForwardConfig(R, FLAT_CAP, peer_capacity=S_CHAOS, overflow="retain")
    full = scenario_drive(sc, cfg)
    cut = scenario_drive(sc, cfg, max_rounds=3)
    assert cut["rounds"] == 3 and not cut["done"]
    q, age = cut["final_q"], cut["final_age"]
    lane = torch.arange(FLAT_CAP)[None, :]
    held = (lane < q.count[:, None]) & (q.dest >= 0)
    assert int(held.sum()) == full["retained_trace"][3] > 0
    assert int(age[held].min()) >= 1 and int(age.max()) == full["age_trace"][3]
    assert int(age[~held].abs().sum()) == 0


def test_rafi_context_retain_entry_points():
    """``RafiContext`` under retain: ``forward_rays`` returns the ages and
    ``run_until_done`` the final ages as a fifth output."""
    ctx = RafiContext(R, _tproto(), capacity=CAP, overflow="retain", device="cpu")
    q = ctx.make_queue()
    rays = TRay(origin=torch.ones(R, N_EMIT, 3), direction=torch.ones(R, N_EMIT, 3),
                tmin=torch.zeros(R, N_EMIT), pixel=torch.arange(R * N_EMIT, dtype=torch.int32).reshape(R, N_EMIT),
                integral=torch.zeros(R, N_EMIT))
    q = enqueue(q, rays, torch.from_numpy(pattern_dest("hotspot", 3)), torch.ones(R, N_EMIT, dtype=torch.bool))
    nq, total, age = ctx.forward_rays()(q)
    assert int(total) == 120 and int(age.max()) == 1
    out = ctx.run_until_done(lambda qi, aux, rnd: (make_queue(_tproto(), CAP, num_ranks=R, device="cpu"),
                                                  aux + qi.count))(q, torch.zeros(R, dtype=torch.int32))
    assert len(out) == 5 and out[3] and int(out[1].sum()) == R * N_EMIT - 72
    assert int(out[4].abs().sum()) == 0

