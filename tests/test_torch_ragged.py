"""The port's ragged exchange (``exchange="ragged"``) against the JAX round,
the port's own onehot and padded placements, and the drives and apps it
opens.

The JAX ragged round does not run on XLA:CPU (``ragged-all-to-all`` is
unimplemented there, ROADMAP R5), so it is held through four oracles:

* ``ragged_control_plane`` against ``repro.core.stages``'s, bit for bit,
  on random count matrices and capacities (pure jnp, no collective).
* A stand-in for ``repro.compat.ragged_all_to_all`` built from
  ``jax.lax.all_gather`` of the operand and the size vectors and one
  scatter, itself held against a numpy model of the op; swapped in with
  ``monkeypatch`` (the reference reaches the op through the module
  attribute, so no file of ``repro`` changes).  Under it the JAX
  ``exchange_ragged`` runs inside ``shard_map`` in every configuration:
  drop, retain and credit, S ∈ {1, 2, 4}, both marshals, telemetry on.
  The port's ``exchange_ragged`` equals it on every output, lanes below
  the count.
* The port's onehot round (the all-gather oracle): equal placement with or
  without cuts, since both truncate in source order at ``capacity``; the
  drops agree summed over ranks (ragged counts them at the sender, onehot
  at the receiver).
* The port's padded round where no clamp cuts anything.

Tolerance: none — everything here moves or counts data; the apps' images
and trajectories are compared bit for bit against the padded route and
their single-rank oracles.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro import compat
from repro import telemetry as JTM
from repro.chaos import driver as JD
from repro.chaos import scenarios as JS
from repro.core import ForwardConfig as JForwardConfig
from repro.core import exchange as JX
from repro.core import sorting as JSORT
from repro.core import stages as JST
from repro.obs import phases as JOP
from repro_torch import chaos as TC
from repro_torch import telemetry as TM
from repro_torch.chaos import driver as TD
from repro_torch.core import ForwardConfig, StackedCollectives, WorkQueue, forward_work, work_item
from repro_torch.core import exchange as X
from repro_torch.core import stages as ST
from repro_torch.core.collectives import Call
from repro_torch.obs import phases as OP
from repro_torch.tune import controller as TUNE

from test_torch_retain import scenario_drive

CPU = dict(device="cpu")
_STAT_FIELDS = [f.name for f in dataclasses.fields(TM.RoundStats)]


# ------------------------------------------------------------ the stand-in
def standin_ragged_all_to_all(operand, output, input_offsets, send_sizes, output_offsets, recv_sizes, *,
                              axis_name):
    """``jax.lax.ragged_all_to_all`` from an ``all_gather`` of the operand
    and the sender-side vectors, then one scatter into ``output``: row ``i``
    of sender ``s`` lands at ``output_offsets_s[me] + i −
    input_offsets_s[me]`` while ``i − input_offsets_s[me] <
    send_sizes_s[me]``; every other row keeps ``output``'s value."""
    del recv_sizes  # the receiver's sizes mirror the senders'
    ops = jax.lax.all_gather(operand, axis_name)  # (R, C, W)
    io, ss, oo = (jax.lax.all_gather(v, axis_name) for v in (input_offsets, send_sizes, output_offsets))
    me = jax.lax.axis_index(axis_name)
    R, C, W = ops.shape
    j = jnp.arange(C)[None, :] - io[:, me][:, None]
    ok = (j >= 0) & (j < ss[:, me][:, None])
    dst = jnp.where(ok, oo[:, me][:, None] + j, output.shape[0])
    return output.at[dst.reshape(-1)].set(ops.reshape(R * C, W), mode="drop")


def numpy_ragged_all_to_all(x, output, io, ss, oo):
    """The op's semantics on stacked numpy arrays: ``x (R, C, W)``,
    ``output (R, cap, W)``, sender-side tables ``(R_src, R_dst)``."""
    out = output.copy()
    R = x.shape[0]
    for s in range(R):
        for d in range(R):
            n = ss[s, d]
            out[d, oo[s, d]:oo[s, d] + n] = x[s, io[s, d]:io[s, d] + n]
    return out


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setattr(compat, "ragged_all_to_all", standin_ragged_all_to_all)


def _mesh(R):
    return Mesh(np.array(jax.devices()[:R]), ("data",))


def _random_op_case(rng, R, C, cap, W, in_source_order):
    """Valid random parameters of the op: per receiver, disjoint landing
    intervals (in source order, or in a random order), per sender segments
    anywhere inside its ``C`` rows."""
    ss = np.zeros((R, R), np.int32)
    oo = np.zeros((R, R), np.int32)
    for d in range(R):
        sizes = rng.integers(0, cap // R + 1, R)
        gaps = rng.integers(0, 3, R)
        order = np.arange(R) if in_source_order else rng.permutation(R)
        pos = 0
        for s in order:
            pos += gaps[s]
            if pos + sizes[s] > cap:
                sizes[s] = max(0, cap - pos)
            ss[s, d], oo[s, d] = sizes[s], pos
            pos += sizes[s]
    io = np.stack([rng.integers(0, C - ss[s] + 1) for s in range(R)]).astype(np.int32)
    x = rng.integers(0, 2**31, (R, C, W)).astype(np.int32)
    output = rng.integers(0, 2**31, (R, cap, W)).astype(np.int32)
    return x, output, io, ss, oo


@pytest.mark.parametrize("R,seed", [(3, 0), (5, 1), (8, 2), (8, 3)])
def test_standin_equals_numpy_model(R, seed):
    """The stand-in, in ``shard_map`` on R devices, moves exactly the rows
    the numpy model moves, landing order arbitrary."""
    rng = np.random.default_rng(seed)
    x, output, io, ss, oo = _random_op_case(rng, R, 40, 48, 3, in_source_order=False)
    want = numpy_ragged_all_to_all(x, output, io, ss, oo)
    fn = jax.jit(compat.shard_map(
        lambda a, o, i, s, f: standin_ragged_all_to_all(a[0], o[0], i[0], s[0], f[0], s[0], axis_name="data")[None],
        mesh=_mesh(R), in_specs=(P("data"),) * 5, out_specs=P("data")))
    got = np.asarray(fn(*(jnp.asarray(a) for a in (x.view(np.uint32), output.view(np.uint32), io, ss, oo))))
    np.testing.assert_array_equal(got.view(np.int32), want)


@pytest.mark.parametrize("given_output", [True, False])
@pytest.mark.parametrize("R,seed", [(3, 4), (6, 5), (8, 6)])
def test_stacked_op_equals_numpy_model(R, seed, given_output):
    """``StackedCollectives.ragged_all_to_all`` moves the model's rows
    (landing intervals in source order, its precondition); with an
    ``output`` every other row keeps it, without one they carry no
    contract; one call recorded at its static result bytes."""
    rng = np.random.default_rng(seed)
    x, output, io, ss, oo = _random_op_case(rng, R, 40, 48, 3, in_source_order=True)
    want = numpy_ragged_all_to_all(x, output, io, ss, oo)
    comm = StackedCollectives()
    t = torch.from_numpy
    got = comm.ragged_all_to_all(t(x), t(output) if given_output else None, input_offsets=t(io), send_sizes=t(ss),
                                 output_offsets=t(oo), recv_sizes=t(ss.T.copy()), capacity=48).numpy()
    if given_output:
        np.testing.assert_array_equal(got, want)
    else:
        for s in range(R):
            for d in range(R):
                sl = slice(oo[s, d], oo[s, d] + ss[s, d])
                np.testing.assert_array_equal(got[d, sl], want[d, sl])
    assert dict(comm.calls) == {Call("ragged_all_to_all", R * 48 * 3 * 4, (R, 48, 3)): 1}


def test_stacked_op_refuses_an_int32_overflow():
    comm = StackedCollectives()
    x = torch.zeros(2, 2**30, 1, dtype=torch.int32).expand(2, 2**30, 1)
    z = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 row index"):
        comm.ragged_all_to_all(x, None, input_offsets=z, send_sizes=z, output_offsets=z, recv_sizes=z, capacity=4)


# ------------------------------------------------------ the control plane
@pytest.mark.parametrize("seed", range(6))
def test_control_plane_equals_reference(seed):
    """Every rank's row of the port's control plane equals the reference's
    vectors at ``me = r``: random R ∈ {3..8}, counts and capacities."""
    rng = np.random.default_rng(seed)
    R = int(rng.integers(3, 9))
    cnt = rng.integers(0, 40, (R, R)).astype(np.int32)
    if seed % 2:
        cnt[:, rng.integers(0, R)] *= 4  # a hot column, cut deep
    for cap in (1, int(rng.integers(2, 60)), int(cnt.sum(axis=0).max()), 10_000):
        ss, oo, rs = ST.ragged_control_plane(torch.from_numpy(cnt), cap)
        for r in range(R):
            want = JST.ragged_control_plane(jnp.asarray(cnt), jnp.int32(r), cap)
            for got, w in zip((ss[r], oo[r], rs[r]), want):
                np.testing.assert_array_equal(got.numpy(), np.asarray(w))


# ------------------------------------------- the exchange against JAX's
R8, CAP, W = 8, 64, 5
_JAX_FNS = {}


def _traffic(kind, R, seed):
    """``(words (R, CAP, W) int32, dest (R, CAP), count (R,), age (R, CAP),
    credits (R, R))``: ``random`` mixes DISCARD and out-of-range
    destinations over random counts; ``hotspot`` sends 60% of every rank's
    lanes to rank 1, which the receiver clamp cuts; ``light`` keeps every
    column total within capacity."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-2**31, 2**31, (R, CAP, W)).astype(np.int32)
    if kind == "light":
        count = rng.integers(0, CAP // R + 1, R)
        dest = rng.integers(0, R, (R, CAP))
    else:
        count = rng.integers(CAP // 4, CAP + 1, R)
        dest = rng.integers(-1, R + 2, (R, CAP))
        if kind == "hotspot":
            dest = np.where(rng.random((R, CAP)) < 0.6, 1, dest)
    age = rng.integers(0, 5, (R, CAP))
    credits = rng.integers(-3, 3 * CAP // 2, (R, R))
    return words, dest.astype(np.int32), count.astype(np.int32), age.astype(np.int32), credits.astype(np.int32)


def jax_exchange(R, marshal, overflow, flow, shards, reserve, inputs):
    """The JAX ``exchange_ragged`` (telemetry on) in ``shard_map`` on R
    devices under the stand-in; returns its plan and outputs, stacked
    numpy."""
    key = (R, marshal, overflow, flow, shards, reserve)
    if key not in _JAX_FNS:
        proto = JTM.make_stats(1, 8)

        def kernel(words, dest, count, age, credits):
            d, c = dest[0], count[0, 0]
            if marshal == "scatter":
                dest_clean, dest_rank, hist = JSORT.destination_rank(d, c, R)
                perm = None
            else:
                perm, _sd, hist = JSORT.sort_permutation(d, c, R)
                dest_clean = dest_rank = None
            kw = dict(overflow=overflow, age=age[0]) if overflow == "retain" else {}
            if flow == "credit":
                kw.update(flow="credit", credits=credits[0], credit_reserve=reserve)
            res = JX.exchange_ragged(
                words[0], perm, hist[:R], axis_name="data", num_ranks=R, capacity=CAP, marshal=marshal,
                dest_clean=dest_clean, dest_rank=dest_rank, telemetry=True, pipeline_shards=shards, **kw)
            out, recv_sizes, new_count, drops = res[:4]
            plan = (perm, perm) if perm is not None else (dest_clean, dest_rank)
            pend = tuple(res[4][0]) if overflow == "retain" else (out[:, 0], dest[0], dest[0], new_count)
            cred = res[5] if flow == "credit" else hist[:R]
            lead = lambda a: jnp.asarray(a)[None]
            return (tuple(lead(a) for a in (out, recv_sizes, new_count, drops, hist[:R]) + plan + pend + (cred,))
                    + (JTM.stack_ring(res[-1]),))

        spec = (P("data"),) * 12 + (jax.tree.map(lambda _: P("data"), proto),)
        _JAX_FNS[key] = jax.jit(compat.shard_map(kernel, mesh=_mesh(R), in_specs=(P("data"),) * 5, out_specs=spec))
    words, dest, count, age, credits = inputs
    res = _JAX_FNS[key](jnp.asarray(words.view(np.uint32)), jnp.asarray(dest), jnp.asarray(count[:, None]),
                        jnp.asarray(age), jnp.asarray(credits))
    names = ("out", "recv_sizes", "new_count", "drops", "send_counts", "plan0", "plan1",
             "p_rows", "p_dest", "p_age", "p_n", "credits_out")
    got = {k: np.asarray(v) for k, v in zip(names, res[:-1])}
    got["stats"] = {k: np.asarray(getattr(res[-1], k)) for k in _STAT_FIELDS}
    return got


def port_exchange(R, marshal, overflow, flow, shards, reserve, inputs, want, comm=None, telemetry=True):
    """The port's ``exchange_ragged`` on the JAX round's own plan."""
    words, _dest, _count, age, credits = inputs
    t = lambda a: torch.from_numpy(np.array(a))
    plan = dict(perm=t(want["plan0"]))
    if marshal == "scatter":
        plan = dict(perm=None, dest_clean=t(want["plan0"]), dest_rank=t(want["plan1"]))
    kw = dict(overflow=overflow, age=t(age)) if overflow == "retain" else {}
    if flow == "credit":
        kw.update(flow="credit", credits=t(credits), credit_reserve=reserve)
    return X.exchange_ragged(
        t(words), send_counts=t(want["send_counts"]), comm=StackedCollectives() if comm is None else comm,
        num_ranks=R, capacity=CAP, marshal=marshal, telemetry=telemetry, pipeline_shards=shards, **plan, **kw)


def assert_same_exchange(got, want, overflow, flow):
    """Every output, bit for bit: the arrivals on their landed lanes
    ``[front, front + new_count)`` (the reference lands at 0 and shifts by
    the spill front, the port lands behind it), the pending block on its
    ``[0, n)`` prefix."""
    out, recv_sizes, new_count, drops, pending, credits_out, stats = got
    np.testing.assert_array_equal(recv_sizes.numpy(), want["recv_sizes"])
    np.testing.assert_array_equal(new_count.numpy(), want["new_count"])
    np.testing.assert_array_equal(drops.numpy(), want["drops"])
    front = np.zeros(out.shape[0], np.int64)
    if overflow == "retain":
        rows, dest, age, n = (a.numpy() for a in pending[0])
        np.testing.assert_array_equal(n, want["p_n"])
        front = np.minimum(n, CAP)
        for r in range(out.shape[0]):
            k = int(n[r])
            np.testing.assert_array_equal(rows[r, :k], want["p_rows"][r, :k].view(np.int32))
            np.testing.assert_array_equal(dest[r, :k], want["p_dest"][r, :k])
            np.testing.assert_array_equal(age[r, :k], want["p_age"][r, :k])
    else:
        assert pending == ()
    for r in range(out.shape[0]):
        sl = slice(int(front[r]), int(front[r] + want["new_count"][r]))
        np.testing.assert_array_equal(out[r, sl].numpy(), want["out"][r, sl].view(np.int32))
    if flow == "credit":
        np.testing.assert_array_equal(credits_out.numpy(), want["credits_out"])
    else:
        assert credits_out is None
    for k in _STAT_FIELDS:
        np.testing.assert_array_equal(getattr(stats, k).numpy(), want["stats"][k], err_msg=k)


_MODES = [("drop", "open"), ("retain", "open"), ("retain", "credit")]


def call_law(comm):
    """``{(kind, shape): calls}`` of a recorder."""
    out = {}
    for c, n in comm.calls.items():
        out[(c.kind, c.shape)] = out.get((c.kind, c.shape), 0) + n
    return out


def call_law_of(R, shards, flow, cap=CAP, words=W, psum=False):
    """The ragged round's calls: S ``ragged_all_to_all`` and S count
    ``all_gather``s, shard 0's one int32 column wider under credit."""
    law = {("ragged_all_to_all", (R, cap, words)): shards}
    for k in range(shards):
        key = ("all_gather", (R, R + (flow == "credit" and k == 0)))
        law[key] = law.get(key, 0) + 1
    if psum:
        law[("psum", (R,))] = 1
    return law


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("mode", _MODES, ids=lambda m: m[1] if m[1] == "credit" else m[0])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_exchange_equals_reference_under_standin(standin, marshal, mode, shards):
    """The port's ragged exchange against the JAX one on the same plan,
    hot-spot traffic (the control plane cuts rank 1's column), R=8."""
    overflow, flow = mode
    inputs = _traffic("hotspot", R8, seed=11 + shards)
    want = jax_exchange(R8, marshal, overflow, flow, shards, CAP // 2, inputs)
    comm = StackedCollectives()
    got = port_exchange(R8, marshal, overflow, flow, shards, CAP // 2, inputs, want, comm=comm)
    assert_same_exchange(got, want, overflow, flow)
    if flow == "credit":  # the grant gated the counts: rows held beyond the clamp's cut
        assert (want["stats"]["credits_granted"] < want["send_counts"].sum(axis=1)[:, None]).any()
    else:
        assert want["recv_sizes"].sum(axis=1).max() == CAP  # the receiver clamp fired
    if overflow == "retain":
        assert want["p_n"].sum() > 0 and want["stats"]["rows_held"].sum() > 0
    # the call law: S payload and S count calls; credit widens the count by one column
    assert call_law(comm) == call_law_of(R8, shards, flow)
    # telemetry adds nothing: the same outputs, calls and no stats without it
    plain = StackedCollectives()
    off = port_exchange(R8, marshal, overflow, flow, shards, CAP // 2, inputs, want, comm=plain, telemetry=False)
    assert off[-1] is None and plain.calls == comm.calls
    for a, b in zip(got[:4], off[:4]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("R,kind,marshal,mode", [
    (3, "random", "sort", ("drop", "open")), (5, "hotspot", "scatter", ("retain", "open")),
    (6, "light", "sort", ("retain", "credit")), (4, "random", "scatter", ("retain", "credit")),
    (8, "light", "scatter", ("drop", "open")), (7, "hotspot", "sort", ("retain", "credit")),
])
def test_exchange_equals_reference_at_other_rank_counts(standin, R, kind, marshal, mode):
    overflow, flow = mode
    inputs = _traffic(kind, R, seed=R)
    want = jax_exchange(R, marshal, overflow, flow, 1, 3, inputs)
    assert_same_exchange(port_exchange(R, marshal, overflow, flow, 1, 3, inputs, want), want, overflow, flow)


# ------------------------------------------------ forward_work against JAX
@pytest.mark.parametrize("traffic", [("uniform", 3), ("hotspot", 0), ("hotspot", 3)], ids=lambda t: f"{t[0]}{t[1]}")
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("overflow", ["drop", "retain"])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_forward_round_equals_reference_under_standin(standin, mesh8, marshal, overflow, shards, traffic):
    """One ragged ``forward_work`` round against the JAX round (the cases of
    ``test_torch_retain``): counts, drops, totals, destinations, item bits
    and ages on lanes ``< count``; the retain merge of the port's direct
    landing equals the reference's land-then-shift."""
    from test_torch_retain import R, assert_same_round, jax_round, pattern_dest, port_round

    kw = dict(exchange="ragged", marshal=marshal, overflow=overflow, pipeline_shards=shards)
    inp, want = jax_round(mesh8, JForwardConfig("data", R, 64, **kw), pattern_dest(*traffic))
    assert_same_round(port_round(ForwardConfig(R, 64, **kw), inp), want)


@pytest.mark.parametrize("kind", ["spread", "hotspot", "random"])
@pytest.mark.parametrize("mode", _MODES, ids=lambda m: m[1] if m[1] == "credit" else m[0])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_round_stats_equal_reference_under_standin(standin, marshal, mode, kind):
    """Every ``RoundStats`` field of a ragged round (the merge's
    ``retained_rows`` and ``age_max`` included), the counts and drops, equal
    the JAX round's; credit rounds start from fully credited receivers."""
    from test_torch_telemetry import _pair

    overflow, flow = mode
    kw = dict(exchange="ragged", marshal=marshal, overflow=overflow, flow=flow, telemetry=True, telemetry_buckets=8)
    got = _pair(JForwardConfig("data", 8, 64, **kw), ForwardConfig(8, 64, **kw), kind)
    # the column demand is replicated on every rank: its total is R× the rows offered
    assert (got[2]["demand_total"] == got[2]["demand_total"][0]).all()


# --------------------------------------------- placement oracles, no JAX
@work_item
@dataclasses.dataclass
class Probe:
    val: torch.Tensor  # () f32, random bits
    uid: torch.Tensor  # () i32, (rank, lane)


def _probe_queue(rng, R, C, kind):
    """A rank-stacked queue of ``Probe`` rows: ``light`` keeps every
    destination's total within ``C // 2`` (no clamp of any backend cuts),
    ``cut`` floods a random rank, ``random`` mixes DISCARD, out-of-range
    destinations and counts up to ``C``."""
    if kind == "light":
        count = rng.integers(0, C // (2 * R) + 1, R)
        dest = rng.integers(0, R, (R, C))
    else:
        count = rng.integers(0, C + 1, R)
        dest = rng.integers(-1, R + 2, (R, C))
        if kind == "cut":
            dest = np.where(rng.random((R, C)) < 0.5, rng.integers(0, R), dest)
    val = rng.standard_normal((R, C)).astype(np.float32)
    uid = (np.arange(R)[:, None] * C + np.arange(C)[None, :]).astype(np.int32)
    t = torch.from_numpy
    return WorkQueue(items=Probe(val=t(val), uid=t(uid)), dest=t(dest.astype(np.int32)),
                     count=t(count.astype(np.int32)), drops=torch.zeros(R, dtype=torch.int32))


def _lanes(q):
    """Each rank's live rows as (uid, val bits) lists."""
    return [(q.items.uid[r, :n].tolist(), q.items.val[r, :n].view(torch.int32).tolist())
            for r, n in enumerate(q.count.tolist())]


def _round(q, cfg, comm=None):
    out = forward_work(q, cfg, comm=comm)
    return out[0], int(out[1])


@pytest.mark.parametrize("seed", range(12))
def test_random_rounds_equal_onehot(seed):
    """Random ragged rounds over R ∈ {3..8}, both marshals, drop and
    retain, 1, 2 or 4 shards, random capacities and fills: the rows each
    receiver gets equal the onehot oracle's in (source, lane) order; the
    counts too, and the drops summed over ranks (ragged counts them at the
    sender, onehot at the receiver).  Under retain the arrivals sit behind
    the retained rows, whose destinations survive."""
    rng = np.random.default_rng(100 + seed)
    R = int(rng.integers(3, 9))
    shards = int(rng.choice([1, 2, 4]))
    C = shards * int(rng.integers(4, 24))
    marshal = ["sort", "scatter"][seed % 2]
    q = _probe_queue(rng, R, C, ["light", "cut", "random"][seed % 3])
    oq, ototal = _round(q, ForwardConfig(R, C, exchange="onehot", marshal=marshal))
    gq, gtotal = _round(q, ForwardConfig(R, C, exchange="ragged", marshal=marshal, pipeline_shards=shards))
    assert _lanes(gq) == _lanes(oq)
    assert gtotal == ototal and int(gq.drops.sum()) == int(oq.drops.sum())
    rq, rtotal, age = forward_work(q, ForwardConfig(R, C, exchange="ragged", marshal=marshal,
                                                   pipeline_shards=shards, overflow="retain"))
    live = torch.arange(C)[None, :] < q.count[:, None]
    assert rtotal == int(rq.count.sum())
    assert rtotal + int(rq.drops.sum()) == int((live & (q.dest >= 0) & (q.dest < R)).sum())
    for r in range(R):
        k = int(((rq.dest[r] >= 0) & (torch.arange(C) < rq.count[r])).sum())  # retained: rank r's own rows
        assert (rq.items.uid[r, :k] // C == r).all() and (age[r, :k] == 1).all()
        arrivals = rq.items.uid[r, k:int(rq.count[r])].tolist()
        in_order = _arrivals_in_source_order(q, R, r)
        assert arrivals == in_order[:len(arrivals)] and len(arrivals) == min(len(in_order), C - k)


def _arrivals_in_source_order(q, R, r):
    """The uids addressed to rank ``r`` in (source, lane) order."""
    out = []
    for s in range(R):
        n = int(q.count[s])
        out += [int(u) for u, d in zip(q.items.uid[s, :n], q.dest[s, :n]) if int(d) == r]
    return out


def _same_every_lane(a, b):
    return (torch.equal(a.count, b.count) and torch.equal(a.drops, b.drops) and torch.equal(a.dest, b.dest)
            and torch.equal(a.items.uid, b.items.uid) and torch.equal(a.items.val.view(torch.int32),
                                                                      b.items.val.view(torch.int32)))


@pytest.mark.parametrize("R,seed", [(3, 0), (5, 1), (8, 2)])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_no_cut_round_equals_onehot_and_padded(R, seed, marshal):
    """Where no clamp cuts (every column within capacity, every segment
    within the padded slots), the ragged, onehot and padded rounds place
    the same rows in the same (source, lane) order, with no drop."""
    rng = np.random.default_rng(seed)
    C = 48
    q = _probe_queue(rng, R, C, "light")
    got = {ex: _round(q, ForwardConfig(R, C, exchange=ex, marshal=marshal)) for ex in ("ragged", "onehot", "padded")}
    assert int(q.count.max()) <= ForwardConfig(R, C).peer_capacity  # no padded segment is cut
    for ex in ("onehot", "padded"):
        assert _lanes(got["ragged"][0]) == _lanes(got[ex][0]) and got["ragged"][1] == got[ex][1]
    assert int(got["ragged"][0].drops.sum()) == 0 and got["ragged"][1] > 0


@pytest.mark.parametrize("overflow", ["drop", "retain"])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_shards_equal_one_shard_on_every_lane(marshal, overflow):
    """S = 2 and S = 4 give the one-shard round's queue on every lane
    (the shards land the bulk rows at their bulk positions), and S payload
    and S count calls."""
    rng = np.random.default_rng(7)
    q = _probe_queue(rng, 6, 64, "cut")
    cfg = ForwardConfig(6, 64, exchange="ragged", marshal=marshal, overflow=overflow)
    bulk = forward_work(q, cfg)
    for shards in (2, 4):
        comm = StackedCollectives()
        got = forward_work(q, dataclasses.replace(cfg, pipeline_shards=shards), comm=comm)
        assert _same_every_lane(got[0], bulk[0]) and int(got[1]) == int(bulk[1])
        if overflow == "retain":
            assert torch.equal(got[2], bulk[2])
        assert call_law(comm) == call_law_of(6, shards, "open", cap=64, words=2, psum=True)


@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_call_law_telemetry_retain_health_add_nothing(marshal):
    """A bulk ragged round issues one ``ragged_all_to_all``, one count
    ``all_gather`` and the ``psum``, whatever rides along: telemetry,
    retain and a health mask add no call; credit widens the count call by
    exactly one int32 column; the payload call records ``(capacity, W)``
    words a rank."""
    rng = np.random.default_rng(3)
    R, C = 8, 32
    q = _probe_queue(rng, R, C, "cut")
    health = torch.ones(R, dtype=torch.bool)
    health[2] = False
    for kw in ({}, dict(telemetry=True), dict(overflow="retain"), dict(overflow="retain", telemetry=True),
               dict(overflow="retain", flow="credit", telemetry=True)):
        for h in (None, health):
            comm = StackedCollectives()
            forward_work(q, ForwardConfig(R, C, exchange="ragged", marshal=marshal, **kw), health=h, comm=comm)
            assert call_law(comm) == call_law_of(R, 1, kw.get("flow", "open"), cap=C, words=2, psum=True), kw


def test_health_mask_drains_a_rank():
    """A ragged round with rank 2 unhealthy delivers nothing to it, and
    equals the onehot round with the same mask."""
    rng = np.random.default_rng(9)
    R, C = 8, 32
    q = _probe_queue(rng, R, C, "light")
    health = torch.ones(R, dtype=torch.bool)
    health[2] = False
    gq, gtotal = _round_masked(q, ForwardConfig(R, C, exchange="ragged"), health)
    oq, ototal = _round_masked(q, ForwardConfig(R, C, exchange="onehot"), health)
    assert int(gq.count[2]) == 0 and _lanes(gq) == _lanes(oq) and gtotal == ototal


def _round_masked(q, cfg, health):
    out = forward_work(q, cfg, health=health)
    return out[0], int(out[1])


# ------------------------------------------------------------------ drives
S_CHAOS, FLAT_CAP = 2, 128
SCENARIOS = {sc.name: sc for sc in TC.all_scenarios(8)}
J_SCENARIOS = {sc.name: sc for sc in JS.all_scenarios(8)}


@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_rotating_hotspot_retain_drive_loses_nothing(marshal):
    """``rotating_hotspot(8, 8, 32)`` through the ragged retain drive at
    C=192, where the hot column is cut and rows are held: every emission
    delivered (``expected_by_rank``), no drop, no bad ballast, the padded
    retain drive's checksums.  (On this backend a rank whose own spill front
    plus its column's allowance overflow its queue drops the excess at
    admission, the reference's law; at C=192 that does not happen, at
    C=160 it does.)"""
    sc = TC.rotating_hotspot(8, 8, 32)
    res = scenario_drive(sc, ForwardConfig(8, 192, exchange="ragged", marshal=marshal, overflow="retain"))
    pad = scenario_drive(sc, ForwardConfig(8, 192, peer_capacity=16, marshal=marshal, overflow="retain"))
    np.testing.assert_array_equal(res["delivered"], TC.expected_by_rank(sc))
    np.testing.assert_array_equal(res["delivered"], pad["delivered"])
    assert res["done"] and res["drops"] == 0 and res["bad_ballast"] == 0 and res["resident"] == 0
    assert max(res["retained_trace"]) > 0  # the receiver cut held rows back
    assert call_law(res["comm"])[("ragged_all_to_all", (8, 192, 3))] == res["rounds"] + 1
    cut = scenario_drive(sc, ForwardConfig(8, 160, exchange="ragged", marshal=marshal, overflow="retain"))
    assert cut["drops"] > 0 and cut["resident"] == 0
    assert int(cut["delivered"][:, 0].sum()) + cut["drops"] == int(TC.expected_by_rank(sc)[:, 0].sum())


@pytest.mark.parametrize("name", ["convergecast", "burst_storm", "rotating_hotspot"])
def test_chaos_drop_mode_equals_reference_under_standin(standin, mesh8, name):
    """The chaos driver's ragged case in drop mode, no ``peer_capacity``:
    the port's accounting dict equals the JAX drive's key for key under the
    stand-in (checksums, rounds, drops, ``lost`` and every ring trace)."""
    from test_torch_chaos import assert_same_dict

    kw = dict(capacity=32, overflow="drop", exchange="ragged", max_rounds=64)
    res = TC.run_scenario(8, SCENARIOS[name], **kw, **CPU)
    assert res["lost"] == 0
    assert_same_dict(res, JD.run_scenario(mesh8, J_SCENARIOS[name], **kw))


@pytest.mark.parametrize("flow", ["open", "credit"])
@pytest.mark.parametrize("name", ["convergecast", "capacity_drought", "incast_collapse", "sustained_overload"])
def test_chaos_retain_and_credit_drives_conserve(name, flow):
    """The chaos driver's ragged case in retain mode, open and credit: no
    loss, no drop, every emission delivered (``expected_by_rank``, the
    padded retain drive's checksums)."""
    sc = SCENARIOS[name] if name in SCENARIOS else getattr(TC, name)(8)
    res = TC.run_scenario(8, sc, capacity=FLAT_CAP, overflow="retain", flow=flow, exchange="ragged",
                          max_rounds=256, **CPU)
    pad = TC.run_scenario(8, sc, capacity=FLAT_CAP, peer_capacity=S_CHAOS, overflow="retain", max_rounds=256, **CPU)
    assert res["lost"] == 0 and res["drops"] == 0 and res["done"]
    np.testing.assert_array_equal(res["delivered"], TC.expected_by_rank(sc))
    np.testing.assert_array_equal(res["delivered"], pad["delivered"])


# ------------------------------------------------------- the configuration
def test_peer_capacity_refused_as_the_reference_refuses_it():
    """The reference refuses ``peer_capacity`` on a ragged config (why its
    own ``test_drop_mode_conserves_ragged`` fails, ROADMAP R5); the port
    keeps the refusal, with the same ``ValueError`` and message."""
    with pytest.raises(ValueError) as want:
        JForwardConfig("data", 8, 64, exchange="ragged", peer_capacity=4)
    with pytest.raises(ValueError) as got:
        ForwardConfig(8, 64, exchange="ragged", peer_capacity=4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="does not apply"):
        TC.run_scenario(8, SCENARIOS["convergecast"], capacity=32, peer_capacity=2, exchange="ragged", **CPU)


_FIELD_CHOICES = dict(
    exchange=["padded", "ragged", "ragged", "hierarchical", "onehot", "bogus"],
    marshal=["sort", "scatter", "bogus"], overflow=["drop", "retain", "bogus"], flow=["open", "credit", "bogus"],
    pipeline_shards=[0, 1, 2, 3, 4], peer_capacity=[0, 3, 4, 8], telemetry=[False, True],
    telemetry_window=[0, 1, 16], telemetry_buckets=[1, 2, 8], emit_reserve=[-1, 0, 5, 64],
    sort_method=["pack", "argsort", "bogus"], level_sizes=[(), (2, 4), (2, 2, 2), (8,), (3, 3)],
    level_capacities=[(), (8, 8), (6, 8, 10)], fast_size=[0, 2, 4, 3], node_capacity=[0, 8],
)


@pytest.mark.parametrize("seed", range(4))
def test_config_field_sets_accepted_and_refused_alike(seed):
    """A seeded sample of ``ForwardConfig`` field sets, ragged ones among
    them: the port accepts exactly those the reference accepts, and refuses
    the others with the same exception type (the tier count comes from the
    reference's axis names, from ``level_sizes`` in the port)."""
    rng = np.random.default_rng(seed)
    seen = {"ragged_ok": 0, "refused": 0}
    for _ in range(400):
        kw = {k: v[int(rng.integers(len(v)))] for k, v in _FIELD_CHOICES.items()
              if k == "exchange" or rng.random() < 0.3}
        num_ranks, cap = int(rng.choice([4, 8])), int(rng.choice([8, 64]))
        n_axes = len(kw.get("level_sizes", ())) or 2
        hier = kw.get("exchange") == "hierarchical"
        axes = ("pod", "node", "device")[-n_axes:] if hier and n_axes > 1 else "data"
        outcome = []
        for make in (lambda: JForwardConfig(axes, num_ranks, cap, **kw), lambda: ForwardConfig(num_ranks, cap, **kw)):
            try:
                make()
                outcome.append(None)
            except Exception as e:  # noqa: BLE001 — the type is what is compared
                outcome.append(type(e))
        assert outcome[0] == outcome[1], (num_ranks, cap, kw, outcome)
        seen["ragged_ok"] += outcome[1] is None and kw.get("exchange") == "ragged"
        seen["refused"] += outcome[1] is not None
    assert seen["ragged_ok"] > 0 and seen["refused"] > 0


@pytest.mark.parametrize("kw", [
    {}, dict(marshal="scatter"), dict(overflow="retain"), dict(overflow="retain", flow="credit"),
    dict(telemetry=True), dict(pipeline_shards=4), dict(overflow="retain", flow="credit", pipeline_shards=2,
                                                         marshal="scatter", telemetry=True, emit_reserve=3),
])
def test_every_branch_the_reference_accepts_constructs(kw):
    cfg = ForwardConfig(8, 64, exchange="ragged", **kw)
    JForwardConfig("data", 8, 64, exchange="ragged", **kw)
    assert cfg.peer_capacity == 0 and TM.tier_capacities(cfg) == (64,)


def test_tuner_refuses_ragged_as_the_reference_does():
    from repro.tune import controller as JTUNE

    summary = {"tier_capacities": (64,), "buckets": 8}
    with pytest.raises(ValueError) as want:
        JTUNE.plan_capacities(summary, JForwardConfig("data", 8, 64, exchange="ragged"))
    with pytest.raises(ValueError) as got:
        TUNE.plan_capacities(summary, ForwardConfig(8, 64, exchange="ragged"))
    assert str(got.value) == str(want.value) and "ragged segments are exact" in str(got.value)


def test_recorded_wire_bytes_count_the_ragged_payload():
    """The recorder's ragged call counts its static result bytes, ``(C, W)``
    words a rank, as the reference's HLO reader counts the op; the count
    ``all_gather`` is not an ``all_to_all`` and is not counted."""
    from repro_torch.roofline import analysis as A

    q = _probe_queue(np.random.default_rng(4), 8, 32, "random")
    for shards in (1, 2):
        comm = StackedCollectives()
        forward_work(q, ForwardConfig(8, 32, exchange="ragged", pipeline_shards=shards), comm=comm)
        assert A.recorded_wire_bytes(comm.calls, (8,)) == [shards * 32 * 2 * 4]
        with pytest.raises(ValueError, match="flat"):
            A.recorded_wire_bytes(comm.calls, (2, 4))


# --------------------------------------------------------- observation
def test_phase_keys_equal_the_reference(mesh8):
    """``profile_phases`` of a ragged round gives the reference's
    ``_ragged_phases`` keys, in order, each stage run on the CPU; the
    marshal stage's buffer is the round's send buffer."""
    from helpers import ray_proto

    jcfg = JForwardConfig("data", 8, 64, exchange="ragged")
    want = [k for k, _fn in JOP._ragged_phases(jcfg, 16, 64, ray_proto())]
    for marshal in ("sort", "scatter"):
        cfg = ForwardConfig(8, 64, exchange="ragged", marshal=marshal)
        us = OP.profile_phases(cfg, n_emit=16, cap=64, proto=TD.chaos_proto(), device="cpu")
        assert list(us) == want == ["marshal", "count_collective", "payload_collective"]
        assert all(v > 0 for v in us.values())


# ------------------------------------------------------------------ apps
def test_streamlines_on_ragged_equal_oracle_and_padded():
    from repro_torch.apps import streamlines as sl

    cfg = sl.StreamlineConfig(num_particles=48, max_steps=12)
    got, lengths, stats = sl.run(cfg, num_ranks=8, exchange="ragged", **CPU)
    pad, _l, _s = sl.run(cfg, num_ranks=8, **CPU)
    orc = sl.oracle(cfg, **CPU)
    assert stats["drops"] == 0
    for want in (orc, pad):
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("marshal", ["sort", "scatter"])
def test_vopat_on_ragged_equals_padded_and_one_rank(marshal):
    from repro_torch.apps import vopat

    scene = vopat.VopatScene(width=16, height=16)
    got = vopat.render(scene, num_ranks=8, marshal=marshal, exchange="ragged", **CPU)
    for want in (vopat.render(scene, num_ranks=8, marshal=marshal, **CPU), vopat.render(scene, num_ranks=1, **CPU)):
        np.testing.assert_array_equal(np.asarray(got[0]).view(np.uint32), np.asarray(want[0]).view(np.uint32))


def test_lander_and_schlieren_on_ragged_equal_padded():
    from repro_torch.apps import lander, schlieren

    for app, scene in ((lander.render_forwarding, lander.LanderScene(width=16, height=16)),
                       (schlieren.render, schlieren.SchlierenScene(width=16, height=16))):
        got, want = app(scene, num_ranks=8, exchange="ragged", **CPU), app(scene, num_ranks=8, **CPU)
        np.testing.assert_array_equal(np.asarray(got[0]).view(np.uint32), np.asarray(want[0]).view(np.uint32))


# ----------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from repro_torch import compat as tcompat

    if tcompat.nvcc_path() is None:
        pytest.skip("needs nvcc to build the CUDA kernels")
    return torch.device("cuda")


def _to(q, dev):
    return WorkQueue(items=Probe(val=q.items.val.to(dev), uid=q.items.uid.to(dev)), dest=q.dest.to(dev),
                     count=q.count.to(dev), drops=q.drops.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(marshal="scatter"), dict(overflow="retain", pipeline_shards=4),
                                dict(overflow="retain", flow="credit", marshal="scatter", telemetry=True)])
def test_cuda_ragged_round_equals_cpu(cuda_device, kw):
    """A ragged round on the card (K3 + K1 or K4 + K5, K1 for the spill and
    the stacked copy) equals the same round on the CPU on every lane."""
    q = _probe_queue(np.random.default_rng(21), 8, 4096, "cut")
    cfg = ForwardConfig(8, 4096, exchange="ragged", **kw)
    got, want = forward_work(_to(q, cuda_device), cfg), forward_work(q, cfg)
    assert _same_every_lane(_to(got[0], "cpu"), want[0]) and int(got[1]) == int(want[1])
    for a, b in zip(got[2:], want[2:]):
        if isinstance(b, torch.Tensor):
            assert torch.equal(a.cpu(), b)
