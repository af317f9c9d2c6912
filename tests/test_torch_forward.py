"""The port's forwarding round and drive loop against the JAX reference.

The reference runs under ``shard_map`` on the 8-device ``mesh8`` fixture
with ``use_pallas=False`` (its Pallas rounds fail inside ``shard_map`` on
this JAX; the kernels themselves are held in ``test_torch_kernels.py``).
The port runs the same inputs, made with numpy from a seed, rank-stacked on
the CPU.  Counts, drops, totals and every lane below ``count`` must be
equal bit for bit (tolerance: none); lanes past ``count`` carry no contract.
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
from repro.core import RafiContext as JRafiContext
from repro.core import queue as JQ
from repro.core import run_until_done as j_run_until_done
from repro.core import work_item as j_work_item
from repro_torch.core import (
    DISCARD,
    ForwardConfig,
    StackedCollectives,
    enqueue,
    forward_work,
    make_queue,
    queue_from_reference,
    queue_to_reference,
    run_until_done,
    work_item,
)

R, C = 8, 64


@j_work_item
@dataclasses.dataclass
class JRay44:
    origin: jax.Array
    direction: jax.Array
    tmin: jax.Array
    pixel: jax.Array
    integral: jax.Array
    extra: jax.Array


@work_item
@dataclasses.dataclass
class TRay44:
    origin: torch.Tensor
    direction: torch.Tensor
    tmin: torch.Tensor
    pixel: torch.Tensor
    integral: torch.Tensor
    extra: torch.Tensor


_SHAPES = {"origin": (3,), "direction": (3,), "tmin": (), "pixel": (), "integral": (), "extra": (2,)}


def _jproto():
    return JRay44(**{k: jnp.zeros(s, jnp.int32 if k == "pixel" else jnp.float32)
                     for k, s in _SHAPES.items()})


def _tproto():
    return TRay44(**{k: torch.zeros(s, dtype=torch.int32 if k == "pixel" else torch.float32)
                     for k, s in _SHAPES.items()})


def _case(name, seed=0):
    """(fields (R·C, …), dest (R·C,), count (R,), peer_capacity) for a case."""
    rng = np.random.default_rng(seed)
    fields = {k: rng.normal(size=(R * C,) + s).astype(np.float32) for k, s in _SHAPES.items()}
    fields["pixel"] = np.arange(R * C, dtype=np.int32)
    count = np.full(R, C, np.int32)
    S = 0  # default: 2·ceil(C/R) = 16
    dest = rng.integers(0, R, R * C).astype(np.int32)
    if name == "hot_spot":  # every rank sends everything to rank 0: receiver overflow
        dest[:] = 0
        S = C
    elif name == "sender_overflow":  # peer slots below demand
        S = 4
    elif name == "all_discard":
        dest[:] = DISCARD
    elif name == "count_below_c":  # plus DISCARD and out-of-range lanes
        count = rng.integers(0, C, R).astype(np.int32)
        dest = rng.integers(-1, R + 2, R * C).astype(np.int32)
    return fields, dest, count, S


_CASES = ["uniform", "hot_spot", "sender_overflow", "all_discard", "count_below_c"]
_JAX_ROUNDS = {}


def _jax_round(mesh8, exchange, S, fields, dest, count):
    key = (exchange, S)
    if key not in _JAX_ROUNDS:
        kw = {"peer_capacity": S} if exchange == "padded" else {}
        ctx = JRafiContext(mesh8, _jproto(), capacity=C, exchange=exchange, **kw)
        _JAX_ROUNDS[key] = ctx.forward_rays()
    q = JQ.WorkQueue(
        items=JRay44(**{k: jnp.asarray(v) for k, v in fields.items()}),
        dest=jnp.asarray(dest), count=jnp.asarray(count),
        drops=jnp.zeros(R, jnp.int32),
    )
    nq, total = _JAX_ROUNDS[key](q)
    out = {k: np.asarray(getattr(nq.items, k)) for k in _SHAPES}
    return out, np.asarray(nq.count), np.asarray(nq.drops), int(total)


def _port_round(exchange, S, fields, dest, count, comm=None):
    q = queue_from_reference(fields, dest, count, np.zeros(R, np.int32), R, _tproto(), device="cpu")
    kw = {"peer_capacity": S} if exchange == "padded" else {}
    nq, total = forward_work(q, ForwardConfig(R, C, exchange=exchange, **kw), comm=comm)
    out, _dest, cnt, drops = queue_to_reference(nq)
    assert (_dest == DISCARD).all()
    return out, cnt, drops, int(total)


def _assert_same(a, b):
    (fa, ca, da, ta), (fb, cb, db, tb) = a, b
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(da, db)
    assert ta == tb
    for k in _SHAPES:
        for r in range(R):
            n = int(ca[r])
            x = fa[k].reshape(R, C, -1)[r, :n]
            y = fb[k].reshape(R, C, -1)[r, :n]
            np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))


@pytest.mark.parametrize("exchange", ["padded", "onehot"])
@pytest.mark.parametrize("case", _CASES)
def test_forward_work_equals_reference(mesh8, case, exchange):
    fields, dest, count, S = _case(case)
    if exchange == "onehot":
        S = 0
    want = _jax_round(mesh8, exchange, S, fields, dest, count)
    got = _port_round(exchange, S, fields, dest, count)
    _assert_same(got, want)
    if case == "hot_spot":
        assert got[2].sum() > 0  # the receiver clamp really fired
    if case == "sender_overflow" and exchange == "padded":
        assert got[2].sum() > 0  # the sender clamp really fired


@pytest.mark.parametrize("case", ["uniform", "hot_spot", "all_discard", "count_below_c"])
def test_port_padded_equals_port_onehot(case):
    """Without a sender clamp the production round equals the oracle."""
    fields, dest, count, S = _case(case, seed=1)
    _assert_same(_port_round("padded", S, fields, dest, count),
                 _port_round("onehot", 0, fields, dest, count))


def test_round_issues_one_payload_and_one_count_all_to_all():
    """The budget law on the call recorder: per padded round exactly one
    payload and one count ``all_to_all`` (plus the termination psum)."""
    fields, dest, count, _ = _case("uniform")
    comm = StackedCollectives()
    _port_round("padded", 16, fields, dest, count, comm=comm)
    kinds = [c.kind for c in comm.calls.elements()]
    assert sorted(kinds) == ["all_to_all", "all_to_all", "psum"]
    shapes = sorted(c.shape for c in comm.calls.elements() if c.kind == "all_to_all")
    assert shapes == [(R, R, 1), (R, R, 16, 11)]
    comm.reset()
    _port_round("onehot", 0, fields, dest, count, comm=comm)
    assert comm.count("all_gather") == 2


@pytest.mark.parametrize("sort_method", ["pack", "argsort"])
def test_round_plans_through_k3_for_every_sort_method(monkeypatch, sort_method):
    """No config routes the plan around K3's wrapper (on CUDA tensors that
    wrapper launches the kernel); both methods give the same round."""
    from repro_torch.kernels.sort_keys import ops as SO

    calls = []
    real = SO.pack_and_histogram

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(SO, "pack_and_histogram", spy)
    fields, dest, count, _ = _case("count_below_c")
    q = queue_from_reference(fields, dest, count, np.zeros(R, np.int32), R, _tproto(), device="cpu")
    nq, total = forward_work(q, ForwardConfig(R, C, sort_method=sort_method))
    assert calls == [1]
    _assert_same((*queue_to_reference(nq)[:1], nq.count.numpy(), nq.drops.numpy(), int(total)),
                 _port_round("padded", 0, fields, dest, count))


def test_stage_hook_marks_every_step_and_leaves_the_round_unchanged():
    """``on_stage`` is called once after each step of the padded round, in
    order; the round's result is the same as without it.  Bit-equal."""
    fields, dest, count, _ = _case("sender_overflow", seed=3)
    q = queue_from_reference(fields, dest, count, np.zeros(R, np.int32), R, _tproto(), device="cpu")
    names = []
    nq, total = forward_work(q, ForwardConfig(R, C, peer_capacity=4), on_stage=names.append)
    assert names == ["plan", "pack", "SpillExtract", "Marshal", "CountExchange",
                     "PayloadExchange", "Unmarshal", "unpack", "psum"]
    _assert_same((*queue_to_reference(nq)[:1], nq.count.numpy(), nq.drops.numpy(), int(total)),
                 _port_round("padded", 4, fields, dest, count))
    names.clear()
    forward_work(q, ForwardConfig(R, C, exchange="onehot"), on_stage=names.append)
    assert names == ["plan", "pack", "exchange", "unpack", "psum"]


def test_exchange_counts_equals_reference(mesh8):
    """The count collective: rank b receives column b of the count matrix."""
    from repro.core import exchange as JX
    from repro_torch.core.exchange import exchange_counts

    counts = np.random.default_rng(2).integers(0, 50, (R, R)).astype(np.int32)
    f = jax.jit(compat.shard_map(lambda c: JX.exchange_counts(c.reshape(-1), "data")[None],
                                 mesh=mesh8, in_specs=P("data"), out_specs=P("data")))
    comm = StackedCollectives()
    got = exchange_counts(torch.from_numpy(counts), comm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(f(jnp.asarray(counts))))
    assert [(c.kind, c.shape) for c in comm.calls.elements()] == [("all_to_all", (R, R, 1))]


def test_clamp_subsegments_equals_reference():
    """Stacked sub-segment truncation to a slot budget: bit-equal."""
    from repro.core import stages as JST
    from repro_torch.core import stages as TST

    cnt = np.random.default_rng(4).integers(0, 9, (5, 3)).astype(np.int32)
    for slot in (1, 7, 40):
        ja, js = JST.clamp_subsegments(jnp.asarray(cnt), slot)
        ta, ts = TST.clamp_subsegments(torch.from_numpy(cnt), slot)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ----------------------------------------------------------- the drive loop
@j_work_item
@dataclasses.dataclass
class JHop:
    val: jax.Array   # (2,) f32
    hops: jax.Array  # () i32
    uid: jax.Array   # () i32


@work_item
@dataclasses.dataclass
class THop:
    val: torch.Tensor
    hops: torch.Tensor
    uid: torch.Tensor


HOP_C, HOP_N, HOP_S = 16, 12, 3


def _hop_inputs():
    rng = np.random.default_rng(9)
    return {
        "val": rng.normal(size=(R * HOP_N, 2)).astype(np.float32),
        "hops": rng.integers(1, 7, R * HOP_N).astype(np.int32),
        "uid": np.arange(R * HOP_N, dtype=np.int32) * 7,
        "dest": rng.integers(0, R, R * HOP_N).astype(np.int32),
    }


def _jax_drive(mesh8, inp, max_rounds):
    cfg = JForwardConfig("data", R, HOP_C, peer_capacity=HOP_S)
    jproto = JHop(val=jnp.zeros(2), hops=jnp.zeros((), jnp.int32), uid=jnp.zeros((), jnp.int32))

    def round_fn(q_in, acc, rnd):
        me = jax.lax.axis_index("data")
        valid = jnp.arange(HOP_C) < q_in.count
        it = q_in.items
        hops = it.hops - 1
        keep = valid & (hops > 0)
        dest = jnp.where(keep, (me + 1 + it.uid) % R, DISCARD).astype(jnp.int32)
        acc = acc + jnp.sum(jnp.where(valid & ~keep, it.uid, 0))
        out = JQ.enqueue(JQ.make_queue(jproto, HOP_C), JHop(it.val, hops, it.uid), dest, valid)
        return out, acc

    def drive(val, hops, uid, dest):
        q0 = JQ.enqueue(JQ.make_queue(jproto, HOP_C), JHop(val, hops, uid), dest,
                        jnp.ones(HOP_N, bool))
        q, acc, rounds, done = j_run_until_done(
            round_fn, q0, jnp.zeros((), jnp.int32), cfg, max_rounds=max_rounds
        )
        return (q.count[None], q.drops[None], rounds[None], done[None], acc[None],
                q.items.val, q.items.hops, q.items.uid)

    f = jax.jit(compat.shard_map(drive, mesh=mesh8, in_specs=(P("data"),) * 4,
                                 out_specs=(P("data"),) * 8))
    out = f(*(jnp.asarray(inp[k]) for k in ("val", "hops", "uid", "dest")))
    return [np.asarray(o) for o in out]


def _port_drive(inp, max_rounds):
    cfg = ForwardConfig(R, HOP_C, peer_capacity=HOP_S)
    tproto = THop(val=torch.zeros(2), hops=torch.zeros((), dtype=torch.int32),
                  uid=torch.zeros((), dtype=torch.int32))
    me = torch.arange(R, dtype=torch.int32)[:, None]
    lane = torch.arange(HOP_C)

    def round_fn(q_in, acc, rnd):
        valid = lane[None, :] < q_in.count[:, None]
        it = q_in.items
        hops = it.hops - 1
        keep = valid & (hops > 0)
        dest = torch.where(keep, (me + 1 + it.uid) % R, DISCARD).to(torch.int32)
        acc = acc + torch.where(valid & ~keep, it.uid, 0).sum(dim=1, dtype=torch.int32)
        out = enqueue(make_queue(tproto, HOP_C, num_ranks=R, device="cpu"),
                      THop(it.val, hops, it.uid), dest, valid)
        return out, acc

    st = lambda a: torch.from_numpy(a.reshape((R, HOP_N) + a.shape[1:]).copy())
    q0 = enqueue(make_queue(tproto, HOP_C, num_ranks=R, device="cpu"),
                 THop(st(inp["val"]), st(inp["hops"]), st(inp["uid"])), st(inp["dest"]),
                 torch.ones(R, HOP_N, dtype=torch.bool))
    comm = StackedCollectives()
    q, acc, rounds, done = run_until_done(
        round_fn, q0, torch.zeros(R, dtype=torch.int32), cfg, max_rounds=max_rounds, comm=comm
    )
    assert comm.count("all_to_all") == 2 * (rounds + 1)  # budget law, every round
    return q, acc, rounds, done


@pytest.mark.parametrize("max_rounds", [32, 2], ids=["terminates", "truncated"])
def test_run_until_done_equals_reference(mesh8, max_rounds):
    """Rounds, done, per-rank drops, retired-uid sums and the final queue
    (lanes < count): equal to the reference drive, bit for bit."""
    inp = _hop_inputs()
    jc, jd, jr, jdone, jacc, jval, jhops, juid = _jax_drive(mesh8, inp, max_rounds)
    q, acc, rounds, done = _port_drive(inp, max_rounds)
    assert rounds == int(jr[0]) and done == bool(jdone[0])
    assert done == (max_rounds == 32)
    np.testing.assert_array_equal(q.count.numpy(), jc)
    np.testing.assert_array_equal(q.drops.numpy(), jd)
    assert q.drops.sum() > 0  # the peer-slot clamp fired along the way
    np.testing.assert_array_equal(acc.numpy(), jacc)
    for r in range(R):
        n = int(jc[r])
        sl = slice(r * HOP_C, r * HOP_C + n)
        np.testing.assert_array_equal(q.items.val[r, :n].numpy().view(np.uint32),
                                      jval[sl].view(np.uint32))
        np.testing.assert_array_equal(q.items.hops[r, :n].numpy(), jhops[sl])
        np.testing.assert_array_equal(q.items.uid[r, :n].numpy(), juid[sl])


def test_forward_config_rejects_features_of_later_slices():
    # items 6 and 7 are ported: retain and the hierarchical route construct
    assert ForwardConfig(R, C, overflow="retain").overflow == "retain"
    assert ForwardConfig(R, C, exchange="hierarchical", fast_size=4).level_sizes == (2, 4)
    assert ForwardConfig(R, C, exchange="hierarchical", level_sizes=(2, 2, 2),
                         overflow="retain").level_capacities == (C, C, C)
    with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
        ForwardConfig(R, C, exchange="ragged")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        ForwardConfig(R, C, overflow="retain", flow="credit")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ForwardConfig(R, C, pipeline_shards=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        ForwardConfig(R, C, telemetry=True)
    with pytest.raises(ValueError, match="requires overflow='retain'"):
        ForwardConfig(R, C, flow="credit")
    with pytest.raises(ValueError, match="does not apply"):
        ForwardConfig(R, C, exchange="onehot", peer_capacity=4)
    assert ForwardConfig(R, C).peer_capacity == 16
