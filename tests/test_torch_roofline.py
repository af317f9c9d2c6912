"""The port's roofline models (``repro_torch.roofline.analysis``) against the
JAX package's, and the call recorder's wire bytes against the models.

* Every plain model the port copies gives the reference's dict or list
  exactly (``==``, floats included), over a grid of layouts, capacities,
  item sizes, rates, marshals and shard counts; the refusals raise the same
  ``ValueError``s.
* ``recorded_wire_bytes`` reads a real round's ``StackedCollectives.calls``:
  on flat, 2×4 and 2×2×2 rounds at 1 and 2 shards, both marshals, the
  payload bytes one rank puts on each tier equal ``padded_wire_rows`` times
  the wire row's bytes, and their off-group share equals
  ``tier_bytes_model`` — the HLO readers' budget guard, on the port.

Tolerance: none — the models are the same arithmetic, the bytes count data.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.roofline import analysis as JA
from repro_torch.core import (
    ForwardConfig,
    StackedCollectives,
    enqueue,
    forward_work,
    make_queue,
    pack_spec,
    work_item,
)
from repro_torch.core.collectives import Call
from repro_torch.roofline import analysis as A

LAYOUTS = [((8,), (16,)), ((8,), (1,)), ((2, 4), (8, 4)), ((4, 2), (3, 5)), ((2, 2, 2), (4, 6, 8)),
           ((1, 8), (7, 9)), ((8, 1), (5, 2)), ((2, 1, 4), (4, 4, 4))]
_LIDS = ["8", "8_s1", "2x4", "4x2", "2x2x2", "1x8", "8x1", "2x1x4"]


@pytest.mark.parametrize("item_bytes", [4, 44, 60])
@pytest.mark.parametrize("sizes,caps", LAYOUTS, ids=_LIDS)
def test_tier_bytes_and_padded_rows_equal_reference(sizes, caps, item_bytes):
    assert A.tier_bytes_model(sizes, caps, item_bytes) == JA.tier_bytes_model(sizes, caps, item_bytes)
    assert A.padded_wire_rows(sizes, caps) == JA.padded_wire_rows(sizes, caps)


@pytest.mark.parametrize("useful", [None, "half", "full"])
@pytest.mark.parametrize("rounds,num_ranks", [(1, 1), (4, 8)])
@pytest.mark.parametrize("sizes,caps", LAYOUTS, ids=_LIDS)
def test_occupancy_waste_equals_reference(sizes, caps, rounds, num_ranks, useful):
    rows = JA.padded_wire_rows(sizes, caps)
    useful_rows = None if useful is None else [r * rounds * num_ranks // (2 if useful == "half" else 1) for r in rows]
    kw = dict(useful_rows=useful_rows, rounds=rounds, num_ranks=num_ranks)
    assert A.occupancy_waste_model(sizes, caps, 44, **kw) == JA.occupancy_waste_model(sizes, caps, 44, **kw)


@pytest.mark.parametrize("exchange", ["padded", "flat", "hierarchical", "ragged"])
@pytest.mark.parametrize("num_ranks,fast_size", [(8, 4), (8, 2), (16, 4), (8, 8)])
def test_slow_axis_bytes_equals_reference(exchange, num_ranks, fast_size):
    kw = dict(num_ranks=num_ranks, fast_size=fast_size, item_bytes=44, peer_capacity=12, node_capacity=20,
              n_items=1000)
    assert A.slow_axis_bytes_model(exchange, **kw) == JA.slow_axis_bytes_model(exchange, **kw)


@pytest.mark.parametrize("backlog,allowance", [(0, 1), (1, 1), (7, 2), (246311, 8192), (100, 100), (101, 100)])
def test_spill_drain_equals_reference(backlog, allowance):
    assert A.spill_drain_model(backlog, allowance) == JA.spill_drain_model(backlog, allowance)


@pytest.mark.parametrize("offered,drain,rounds,item_bytes", [
    (10, 4, 1, 1), (4, 10, 3, 44), (0, 1, 5, 4), (1152, 256, 15, 12), (7, 7, 2, 60),
])
def test_goodput_equals_reference(offered, drain, rounds, item_bytes):
    kw = dict(rounds=rounds, item_bytes=item_bytes)
    assert A.goodput_model(offered, drain, **kw) == JA.goodput_model(offered, drain, **kw)


@pytest.mark.parametrize("marshal", ["sort", "scatter"])
@pytest.mark.parametrize("capacity,send_rows,num_ranks", [(1, 8, 8), (64, 128, 8), (262144, 524288, 8), (1000, 7, 3)])
def test_marshal_cost_equals_reference(marshal, capacity, send_rows, num_ranks):
    kw = dict(capacity=capacity, item_bytes=44, send_rows=send_rows, num_ranks=num_ranks)
    assert A.marshal_cost_model(marshal, **kw) == JA.marshal_cost_model(marshal, **kw)


_SPLITS = [
    {"marshal": 10.0, "count_collective": 2.0, "payload_collective": 30.0, "unmarshal": 5.0},
    {"marshal": 40.0, "count_collective": 1.0, "payload_collective": 3.0, "unmarshal": 20.0},
    {"marshal": 0.0, "count_collective": 0.0, "payload_collective": 0.0, "unmarshal": 0.0},
]


@pytest.mark.parametrize("async_fraction", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("split", range(len(_SPLITS)))
def test_overlap_efficiency_equals_reference(split, shards, async_fraction):
    kw = dict(async_fraction=async_fraction)
    want = JA.overlap_efficiency_model(_SPLITS[split], shards, **kw)
    assert A.overlap_efficiency_model(_SPLITS[split], shards, **kw) == want


@pytest.mark.parametrize("call", [
    lambda m: m.spill_drain_model(5, 0),
    lambda m: m.goodput_model(5, 0),
    lambda m: m.marshal_cost_model("bogus", capacity=8, item_bytes=4, send_rows=8),
    lambda m: m.overlap_efficiency_model({}, 0),
    lambda m: m.overlap_efficiency_model({}, 2, async_fraction=1.5),
    lambda m: m.slow_axis_bytes_model("onehot", num_ranks=8, fast_size=4, item_bytes=4),
], ids=["drain0", "goodput0", "marshal", "shards0", "async", "exchange"])
def test_refusals_equal_reference(call):
    with pytest.raises(ValueError) as want:
        call(JA)
    with pytest.raises(ValueError) as got:
        call(A)
    assert str(got.value) == str(want.value)


# ------------------------------------------- the recorder against the models
@work_item
@dataclasses.dataclass
class Ray44:
    origin: torch.Tensor
    dir: torch.Tensor
    t: torch.Tensor
    pixel: torch.Tensor
    slab: torch.Tensor
    w: torch.Tensor


R, CAP = 8, 64
_PROTO = Ray44(torch.zeros(3), torch.zeros(3), torch.zeros(()), torch.zeros((), dtype=torch.int32),
               torch.zeros((), dtype=torch.int32), torch.zeros(2))


def _round_calls(cfg, seed=3):
    rng = np.random.default_rng(seed)
    n = 40
    items = Ray44(*(torch.from_numpy(rng.standard_normal((R, n) + tuple(a.shape)).astype(np.float32))
                    if a.is_floating_point() else torch.from_numpy(rng.integers(0, 99, (R, n)).astype(np.int32))
                    for a in (_PROTO.origin, _PROTO.dir, _PROTO.t, _PROTO.pixel, _PROTO.slab, _PROTO.w)))
    dest = torch.from_numpy(rng.integers(-1, R, (R, n)).astype(np.int32))
    q = enqueue(make_queue(_PROTO, CAP, num_ranks=R, device="cpu"), items, dest, torch.ones(R, n, dtype=torch.bool))
    comm = StackedCollectives()
    forward_work(q, cfg, comm=comm)
    return comm.calls


_ROUNDS = [
    ("flat", dict(peer_capacity=16), (8,), (16,)),
    ("2x4", dict(exchange="hierarchical", level_sizes=(2, 4), level_capacities=(24, 16)), (2, 4), (24, 16)),
    ("2x2x2", dict(exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(16, 24, 32)), (2, 2, 2),
     (16, 24, 32)),
]


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
@pytest.mark.parametrize("name,kw,sizes,caps", _ROUNDS, ids=[r[0] for r in _ROUNDS])
def test_recorded_wire_bytes_equal_the_models(name, kw, sizes, caps, marshal, shards):
    """Payload calls only (``min_bytes`` above a count call's share): one
    rank's bytes a tier are the padded rows times the 44-byte wire row, and
    the ``A - 1`` segments that leave the rank are ``tier_bytes_model``."""
    cfg = ForwardConfig(R, CAP, marshal=marshal, pipeline_shards=shards, **kw)
    row_bytes = pack_spec(_PROTO).total_words * 4
    assert row_bytes == 44
    calls = _round_calls(cfg)
    count_share = 4 * max(sizes) * R  # a count call's share is at most R int32 per peer
    got = A.recorded_wire_bytes(calls, sizes, min_bytes=count_share + 1)
    assert got == [r * row_bytes for r in JA.padded_wire_rows(sizes, caps)]
    crossing = [b * (a - 1) / a for b, a in zip(got, sizes)]
    assert crossing == JA.tier_bytes_model(sizes, caps, row_bytes)
    # with every call counted, the count calls add one int32 per peer and
    # shard at the last stage (the slowest non-trivial tier), one per
    # sub-segment (R a rank) at the stages before it
    last = min(l for l, a in enumerate(sizes) if a > 1)
    total = A.recorded_wire_bytes(calls, sizes)
    want = [4 * shards * (a if l == last else R) if a > 1 else 0 for l, a in enumerate(sizes)]
    assert [t - g for t, g in zip(total, got)] == want
    assert sum(n for c, n in calls.items() if c.kind == "all_to_all") == 2 * shards * sum(a > 1 for a in sizes)


def test_recorded_wire_bytes_refuses_a_flat_call_on_tiers():
    calls = _round_calls(ForwardConfig(R, CAP, peer_capacity=16))
    with pytest.raises(ValueError, match="flat all_to_all call"):
        A.recorded_wire_bytes(calls, (2, 4))
    assert A.recorded_wire_bytes(calls, (8,)) == [R * 16 * 44 + R * 4]  # payload and count: psum not counted


# ------------------------------------------------------------ the step count
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _bytes(fn):
    return A.count_step(fn).bytes_accessed


def test_bytes_accessed_of_hand_reckoned_ops():
    """Each operand read once, each result written once, a view or alias
    nothing; an in-place op reads and writes its argument, ``copy_`` only
    writes it, an indexed write writes its source's bytes, a gather reads
    the rows it returns; a broadcast operand (stride 0) reads its distinct
    elements."""
    a, b = _meta(64, 32), _meta(32, 16)
    assert _bytes(lambda: a @ b) == (64 * 32 + 32 * 16 + 64 * 16) * 4
    x, y = _meta(1000), _meta(1000, dtype=torch.bfloat16)
    assert _bytes(lambda: x * 2.0) == 2 * 4000
    assert _bytes(lambda: x + y) == 4000 + 2000 + 4000
    assert _bytes(lambda: (x.view(10, 100), x.t(), x.detach(), x.reshape(50, 20), x[3:7], x.unsqueeze(0))) == 0
    assert _bytes(lambda: x.add_(1.0)) == 2 * 4000
    assert _bytes(lambda: x.copy_(y)) == 2000 + 4000
    bias = _meta(16)
    assert _bytes(lambda: _meta(8, 16) + bias.expand(8, 16)) == (128 + 16 + 128) * 4
    idx, vals = torch.empty(10, dtype=torch.int64, device="meta"), _meta(10, 32)
    assert _bytes(lambda: a.index_put_((idx,), vals)) == 80 + 1280 + 1280
    assert _bytes(lambda: torch.empty(1 << 20, device="meta")) == 0
    table, rows = _meta(1000, 64, dtype=torch.bfloat16), torch.empty(8, dtype=torch.int64, device="meta")
    assert _bytes(lambda: table[rows]) == 8 * 128 + 64 + 8 * 128  # the rows gathered, not the table


def test_peak_of_a_hand_sequence_of_allocations_and_frees():
    """Bytes alive: the held inputs from the start, each new storage from
    the op that makes it, freed when its last tensor goes (a view keeps
    it); the weighted peak takes each storage at its weight."""
    held = _meta(2000)

    def run():
        a = torch.empty(1000, device="meta")  # 4000
        b = torch.empty(500, device="meta")  # 6000
        del a  # 2000
        c = torch.empty(3000, device="meta")  # 14000
        d = c[:10]
        del c  # the view keeps the storage: 14000
        e = torch.empty(100, device="meta")  # 14400
        del d  # 2400
        f = torch.empty(2500, device="meta")  # 12400
        return b, e, f

    r = A.count_step(run, held=[([held], 0.5)], default_weight=0.25)
    assert r.peak_bytes == 8000 + 14400
    assert r.peak_weighted == 8000 * 0.5 + 14400 * 0.25
    assert r.ops == 6 and r.bytes_accessed == 0  # five allocations and a slice


def test_a_train_step_counts_alike_on_the_cpu_and_on_meta():
    """The smoke config's train step, from real CPU tensors and from meta
    ones: the same FLOPs, bytes accessed and peaks (the counter reads
    shapes, dtypes and lifetimes, which the device does not change)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    model = build_model(get_smoke_config("qwen2-7b"))
    step = build_train_step(model)
    out = []
    for lm in (model.init(torch.Generator().manual_seed(0), device="cpu"), model.abstract()):
        opt = adamw_init(lm, AdamWConfig())
        tokens = torch.zeros((2, 16), dtype=torch.int32, device=lm.tree()["embed"].device)
        held = list(lm.parameters()) + _leaves(opt) + [tokens]
        r = A.count_step(lambda: step(lm, opt, {"tokens": tokens}), held=[(held, 1.0)],
                         grads=[(p, 0.5) for p in lm.parameters()])
        out.append((r.flops, r.bytes_accessed, r.peak_bytes, r.peak_weighted))
    assert out[0] == out[1] and out[0][0] > 0 and out[0][2] > out[0][3] > 0


def _leaves(tree):
    return [t for v in tree.values() for t in (_leaves(v) if isinstance(v, dict) else [v])]


def test_collective_inventory_reads_a_device_result():
    """A device's result of each recorded call: its row of a stacked
    ``all_to_all``, ``psum`` or ``ppermute``, every row of a flat
    ``all_gather``, its tier group's rows of a tier ``all_gather``, one
    process's ``grad_all_reduce`` bucket whole; named as the HLO names
    them."""
    comm = StackedCollectives()
    comm.all_to_all(torch.zeros(8, 8, 3, dtype=torch.int32))
    comm.all_gather(torch.zeros(8, 5))
    comm.all_gather(torch.zeros(8, 5), digits=(2, 4), tier=1)
    comm.psum(torch.zeros(8, 2))
    comm.ppermute(torch.zeros(8, 6))
    comm.calls[Call("grad_all_reduce", 4000, (1000,))] += 2
    inv = A.collective_inventory(comm.calls, (2, 4))
    assert sorted(inv) == sorted([
        ("all-to-all", (8, 3), 96, 1), ("all-gather", (8, 5), 160, 1), ("all-gather", (4, 5), 80, 1),
        ("all-reduce", (2,), 8, 1), ("collective-permute", (6,), 24, 1), ("all-reduce", (1000,), 8000, 2)])
    assert A.collective_bytes(comm.calls, (2, 4)) == {
        "all-gather": 240, "all-reduce": 8008, "reduce-scatter": 0, "all-to-all": 96, "collective-permute": 24,
        "ragged-all-to-all": 0}
    with pytest.raises(ValueError, match="level_sizes"):
        A.collective_inventory(comm.calls)
