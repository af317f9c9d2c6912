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
