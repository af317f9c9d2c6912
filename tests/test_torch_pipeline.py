"""The port's micro-shard pipelining (``pipeline_shards=S``) against the
JAX reference and the port's own bulk round.

* The cases of ``tests/test_pipeline.py``: flat padded S ∈ {2, 4} × both
  marshals × both overflow modes under uniform and hot-spot traffic, and the
  2- and 3-level hierarchical route at S=2 with uneven tier capacities
  (mid-route parking under retain).  Each pipelined round equals the port's
  S=1 round on every lane and the JAX pipelined round on lanes ``< count``
  (counts, drops, totals, destinations, item bits and ages), and makes S
  payload and S count ``all_to_all`` calls per non-trivial tier.
* Random fills (the reference's property test, seeds from numpy), the
  stats of a pipelined round, and a pipelined drive with its ring: equal to
  the bulk ones.
* The validation errors, raised by the port and the reference on the same
  configurations (``pipeline_shards`` must divide ``peer_capacity``
  included), and the stage hook's per-shard names.

Tolerance: none — everything here moves or counts data.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ForwardConfig as JForwardConfig
from repro_torch.core import (
    DISCARD,
    ForwardConfig,
    StackedCollectives,
    WorkQueue,
    forward_work,
    run_until_done,
    work_item,
)
from repro_torch.core import types as T

from test_torch_retain import CAP, R, assert_same_round, jax_round, pattern_dest, port_round
from test_torch_telemetry import _hop_round_fn_port, _hop_seed_port

AXES2, AXES3 = ("node", "device"), ("pod", "node", "device")
HIER = [("mesh_nodes24", AXES2, (2, 4), (6, 8)), ("mesh_pods222", AXES3, (2, 2, 2), (4, 6, 8))]


def _same_every_lane(got, want):
    """Two port rounds (``port_round`` dicts) equal on every lane."""
    for k in ("count", "drops", "dest") + (("age",) if "age" in want else ()):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["total"] == want["total"]
    for k in want["fields"]:
        np.testing.assert_array_equal(got["fields"][k].view(np.uint32), want["fields"][k].view(np.uint32), err_msg=k)


def _tier_calls(comm):
    """``{tier: (payload calls, count calls)}`` of the recorder's
    ``all_to_all`` calls (payload calls carry a word axis)."""
    out = {}
    for c, n in comm.calls.items():
        if c.kind != "all_to_all":
            continue
        pay, cnt = out.get(c.tier, (0, 0))
        out[c.tier] = (pay + n, cnt) if len(c.shape) == 4 else (pay, cnt + n)
    return out


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("overflow", ["drop", "retain"])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
@pytest.mark.parametrize("traffic", [("uniform", 0), ("hotspot", 3)], ids=["uniform0", "hotspot3"])
def test_flat_padded_pipelined_round_equals_bulk_and_reference(mesh8, traffic, marshal, overflow, S):
    kw = dict(exchange="padded", marshal=marshal, overflow=overflow)
    inp, want = jax_round(mesh8, JForwardConfig("data", R, CAP, pipeline_shards=S, **kw), pattern_dest(*traffic))
    bulk = port_round(ForwardConfig(R, CAP, **kw), inp)
    comm = StackedCollectives()
    got = port_round(ForwardConfig(R, CAP, pipeline_shards=S, **kw), inp, comm=comm)
    _same_every_lane(got, bulk)
    assert_same_round(got, want)
    assert _tier_calls(comm) == {None: (S, S)} and comm.count("psum") == 1
    if traffic[0] == "hotspot":
        assert got["drops"].sum() > 0  # the receiver clamp fired


@pytest.mark.parametrize("overflow", ["drop", "retain"])
@pytest.mark.parametrize("marshal", ["sort", "scatter"])
@pytest.mark.parametrize("fixture,axes,sizes,caps", HIER, ids=["2level", "3level"])
def test_hierarchical_pipelined_round_equals_bulk_and_reference(request, fixture, axes, sizes, caps, marshal,
                                                                overflow):
    """Per-tier micro-shards (chunk = tier slot / 2) reassemble every stage
    buffer exactly: the multi-hop placement, mid-route parking included,
    equals the bulk round; S payload and S count calls per tier."""
    mesh = request.getfixturevalue(fixture)
    kw = dict(exchange="hierarchical", level_sizes=sizes, level_capacities=caps, marshal=marshal, overflow=overflow)
    inp, want = jax_round(mesh, JForwardConfig(axes, R, CAP, pipeline_shards=2, **kw), pattern_dest("hotspot", 3))
    bulk = port_round(ForwardConfig(R, CAP, **kw), inp)
    comm = StackedCollectives()
    got = port_round(ForwardConfig(R, CAP, pipeline_shards=2, **kw), inp, comm=comm)
    _same_every_lane(got, bulk)
    assert_same_round(got, want)
    assert _tier_calls(comm) == {l: (2, 2) for l in range(len(sizes))}


@work_item
@dataclasses.dataclass
class Probe:
    val: torch.Tensor
    src: torch.Tensor


def _random_queue(seed):
    """``test_pipeline.test_pipelined_placement_property``'s fills: random
    counts and destinations, a coin-flip hot spot on some ranks."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, CAP + 1, R).astype(np.int32)
    dest = np.full((R, CAP), DISCARD, np.int32)
    for r in range(R):
        if rng.random() < 0.3:
            dest[r, : counts[r]] = rng.integers(0, R)
        else:
            dest[r, : counts[r]] = rng.integers(0, R, counts[r])
    val = rng.standard_normal((R, CAP)).astype(np.float32)
    src = np.repeat(np.arange(R, dtype=np.int32)[:, None], CAP, axis=1)
    t = torch.from_numpy
    return WorkQueue(items=Probe(val=t(val), src=t(src)), dest=t(dest), count=t(counts),
                     drops=torch.zeros(R, dtype=torch.int32))


def _same_queue(a, b):
    pa, _ = T.pack_payload(a.items, batch_dims=2)
    pb, _ = T.pack_payload(b.items, batch_dims=2)
    return (torch.equal(pa, pb) and torch.equal(a.dest, b.dest) and torch.equal(a.count, b.count)
            and torch.equal(a.drops, b.drops))


@pytest.mark.parametrize("seed", range(12))
def test_pipelined_placement_on_random_fills(seed):
    q = _random_queue(seed)
    for base in (ForwardConfig(R, CAP), ForwardConfig(R, CAP, peer_capacity=8, marshal="scatter", overflow="retain"),
                 ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(2, 4), level_capacities=(16, 8))):
        ref = forward_work(q, base)
        for S in (2, 4):
            got = forward_work(q, dataclasses.replace(base, pipeline_shards=S))
            assert _same_queue(got[0], ref[0]) and int(got[1]) == int(ref[1])
            if base.overflow == "retain":
                assert torch.equal(got[2], ref[2])


@pytest.mark.parametrize("kw", [
    dict(peer_capacity=8, overflow="retain"),
    dict(exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(4, 6, 8)),
], ids=["flat-retain", "hier3"])
def test_pipelined_round_records_the_bulk_stats(kw):
    q = _random_queue(7)
    ref = forward_work(q, ForwardConfig(R, CAP, telemetry=True, **kw))
    got = forward_work(q, ForwardConfig(R, CAP, telemetry=True, pipeline_shards=2, **kw))
    for f in dataclasses.fields(ref[-1]):
        assert torch.equal(getattr(got[-1], f.name), getattr(ref[-1], f.name)), f.name


def test_pipelined_drive_equals_bulk_drive():
    """A 5-hop drive with the ring (the reference quickstart's section 5):
    the same queue, rounds and ring at S=2 as at S=1, and twice the
    collective calls of the bulk drive."""
    outs, calls = {}, {}
    for S in (1, 2):
        comm = StackedCollectives()
        cfg = ForwardConfig(R, CAP, telemetry=True, telemetry_window=8, pipeline_shards=S)
        outs[S] = run_until_done(_hop_round_fn_port, _hop_seed_port(), torch.zeros(R), cfg, max_rounds=16, comm=comm)
        calls[S] = comm.count("all_to_all")
    (q1, _a1, r1, d1, ring1), (q2, _a2, r2, d2, ring2) = outs[1], outs[2]
    assert (r1, d1) == (r2, d2) == (5, True) and _same_queue(q1, q2)
    for f in dataclasses.fields(ring1.stats):
        assert torch.equal(getattr(ring1.stats, f.name), getattr(ring2.stats, f.name)), f.name
    assert calls[2] == 2 * calls[1] == 2 * 2 * (r1 + 1)


def test_stage_hook_names_every_shard():
    q = _random_queue(3)
    names = []
    forward_work(q, ForwardConfig(R, CAP, pipeline_shards=2), on_stage=names.append)
    chain = ["Marshal", "CountExchange", "PayloadExchange", "Unmarshal"]
    assert names == ["plan", "pack", "SpillExtract"] + [f"{s}#{k}" for k in range(2) for s in chain] + \
        ["unpack", "psum"]
    names.clear()
    forward_work(q, ForwardConfig(R, CAP, exchange="hierarchical", level_sizes=(2, 4), pipeline_shards=2),
                 on_stage=names.append)
    tier = lambda l, final: [f"SpillExtract@{l}"] + [
        f"{s}#{k}@{l}" for k in range(2) for s in chain[:3] + (["Unmarshal"] if final else [])
    ] + ([] if final else [f"Reassemble@{l}", f"AdvanceTier@{l}"])
    assert names == ["plan", "pack"] + tier(1, False) + tier(0, True) + ["unpack", "psum"]


# ------------------------------------------------------------- validation
_INVALID = [
    (dict(pipeline_shards=0), "pipeline_shards"),
    (dict(pipeline_shards=3), "divide"),  # 3 does not divide 64
    (dict(peer_capacity=6, pipeline_shards=4), "peer_capacity"),
    (dict(peer_capacity=12, pipeline_shards=8), "peer_capacity"),
    (dict(exchange="hierarchical", level_sizes=(2, 4), level_capacities=(7, 8), pipeline_shards=2),
     "level_capacities"),
    (dict(exchange="onehot", pipeline_shards=2), "onehot"),
]


@pytest.mark.parametrize("kw,match", _INVALID, ids=lambda v: str(v) if isinstance(v, str) else None)
def test_invalid_pipelining_raises_like_the_reference(kw, match):
    axes = AXES2 if kw.get("exchange") == "hierarchical" else "data"
    with pytest.raises(ValueError, match=match):
        JForwardConfig(axes, R, CAP, **kw)
    with pytest.raises(ValueError, match=match):
        ForwardConfig(R, CAP, **kw)


def test_valid_pipelining_constructs_like_the_reference():
    for kw in (dict(peer_capacity=8, pipeline_shards=4), dict(pipeline_shards=16),
               dict(exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(4, 6, 8), pipeline_shards=2)):
        axes = AXES3 if kw.get("exchange") == "hierarchical" else "data"
        j, t = JForwardConfig(axes, R, CAP, **kw), ForwardConfig(R, CAP, **kw)
        assert (t.peer_capacity, t.level_capacities, t.pipeline_shards) == (
            j.peer_capacity, j.level_capacities, j.pipeline_shards)


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
def test_cuda_fig8_pipelined_round_equals_cpu(cuda_device, marshal):
    """A pipelined round of the Fig-8 shape (R=8, C=262,144, 11 words,
    S=65,536 in 4 shards) on the card: equal on every lane to the same
    round on the CPU and to the card's S=1 round."""
    C, S = 262144, 65536
    gen = torch.Generator().manual_seed(19)
    words = torch.randint(-(2**31), 2**31 - 1, (R, C, 11), generator=gen, dtype=torch.int32)
    dest = torch.randint(-1, R, (R, C), generator=gen, dtype=torch.int32)
    mk = lambda dev: WorkQueue(items=Words(w=words.to(dev)), dest=dest.to(dev),
                               count=torch.full((R,), C, dtype=torch.int32, device=dev),
                               drops=torch.zeros(R, dtype=torch.int32, device=dev))
    cfg = ForwardConfig(R, C, peer_capacity=S, marshal=marshal, pipeline_shards=4)
    nq, total = forward_work(mk(cuda_device), cfg)
    cq, ctotal = forward_work(mk("cpu"), cfg)
    bq, btotal = forward_work(mk(cuda_device), dataclasses.replace(cfg, pipeline_shards=1))
    assert int(total) == int(ctotal) == int(btotal)
    for other in (cq, bq):
        assert torch.equal(nq.items.w.cpu(), other.items.w.cpu())
        assert torch.equal(nq.count.cpu(), other.count.cpu()) and torch.equal(nq.drops.cpu(), other.drops.cpu())
