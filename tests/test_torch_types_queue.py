"""The PyTorch port's wire format and queues against the JAX reference.

Inputs are made from a seed with numpy and fed to both packages.  Packed
words, queue placement, counts and drops are data movement: they must be
equal bit for bit (tolerance: none).  Also the port's import law (no JAX,
nothing of ``repro``) and its device rule (no silent CPU fallback).
"""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queue as JQ
from repro.core import types as JT
from repro_torch import compat as tcompat
from repro_torch.core import queue as TQ
from repro_torch.core import types as TT

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ------------------------------------------------ twin item types (same fields)
@JT.work_item
@dataclasses.dataclass
class JParticle:
    uid: jax.Array
    pos: jax.Array
    steps: jax.Array


@TT.work_item
@dataclasses.dataclass
class TParticle:
    uid: torch.Tensor
    pos: torch.Tensor
    steps: torch.Tensor


@JT.work_item
@dataclasses.dataclass
class JRay44:
    origin: jax.Array
    direction: jax.Array
    tmin: jax.Array
    pixel: jax.Array
    integral: jax.Array
    extra: jax.Array


@TT.work_item
@dataclasses.dataclass
class TRay44:
    origin: torch.Tensor
    direction: torch.Tensor
    tmin: torch.Tensor
    pixel: torch.Tensor
    integral: torch.Tensor
    extra: torch.Tensor


@JT.work_item
@dataclasses.dataclass
class JSmall:
    flag: jax.Array  # () bool
    code: jax.Array  # (3,) uint8
    half: jax.Array  # (5,) f16
    x: jax.Array     # (2,) f32


@TT.work_item
@dataclasses.dataclass
class TSmall:
    flag: torch.Tensor
    code: torch.Tensor
    half: torch.Tensor
    x: torch.Tensor


def _fields(rng, kind, n):
    """numpy leaves for ``n`` items of ``kind`` (field name → array)."""
    f32 = lambda *s: rng.normal(size=(n,) + s).astype(np.float32)
    i32 = lambda *s: rng.integers(-(2**31), 2**31 - 1, (n,) + s, dtype=np.int32)
    if kind == "particle":
        return {"uid": i32(), "pos": f32(3), "steps": i32()}
    if kind == "ray44":
        d = {"origin": f32(3), "direction": f32(3), "tmin": f32(), "pixel": i32(),
             "integral": f32(), "extra": f32(2)}
        special = np.array([np.nan, -0.0, np.inf, 1e-45], np.float32)  # bits, not values
        d["tmin"][: min(n, 4)] = special[: min(n, 4)]
        return d
    return {
        "flag": rng.random(n) < 0.5,
        "code": rng.integers(0, 256, (n, 3), dtype=np.uint8),
        "half": rng.normal(size=(n, 5)).astype(np.float16),
        "x": f32(2),
    }


_TYPES = {"particle": (JParticle, TParticle), "ray44": (JRay44, TRay44), "small": (JSmall, TSmall)}


def _both(kind, fields):
    jcls, tcls = _TYPES[kind]
    j = jcls(**{k: jnp.asarray(v) for k, v in fields.items()})
    t = tcls(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fields.items()})
    return j, t


@pytest.mark.parametrize("kind", ["particle", "ray44", "small"])
def test_pack_payload_words_equal_reference_bit_for_bit(kind):
    """Tolerance: none — the port's int32 words carry the reference's uint32 bits."""
    rng = np.random.default_rng(11)
    fields = _fields(rng, kind, 37)
    j, t = _both(kind, fields)
    jp, jspec = JT.pack_payload(j)
    tp, tspec = TT.pack_payload(t)
    assert tp.dtype == torch.int32 and tspec.words == jspec.words
    np.testing.assert_array_equal(tp.numpy().view(np.uint32), np.asarray(jp))
    back = TT.unpack_payload(tp, tspec)
    for k, v in fields.items():
        got = getattr(back, k).numpy()
        assert got.dtype == v.dtype
        np.testing.assert_array_equal(got.view(np.uint8), v.view(np.uint8))


@pytest.mark.parametrize("kind", ["particle", "ray44", "small"])
def test_pack_payload_rank_stacked_equals_flat(kind):
    """A (R, C, ...) stacked pack is the (R·C, ...) reference pack, reshaped."""
    rng = np.random.default_rng(12)
    R, C = 4, 9
    fields = _fields(rng, kind, R * C)
    j, _ = _both(kind, fields)
    stacked = {k: v.reshape((R, C) + v.shape[1:]) for k, v in fields.items()}
    t = _TYPES[kind][1](**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in stacked.items()})
    tp, spec = TT.pack_payload(t, batch_dims=2)
    jp, _ = JT.pack_payload(j)
    np.testing.assert_array_equal(tp.numpy().view(np.uint32).reshape(R * C, -1), np.asarray(jp))
    back = TT.unpack_payload(tp, spec)
    for k, v in stacked.items():
        np.testing.assert_array_equal(getattr(back, k).numpy().view(np.uint8), v.view(np.uint8))


def test_pack_spec_matches_item_nbytes():
    proto = TRay44(origin=torch.zeros(3), direction=torch.zeros(3), tmin=torch.zeros(()),
                   pixel=torch.zeros((), dtype=torch.int32), integral=torch.zeros(()),
                   extra=torch.zeros(2))
    spec = TT.pack_spec(proto)
    assert spec.total_words * 4 == TT.item_nbytes(proto) == 44
    assert spec.offsets == (0, 3, 6, 7, 8, 9)


# ----------------------------------------------------------------- enqueue
def _jray_proto():
    return JRay44(origin=jnp.zeros(3), direction=jnp.zeros(3), tmin=jnp.zeros(()),
                  pixel=jnp.zeros((), jnp.int32), integral=jnp.zeros(()), extra=jnp.zeros(2))


def _tray_proto():
    return TRay44(origin=torch.zeros(3), direction=torch.zeros(3), tmin=torch.zeros(()),
                  pixel=torch.zeros((), dtype=torch.int32), integral=torch.zeros(()),
                  extra=torch.zeros(2))


def _enqueue_both(cap, batches, num_ranks=None):
    """Apply the same enqueue sequence to a JAX queue and a port queue (R=1).
    ``batches``: list of (fields, dest, mask) numpy triples."""
    jq = JQ.make_queue(_jray_proto(), cap)
    tq = TQ.make_queue(_tray_proto(), cap, device="cpu")
    for fields, dest, mask in batches:
        j, t = _both("ray44", fields)
        jq = JQ.enqueue(jq, j, jnp.asarray(dest), jnp.asarray(mask), num_ranks=num_ranks)
        t1 = TT.tree_map(lambda a: a[None], t)
        tq = TQ.enqueue(tq, t1, torch.from_numpy(dest)[None], torch.from_numpy(mask)[None],
                        num_ranks=num_ranks)
    return jq, tq


def _assert_same_queue(jq, tq):
    """Tolerance: none.  Every lane is compared (both queues start zeroed)."""
    assert int(jq.count) == int(tq.count[0])
    assert int(jq.drops) == int(tq.drops[0])
    np.testing.assert_array_equal(np.asarray(jq.dest), tq.dest[0].numpy())
    for f in dataclasses.fields(TRay44):
        a = np.asarray(getattr(jq.items, f.name))
        b = getattr(tq.items, f.name)[0].numpy()
        np.testing.assert_array_equal(b.view(np.uint32), a.view(np.uint32))


_CASES = {
    # (capacity, [(n, dest, mask), ...]) — the cases of tests/test_core_queue.py
    "lane_order": (16, [(4, [3, 1, 2, 0], [1, 1, 1, 1])]),
    "masked_stable": (16, [(6, [0, 1, 2, 3, 4, 5], [1, 0, 1, 0, 1, 0])]),
    "accumulate": (16, [(3, [0, 0, 0], [1, 1, 1]), (3, [1, 1, 1], [1, 1, 1])]),
    "overflow_drops": (4, [(6, [0] * 6, [1] * 6)]),
    "negative_dest": (16, [(4, [0, -1, 1, -1], [1, 1, 1, 1])]),
    "int_mask_2": (3, [(6, [0, 1, -1, 2, 3, 4], [2, 0, 2, 2, 0, 2])]),
    "int_mask_2_overflow": (3, [(6, [0] * 6, [2, 2, 0, 2, 0, 2])]),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_enqueue_equals_reference(case):
    cap, spec = _CASES[case]
    rng = np.random.default_rng(5)
    batches = []
    for n, dest, mask in spec:
        m = np.asarray(mask, np.int32)
        if case in ("lane_order", "masked_stable", "accumulate", "overflow_drops", "negative_dest"):
            m = m.astype(bool)
        batches.append((_fields(rng, "ray44", n), np.asarray(dest, np.int32), m))
    jq, tq = _enqueue_both(cap, batches)
    _assert_same_queue(jq, tq)


def test_enqueue_rank_stacked_equals_per_rank_reference():
    """R=4 ranks in one stacked enqueue == four reference enqueues."""
    rng = np.random.default_rng(6)
    R, n, cap = 4, 12, 8
    fields = _fields(rng, "ray44", R * n)
    dest = rng.integers(-1, 5, R * n).astype(np.int32)
    mask = (rng.random(R * n) < 0.7).astype(np.int32) * 3
    tq = TQ.make_queue(_tray_proto(), cap, num_ranks=R, device="cpu")
    t = TRay44(**{k: torch.from_numpy(v.reshape((R, n) + v.shape[1:]).copy()) for k, v in fields.items()})
    tq = TQ.enqueue(tq, t, torch.from_numpy(dest.reshape(R, n)), torch.from_numpy(mask.reshape(R, n)))
    for r in range(R):
        sl = slice(r * n, (r + 1) * n)
        jq, _ = _enqueue_both(cap, [({k: v[sl] for k, v in fields.items()}, dest[sl], mask[sl])])
        one = TQ.WorkQueue(TT.tree_map(lambda a: a[r:r + 1], tq.items), tq.dest[r:r + 1],
                           tq.count[r:r + 1], tq.drops[r:r + 1])
        _assert_same_queue(jq, one)


def test_enqueue_float_dest_raises_like_reference():
    fields = _fields(np.random.default_rng(0), "ray44", 4)
    dest = np.array([0.0, 1.0, 2.0, 3.0], np.float32)
    mask = np.ones(4, bool)
    with pytest.raises(ValueError, match="integer dtype"):
        _enqueue_both(16, [(fields, dest, mask)])
    t = TRay44(**{k: torch.from_numpy(v)[None] for k, v in fields.items()})
    with pytest.raises(ValueError, match="integer dtype"):
        TQ.enqueue(TQ.make_queue(_tray_proto(), 16, device="cpu"), t,
                   torch.from_numpy(dest)[None], torch.from_numpy(mask)[None])


def test_enqueue_num_ranks_raises_like_reference():
    fields = _fields(np.random.default_rng(1), "ray44", 4)
    t = TRay44(**{k: torch.from_numpy(v)[None] for k, v in fields.items()})
    q = TQ.make_queue(_tray_proto(), 16, device="cpu")
    with pytest.raises(ValueError, match=r"num_ranks \(8\).*offending value 12"):
        TQ.enqueue(q, t, torch.tensor([[0, 9, 2, 12]], dtype=torch.int32),
                   torch.ones(1, 4, dtype=torch.bool), num_ranks=8)
    # unmasked and DISCARD lanes are exempt — only real emits are checked
    dest = np.array([0, 9, -1, 12], np.int32)
    mask = np.array([1, 0, 1, 0], bool)
    jq, tq = _enqueue_both(16, [(fields, dest, mask)], num_ranks=8)
    _assert_same_queue(jq, tq)
    assert int(tq.count[0]) == 1


def test_make_queue_rejects_non_int_capacity_and_clear_keeps_drops():
    for bad in (16.0, "16", None, True):
        with pytest.raises(ValueError, match="static Python int"):
            TQ.make_queue(_tray_proto(), bad, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        TQ.make_queue(_tray_proto(), 0, device="cpu")
    fields = _fields(np.random.default_rng(2), "ray44", 6)
    _, tq = _enqueue_both(4, [(fields, np.zeros(6, np.int32), np.ones(6, bool))])
    tq = TQ.clear(tq)
    assert int(tq.count[0]) == 0 and int(tq.drops[0]) == 2
    assert bool((tq.dest == TQ.DISCARD).all())


# ------------------------------------------------- import law and device rule
def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f.relative_to(ROOT)} imports {mod}"


def test_entry_points_refuse_cpu_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    from repro_torch.apps import streamlines as sl
    from repro_torch.core import RafiContext

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompat.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TQ.make_queue(_tray_proto(), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RafiContext(8, _tray_proto(), capacity=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sl.run(sl.StreamlineConfig(num_particles=4, max_steps=2))
    assert tcompat.resolve_device("cpu") == torch.device("cpu")


def test_get_incoming_and_num_incoming_equal_reference():
    rng = np.random.default_rng(3)
    fields = _fields(rng, "ray44", 6)
    jq, tq = _enqueue_both(8, [(fields, np.array([0, 1, -1, 2, 3, 0], np.int32), np.ones(6, bool))])
    assert TQ.num_incoming(tq).tolist() == [int(JQ.num_incoming(jq))] == [5]
    for i in (0, 2, 4):
        j, t = JQ.get_incoming(jq, i), TQ.get_incoming(tq, i)
        for f in dataclasses.fields(TRay44):
            np.testing.assert_array_equal(
                getattr(t, f.name)[0].numpy().view(np.uint32),
                np.asarray(getattr(j, f.name)).view(np.uint32),
            )
