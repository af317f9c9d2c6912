"""The port's checkpoint writer and reader (``repro_torch.ckpt``) against
``repro.ckpt``.

* The assertions of ``tests/test_ckpt.py`` on the port — atomic publish,
  SHA-256 integrity checked before deserialising, orphan sweep,
  retention, typed errors — each with a numpy tree and with a tensor tree.
* The leaf order is ``jax.tree.flatten``'s (dict keys sorted, tuples and
  lists in order, dataclass fields in order, ``None`` no leaf).
* A tree the JAX package wrote restores in the port and the reverse, and
  equal arrays give equal files and SHA-256 digests in both packages.

Tolerance: none — every comparison is of bits.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import ckpt as JK
from repro.core import WorkQueue as JWorkQueue
from repro.chaos.driver import ChaosItem as JChaosItem
from repro_torch import ckpt
from repro_torch.chaos import ChaosItem
from repro_torch.core import WorkQueue

KINDS = ["numpy", "torch"]


def _tree(step=0, kind="numpy"):
    t = {
        "a": np.arange(6, dtype=np.int32).reshape(2, 3) + step,
        "b": (np.float32(1.5) * np.ones((4,), np.float32), np.asarray(np.int32(step))),
    }
    if kind == "torch":
        t = {"a": torch.from_numpy(t["a"]), "b": tuple(torch.from_numpy(np.asarray(x)) for x in t["b"])}
    return t


def _like():
    return {"a": np.zeros((2, 3), np.int32), "b": (np.zeros((4,), np.float32), np.zeros((), np.int32))}


def _restore(path, step, like):
    return ckpt.restore_checkpoint(path, step, like, device="cpu")


def _steps(path):
    return sorted(int(p.name.split("_")[1]) for p in path.iterdir()
                  if p.name.startswith("step_") and not p.name.endswith(".tmp"))


@pytest.mark.parametrize("kind", KINDS)
def test_save_restore_roundtrip_bitexact(tmp_path, kind):
    path = ckpt.save_checkpoint(tmp_path, 3, _tree(3, kind))
    assert path == tmp_path / "step_00000003"
    assert (path / "manifest.json").exists()
    out = _restore(tmp_path, 3, _like())
    want = _tree(3)
    for got, w in zip([out["a"], out["b"][0], out["b"][1]], [want["a"], want["b"][0], want["b"][1]]):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(got), w)
        assert np.asarray(got).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("kind", KINDS)
def test_meta_roundtrips_through_manifest(tmp_path, kind):
    meta = {"round": 7, "num_ranks": 8, "overflow": "retain"}
    ckpt.save_checkpoint(tmp_path, 7, _tree(kind=kind), meta=meta)
    man = ckpt.load_manifest(tmp_path, 7)
    assert man["meta"] == meta and man["step"] == 7
    assert [e["dtype"] for e in man["leaves"]] == ["int32", "float32", "int32"]
    with pytest.raises(FileNotFoundError):
        ckpt.load_manifest(tmp_path, 99)


@pytest.mark.parametrize("kind", KINDS)
def test_latest_step_ignores_tmp_dirs(tmp_path, kind):
    assert ckpt.latest_step(tmp_path) is None
    ckpt.save_checkpoint(tmp_path, 2, _tree(kind=kind))
    ckpt.save_checkpoint(tmp_path, 5, _tree(kind=kind))
    (tmp_path / "step_00000009.tmp").mkdir()  # crashed writer, never published
    assert ckpt.latest_step(tmp_path) == 5


@pytest.mark.parametrize("kind", KINDS)
def test_corrupted_leaf_detected_before_deserialize(tmp_path, kind, monkeypatch):
    ckpt.save_checkpoint(tmp_path, 1, _tree(kind=kind))
    victim = tmp_path / "step_00000001" / "leaf_00000.npy"
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF  # bit-rot in the tensor payload, header intact
    victim.write_bytes(bytes(raw))

    def no_load(*_a, **_k):
        raise AssertionError("a corrupted leaf was deserialised")

    monkeypatch.setattr(np, "load", no_load)
    with pytest.raises(IOError, match="corruption"):
        _restore(tmp_path, 1, _like())


@pytest.mark.parametrize("kind", KINDS)
def test_structure_shape_dtype_mismatches_raise_valueerror(tmp_path, kind):
    ckpt.save_checkpoint(tmp_path, 1, _tree(kind=kind))
    with pytest.raises(ValueError, match="leaves"):
        _restore(tmp_path, 1, {"a": np.zeros((2, 3), np.int32)})
    bad_shape = _like()
    bad_shape["a"] = np.zeros((3, 2), np.int32)
    with pytest.raises(ValueError, match="shape"):
        _restore(tmp_path, 1, bad_shape)
    bad_dtype = _like()
    bad_dtype["a"] = torch.zeros((2, 3), dtype=torch.float32)  # a tensor target is checked too
    with pytest.raises(ValueError, match="dtype"):
        _restore(tmp_path, 1, bad_dtype)


@pytest.mark.parametrize("kind", KINDS)
def test_crash_mid_write_leaves_prior_checkpoint_restorable(tmp_path, kind):
    ckpt.save_checkpoint(tmp_path, 4, _tree(4, kind), keep=10)
    orphan = tmp_path / "step_00000008.tmp"
    orphan.mkdir()
    (orphan / "leaf_00000.npy").write_bytes(b"partial garbage")
    assert ckpt.latest_step(tmp_path) == 4
    np.testing.assert_array_equal(np.asarray(_restore(tmp_path, 4, _like())["a"]), _tree(4)["a"])
    ckpt.save_checkpoint(tmp_path, 12, _tree(12, kind), keep=10)
    assert not orphan.exists()
    assert ckpt.latest_step(tmp_path) == 12


@pytest.mark.parametrize("kind", KINDS)
def test_retention_keeps_newest_k_and_resave_overwrites(tmp_path, kind):
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(tmp_path, s, _tree(s, kind), keep=3)
    assert _steps(tmp_path) == [3, 4, 5]
    ckpt.save_checkpoint(tmp_path, 5, _tree(50, kind), keep=3)
    np.testing.assert_array_equal(np.asarray(_restore(tmp_path, 5, _like())["a"]), _tree(50)["a"])


@pytest.mark.parametrize("kind", KINDS)
def test_manifest_hashes_witness_bit_identity(tmp_path, kind):
    ckpt.save_checkpoint(tmp_path / "x", 0, _tree(9, kind))
    ckpt.save_checkpoint(tmp_path / "y", 0, _tree(9, kind))
    mx, my = ckpt.load_manifest(tmp_path / "x", 0), ckpt.load_manifest(tmp_path / "y", 0)
    assert [e["sha256"] for e in mx["leaves"]] == [e["sha256"] for e in my["leaves"]]
    changed = _tree(9)
    changed["a"] = changed["a"].copy()
    changed["a"][0, 0] += 1
    ckpt.save_checkpoint(tmp_path / "z", 0, changed)
    mz = ckpt.load_manifest(tmp_path / "z", 0)
    diff = [i for i, (ex, ez) in enumerate(zip(mx["leaves"], mz["leaves"])) if ex["sha256"] != ez["sha256"]]
    assert diff == [0]


# ------------------------------------------------------ across the packages
def _carry_pair(seed=0):
    """The same values as a JAX-package tree and a port tree: a dict with
    unsorted keys, a queue of chaos items (dataclasses), a tuple, a list
    and a ``None``."""
    rng = np.random.default_rng(seed)
    uid = rng.integers(0, 1 << 30, 12, dtype=np.int32)
    val = rng.standard_normal((12, 2)).astype(np.float32)
    dest = rng.integers(-1, 4, 12).astype(np.int32)
    count, drops = np.array([3, 5], np.int32), np.array([0, 1], np.int32)
    aux = tuple(rng.integers(0, 1 << 32, 2, dtype=np.uint64).astype(np.uint32) for _ in range(3))
    extra = [np.int32(7), np.arange(4, dtype=np.int64)]
    jtree = {"z": np.int32(4), "q": JWorkQueue(items=JChaosItem(uid=uid, val=val), dest=dest, count=count,
                                               drops=drops),
             "aux": aux, "extra": extra, "none": None}
    t = torch.from_numpy
    ttree = {"none": None, "extra": [t(np.asarray(e)) for e in extra], "aux": tuple(t(a) for a in aux),
             "q": WorkQueue(items=ChaosItem(uid=t(uid), val=t(val)), dest=t(dest), count=t(count), drops=t(drops)),
             "z": t(np.asarray(np.int32(4)))}
    return jtree, ttree


def test_flatten_order_is_jax_tree_flatten_order():
    jtree, ttree = _carry_pair()
    jleaves, _ = jax.tree.flatten(jtree)
    tleaves, treedef = ckpt.tree_flatten(ttree)
    assert len(jleaves) == len(tleaves) == 11
    for j, t in zip(jleaves, tleaves):
        assert np.asarray(j).dtype == np.asarray(t).dtype
        np.testing.assert_array_equal(np.asarray(j), np.asarray(t))
    back = ckpt.tree_unflatten(treedef, tleaves)
    assert back["none"] is None and isinstance(back["q"], WorkQueue) and isinstance(back["q"].items, ChaosItem)
    assert isinstance(back["extra"], list) and isinstance(back["aux"], tuple)


def test_jax_checkpoint_restores_in_port_and_back(tmp_path):
    """A tree ``repro.ckpt`` wrote restores in the port leaf for leaf; the
    port's save of the restored tree gives the same files' digests, and
    ``repro.ckpt`` restores the port's checkpoint."""
    jtree, ttree = _carry_pair(1)
    meta = {"schema": "probe", "round": 3}
    JK.save_checkpoint(tmp_path / "jax", 3, jtree, meta=meta)
    leaves, treedef = ckpt.tree_flatten(ttree)
    like = ckpt.tree_unflatten(treedef, [np.zeros_like(t.numpy()) for t in leaves])
    got = ckpt.restore_checkpoint(tmp_path / "jax", 3, like, device="cpu")
    for a, b in zip(ckpt.tree_flatten(got)[0], ckpt.tree_flatten(ttree)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ckpt.save_checkpoint(tmp_path / "port", 3, got, meta=meta)
    mj, mt = JK.load_manifest(tmp_path / "jax", 3), ckpt.load_manifest(tmp_path / "port", 3)
    assert mj["meta"] == mt["meta"] and mj["step"] == mt["step"]
    strip = lambda m: [{k: v for k, v in e.items()} for e in m["leaves"]]
    assert strip(mj) == strip(mt)  # file, shape, dtype and sha256 of every leaf
    for e in mj["leaves"]:
        assert (tmp_path / "jax" / "step_00000003" / e["file"]).read_bytes() == \
            (tmp_path / "port" / "step_00000003" / e["file"]).read_bytes()
    back = JK.restore_checkpoint(tmp_path / "port", 3, jax.tree.map(np.zeros_like, jtree))
    for a, b in zip(jax.tree.flatten(back)[0], jax.tree.flatten(jtree)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert json.loads((tmp_path / "port" / "step_00000003" / "manifest.json").read_text())["treedef"]


def test_restore_lands_on_the_requested_device(tmp_path):
    """``device=None`` means the card; without one the port raises rather
    than falling back to the host."""
    ckpt.save_checkpoint(tmp_path, 0, _tree())
    if torch.cuda.is_available():
        assert _restore(tmp_path, 0, _like())["a"].device.type == "cpu"
        assert ckpt.restore_checkpoint(tmp_path, 0, _like())["a"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.restore_checkpoint(tmp_path, 0, _like())
