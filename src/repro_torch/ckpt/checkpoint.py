"""Fault-tolerant checkpointing: atomic, integrity-checked, layout-stable
(the port's copy of ``repro.ckpt.checkpoint``, the same files).

* **Atomic**: a checkpoint is written to ``step_<k>.tmp/`` and renamed to
  ``step_<k>/`` only after every file (and the manifest) is fsync'd, so a
  crash mid-write never leaves a half checkpoint that restore would read.
* **Integrity**: the manifest stores a SHA-256 per leaf file, over the
  exact ``np.save`` bytes; restore verifies it before deserialising.
  Structure, shape and dtype mismatches between the checkpoint and the
  restore target raise ``ValueError``, a digest mismatch ``IOError``.
* **Layout-stable**: leaves are flattened in ``jax.tree.flatten``'s order
  (:func:`tree_flatten`) and saved as plain ``.npy`` arrays, so a tree the
  JAX package wrote restores here and the reverse: same files, same
  digests for equal arrays.  A tensor leaf is written from one host copy;
  a bfloat16 one as its 2-byte words (``'<V2'``, the file the reference
  writes for a bfloat16 array).
* **Retention**: the newest ``keep`` checkpoints stay, older ones go, and
  so does every orphaned ``step_*.tmp`` a crash mid-write left behind.
* **Worlds**: a ``torch.distributed`` world gathers what it saves and lets
  ONE process write (and prune) a directory; the others wait at a barrier
  after the publish and only then read (``core.recovery``,
  ``launch.train``).  Restore only reads, so every process may restore.
* **Placed state** (``launch.placement``): a placed node of the saved tree
  is written whole, gathered through its placement (in a world every
  process gathers, then one writes: ``launch.train``), so the files are
  the reference's whatever the layout.  ``restore_checkpoint(…,
  shardings=)`` places what it reads on any placement, of any
  factorization, as the reference's ``device_put`` onto its shardings.

The manifest's ``treedef`` is this module's own description of the tree;
restore never reads it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import compat

__all__ = [
    "latest_step",
    "load_manifest",
    "restore_checkpoint",
    "save_checkpoint",
    "tree_flatten",
    "tree_unflatten",
]


# ---------------------------------------------------------------- the tree
# A node is a dict (keys sorted), a tuple or list (in order), a dataclass
# instance (fields in order) or None (no leaf); anything else is a leaf.
# This is the leaf order jax.tree.flatten gives the reference's carries.


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` in ``jax.tree.flatten``'s leaf order."""
    leaves: List[Any] = []

    def walk(x):
        if x is None:
            return ("none",)
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", tuple(keys), tuple(walk(x[k]) for k in keys))
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, tuple(walk(v) for v in x))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = tuple(f.name for f in dataclasses.fields(x))
            return ("dataclass", type(x), names, tuple(walk(getattr(x, n)) for n in names))
        leaves.append(x)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves) -> Any:
    return _build(treedef, iter(leaves))


def _build(d, it):
    """A module function: a recursive closure would be a reference cycle
    holding the leaves until the cycle collector ran."""
    kind = d[0]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(it)
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    if kind in ("tuple", "list"):
        kids = [_build(c, it) for c in d[1]]
        return tuple(kids) if kind == "tuple" else kids
    _, cls, names, kids = d
    return cls(**{n: _build(c, it) for n, c in zip(names, kids)})


def _describe(treedef: Any) -> str:
    kind = treedef[0]
    if kind in ("none", "leaf"):
        return "*" if kind == "leaf" else "None"
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_describe(c)}" for k, c in zip(treedef[1], treedef[2])) + "}"
    if kind in ("tuple", "list"):
        inner = ", ".join(_describe(c) for c in treedef[1])
        return f"({inner})" if kind == "tuple" else f"[{inner}]"
    _, cls, names, kids = treedef
    return f"{cls.__name__}(" + ", ".join(f"{n}={_describe(c)}" for n, c in zip(names, kids)) + ")"


# numpy has no bfloat16: a bfloat16 leaf is written as its 2-byte words,
# the '<V2' file the reference's ml_dtypes arrays give
_BF16_NP = np.dtype("V2")


def to_host(leaf: Any) -> np.ndarray:
    """One host copy of a tensor leaf; numpy and Python values as they are."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(_BF16_NP)
        return leaf.numpy()
    return np.asarray(leaf)


def np_dtype(leaf: Any) -> np.dtype:
    """The numpy dtype of a tensor (a bfloat16 one's file dtype), array or Python value."""
    if isinstance(leaf, torch.Tensor):
        return _BF16_NP if leaf.dtype == torch.bfloat16 else torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype if not hasattr(leaf, "dtype") else np.dtype(leaf.dtype)


def _from_host(arr: np.ndarray, ref: Any) -> torch.Tensor:
    if isinstance(ref, torch.Tensor) and ref.dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# ------------------------------------------------------- the leaf file law
def npy_bytes(arr: np.ndarray) -> bytes:
    """The exact bytes a leaf file holds (``np.save``'s; a bfloat16 leaf's
    header says ``'<V2'``, as ml_dtypes' bfloat16 writes it)."""
    buf = io.BytesIO()
    if arr.dtype == _BF16_NP:
        header = np.lib.format.header_data_from_array_1_0(arr)
        np.lib.format.write_array_header_1_0(buf, dict(header, descr="<V2"))
        buf.write(np.ascontiguousarray(arr).tobytes())
    else:
        np.save(buf, arr)
    return buf.getvalue()


def digest(raw: bytes) -> str:
    return hashlib.sha256(raw).hexdigest()


def write_synced(path: Path, raw: bytes) -> None:
    with open(path, "wb") as f:
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())


def _published(ckpt_dir: Path) -> List[Path]:
    return sorted(p for p in ckpt_dir.iterdir() if p.name.startswith("step_") and not p.name.endswith(".tmp"))


# ------------------------------------------------------------- save / load
def save_checkpoint(ckpt_dir, step: int, tree: Any, *, keep: int = 3, meta: Optional[Dict] = None) -> Path:
    """Atomically publish ``tree`` as ``step_<step>/`` under ``ckpt_dir``.

    ``meta`` (optional, JSON-serialisable) is embedded in the manifest and
    readable without knowing the tree via :func:`load_manifest`."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    leaves, treedef = tree_flatten(_whole(tree))
    manifest = {"step": step, "treedef": _describe(treedef), "leaves": []}
    if meta is not None:
        manifest["meta"] = meta
    for i, leaf in enumerate(leaves):
        arr = to_host(leaf)
        path = tmp / f"leaf_{i:05d}.npy"
        # serialise once and hash the exact bytes written
        raw = npy_bytes(arr)
        write_synced(path, raw)
        dtype = "bfloat16" if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16 else str(arr.dtype)
        manifest["leaves"].append(
            {"file": path.name, "shape": list(arr.shape), "dtype": dtype, "sha256": digest(raw)}
        )
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish

    # retention: published checkpoints past the newest `keep` go, and so does
    # every orphaned step_*.tmp (ours was just renamed away, so any tmp dir
    # still present has no live writer)
    for old in _published(ckpt_dir)[:-keep]:
        shutil.rmtree(old)
    for orphan in ckpt_dir.glob("step_*.tmp"):
        shutil.rmtree(orphan)
    return final


def _whole(tree: Any) -> Any:
    """``tree`` with every placed node gathered whole through its placement."""
    if getattr(tree, "placement", None) is not None:
        return tree.placement.gather(tree)
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return tree


def _place(tree: Any, shardings: Any, device) -> Any:
    """``tree`` (host tensors) on ``device``: a subtree under a placement
    (anything with ``place``) placed by it, a dict of shardings applied key
    by key, the rest moved whole."""
    if hasattr(shardings, "place"):
        return shardings.place(tree, device=device)
    if isinstance(shardings, dict):
        return {k: _place(v, shardings.get(k), device) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: _place(v, None, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in _published(ckpt_dir)]
    return max(steps) if steps else None


def load_manifest(ckpt_dir, step: int) -> Dict:
    """The manifest of a published checkpoint: shapes, dtypes, digests and
    the saver's ``meta``, everything resume needs before it can build a
    ``like`` tree."""
    final = Path(ckpt_dir) / f"step_{step:08d}"
    mpath = final / "manifest.json"
    if not mpath.exists():
        raise FileNotFoundError(f"no published checkpoint at {final}")
    return json.loads(mpath.read_text())


def restore_checkpoint(ckpt_dir, step: int, like: Any, *, device=None, shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` (leaves may be numpy arrays or
    tensors, whole) as tensors on ``device`` (``None``: the CUDA card).
    ``shardings`` places what it reads (the elastic-rescale path): a
    ``launch.placement.Placement``, or a dict of them by ``like``'s keys
    (``{"params": p, "opt": p}``; a key without one is restored whole).

    Raises ``ValueError`` on a leaf-count, shape or dtype mismatch and
    ``IOError`` on a SHA-256 mismatch, before the leaf is deserialised."""
    dev = compat.resolve_device(device)
    final = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((final / "manifest.json").read_text())
    leaves_like, treedef = tree_flatten(like)
    if len(manifest["leaves"]) != len(leaves_like):
        raise ValueError(
            f"checkpoint/model mismatch: checkpoint has {len(manifest['leaves'])} leaves, "
            f"restore target has {len(leaves_like)}"
        )
    out = []
    for i, (entry, ref) in enumerate(zip(manifest["leaves"], leaves_like)):
        raw = (final / entry["file"]).read_bytes()
        if digest(raw) != entry["sha256"]:
            raise IOError(f"checkpoint corruption in {entry['file']}")
        arr = np.load(io.BytesIO(raw))
        ref_shape = list(np.shape(ref)) if not isinstance(ref, torch.Tensor) else list(ref.shape)
        if list(arr.shape) != ref_shape:
            raise ValueError(f"leaf {i}: checkpoint shape {list(arr.shape)} != expected {ref_shape}")
        ref_dtype = np_dtype(ref)
        if np.dtype(arr.dtype) != ref_dtype:
            raise ValueError(f"leaf {i}: checkpoint dtype {arr.dtype} != expected {ref_dtype}")
        out.append(_from_host(arr, ref) if shardings is not None else _from_host(arr, ref).to(dev))
    tree = tree_unflatten(treedef, out)
    return tree if shardings is None else _place(tree, shardings, dev)
