"""Work-item types and the packed wire format (§3.1, §4.2).

A work item is a dataclass whose fields are tensors (or nested work items):
RaFI's opaque, trivially-copyable ``RayT``.  The library only moves items —
gather, scatter, exchange — leaf by leaf, never looking inside.  Leaves are
ordered by dataclass field order, the order JAX's
``register_dataclass`` gives the reference, so packed words agree bit for bit
with ``repro.core.types.pack_payload``.

Packed wire format: the whole item bitcast into ONE ``(..., W)`` buffer of
32-bit words — the 44-byte Fig-8 ray is 11 words.  Words are ``int32``
tensors carrying the bits of the reference's ``uint32`` words (torch's
``uint32`` supports few operations).  Each leaf is flattened to its per-item
bytes and bitcast to whole words; 1- and 2-byte dtypes are zero-padded to a
word boundary, bools travel as uint8 0/1.  ``unpack ∘ pack`` is the identity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Sequence

import torch

__all__ = [
    "PackSpec",
    "batched_zeros",
    "item_nbytes",
    "pack_payload",
    "pack_spec",
    "tree_leaves",
    "tree_map",
    "tree_structure",
    "tree_unflatten",
    "unpack_payload",
    "work_item",
]


def work_item(cls):
    """Class decorator: make ``cls`` a dataclass and mark it a work-item type."""
    if not dataclasses.is_dataclass(cls):
        cls = dataclasses.dataclass(cls)
    cls.__work_item__ = True
    return cls


# ---------------------------------------------------------------- tree helpers
# A tree is a work-item dataclass instance (fields may nest work items) or a
# tensor leaf.  Its structure is None for a leaf, else (cls, names, children).


def _is_item(tree) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def tree_structure(tree):
    if not _is_item(tree):
        return None
    names = tuple(f.name for f in dataclasses.fields(tree))
    return (type(tree), names, tuple(tree_structure(getattr(tree, n)) for n in names))


def tree_leaves(tree) -> List[Any]:
    if not _is_item(tree):
        return [tree]
    return [leaf for f in dataclasses.fields(tree) for leaf in tree_leaves(getattr(tree, f.name))]


def tree_unflatten(treedef, leaves: Sequence[Any]):
    return _build(treedef, iter(leaves))


def _build(d, it):
    """A module function, not a closure over itself: a recursive closure
    is a reference cycle, and its iterator would hold the leaves until the
    cycle collector ran."""
    if d is None:
        return next(it)
    cls, names, kids = d
    return cls(**{n: _build(k, it) for n, k in zip(names, kids)})


def tree_map(fn: Callable, tree, *rest):
    leaves = [tree_leaves(t) for t in (tree,) + rest]
    return tree_unflatten(tree_structure(tree), [fn(*xs) for xs in zip(*leaves)])


def item_nbytes(proto) -> int:
    """Bytes of one work item — the paper's ``sizeof(RayT)``."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(proto)))


def batched_zeros(proto, batch: Sequence[int], *, device=None):
    """A zero-filled pytree of ``(*batch, ...)`` leaves shaped like ``proto``."""
    return tree_map(
        lambda t: torch.zeros(tuple(batch) + tuple(t.shape), dtype=t.dtype, device=device),
        proto,
    )


# ---------------------------------------------------------------- wire format


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static recipe for packing one work-item type (per-leaf trailing
    shapes, dtypes and word counts, in leaf order)."""

    treedef: Any
    shapes: tuple
    dtypes: tuple
    words: tuple

    @property
    def total_words(self) -> int:
        return sum(self.words)

    @property
    def offsets(self) -> tuple:
        out, o = [], 0
        for w in self.words:
            out.append(o)
            o += w
        return tuple(out)


def _leaf_words(shape, dtype: torch.dtype) -> int:
    n = math.prod(shape)
    return -(-n * dtype.itemsize // 4)  # zero-size leaves occupy zero words


def pack_spec(proto, *, batch_dims: int = 0) -> PackSpec:
    """The :class:`PackSpec` of items shaped like ``proto``; ``batch_dims``
    leading axes of every leaf are batch, not item, axes."""
    leaves = tree_leaves(proto)
    shapes = tuple(tuple(t.shape[batch_dims:]) for t in leaves)
    dtypes = tuple(t.dtype for t in leaves)
    return PackSpec(
        treedef=tree_structure(proto),
        shapes=shapes,
        dtypes=dtypes,
        words=tuple(_leaf_words(s, d) for s, d in zip(shapes, dtypes)),
    )


def _leaf_to_words(a: torch.Tensor, item_shape) -> torch.Tensor:
    """``(*batch, *item_shape)`` leaf → ``(*batch, words)`` int32, bit-preserving."""
    batch = tuple(a.shape[: a.dim() - len(item_shape)])
    if math.prod(item_shape) == 0:
        return torch.zeros(batch + (0,), dtype=torch.int32, device=a.device)
    if a.dtype == torch.bool:
        a = a.to(torch.uint8)
    flat = a.reshape(batch + (-1,)).contiguous()
    per = 4 // flat.element_size() if flat.element_size() < 4 else 1
    pad = (-flat.shape[-1]) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(batch + (pad,))], dim=-1)
    return flat.view(torch.int32)


def _words_to_leaf(seg: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    """``(*batch, words)`` int32 → ``(*batch, *shape)`` leaf of ``dtype``."""
    batch = tuple(seg.shape[:-1])
    n = math.prod(shape)
    if n == 0:
        return torch.zeros(batch + tuple(shape), dtype=dtype, device=seg.device)
    wire = torch.uint8 if dtype == torch.bool else dtype
    out = seg.contiguous().view(wire)[..., :n]
    if dtype == torch.bool:
        out = out != 0
    return out.reshape(batch + tuple(shape))


def pack_payload(items, spec: PackSpec | None = None, *, batch_dims: int = 1):
    """Bitcast-concatenate a batched item pytree into one ``(*batch, W)``
    int32 buffer.  Returns ``(packed, spec)``; without ``spec`` the first
    ``batch_dims`` axes of every leaf are the batch."""
    if spec is None:
        spec = pack_spec(items, batch_dims=batch_dims)
    cols = [_leaf_to_words(l, s) for l, s in zip(tree_leaves(items), spec.shapes)]
    packed = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    return packed, spec


def unpack_payload(packed: torch.Tensor, spec: PackSpec):
    """Inverse of :func:`pack_payload` (bit-exact)."""
    leaves, o = [], 0
    for shape, dtype, w in zip(spec.shapes, spec.dtypes, spec.words):
        leaves.append(_words_to_leaf(packed[..., o : o + w], shape, dtype))
        o += w
    return tree_unflatten(spec.treedef, leaves)
