"""How the reference's production mesh splits a step's state over its
devices: the port's copy of the reference's partition rule, with no
``PartitionSpec``.  ``launch.dryrun`` reads it to give a cell's bytes per
device, and ``launch.placement`` to place a family's train state, its
serving parameters and its decode caches on a layout's ranks (the decoder
families, qwen2-vl's vision stub among the dense, and the
encoder-decoder split over ``model`` or under ``dp_over_model``):
:func:`cut` gives the rank blocks of a whole leaf under its resolved
spec, :func:`join` the whole leaf back.

A spec is a tuple with one entry per dimension: None (not split), an
axis name, or a tuple of axis names.  The axes are those of the
reference's mesh: ``data`` and ``model`` (16 × 16 on one pod), with
``pod`` (2) in front on two.  The rule, as the reference's parameter
definitions, cache specs and step builders state it:

* parameters, by the leaf's name: ``embed`` (model, None); ``lm_head``
  (None, model); the norms' gains (None); attention ``wq``/``wk``/``wv``
  and the MLP's ``wi``/``wg``, griffin's ``wa``/``wb``/``conv``/``wr``/
  ``wi``, rwkv's ``wr``/``wk``/``wv``/``ww``/``wg`` (None, model); every
  ``wo`` (model, None); the biases ``bq``/``bk``/``bv``, griffin's
  ``lam`` and rwkv's ``w_bias`` (model); rwkv's ``u`` (model, None); the
  MoE's ``router`` (None, None) and its experts (model, None, None) under
  ``rafi_ep`` (expert parallel), else ``wi``/``wg`` (None, None, model)
  and ``wo`` (None, model, None).  A stacked leaf (under ``blocks``,
  ``enc_blocks``, ``dec_blocks``) gets a leading None.  Then the config's
  policy: ``dp_over_model`` drops the model axis; ``fsdp`` (train only:
  serving drops it) puts ``data`` on the first unsplit dimension.
* the AdamW state: ``m`` and ``v`` as their parameters, ``step`` whole.
* caches: attention ``k``/``v`` (data, model, None, None) — batch over
  data, the sequence over model — and ``pos`` (data); griffin's ``h``
  (data, model) and ``conv`` (data, None, model); rwkv's state (data,
  model, None, None); stacked caches a leading None.
* the batch (and the decode token, the encoder memory): its first
  dimension over the batch axes — ``pod`` and ``data``, and ``model`` too
  under ``dp_over_model`` — the rest whole.
* everything else a step makes (activations, temporaries): over the
  pieces its batch rows are cut into and over the model axis too
  (:func:`activation_pieces`), as tensor parallelism cuts the heads, the
  hidden units and the vocabulary; the residual stream it keeps whole on
  every model rank is counted as cut too.  This is the reference's layout;
  the port's placed train step (``launch.placement``) keeps the residual
  stream whole on every model rank and does not count it as cut.

:func:`resolve_spec` then makes a spec legal for a shape as the
reference's does: an axis that does not divide its dimension is dropped
there and, for parameters and caches, moved to the first unsplit
dimension it divides.  A leaf's bytes on one device are its bytes over
the product of the axes its spec keeps.

A rank's coordinates on the mesh are mixed-radix in the axes' order
(:func:`rank_coords`: rank ``g·model + m`` is data g, model m), and a
dimension split over several axes is cut major-first, as a
``NamedSharding`` cuts it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

__all__ = ["activation_pieces", "batch_spec", "cache_spec", "cut", "device_bytes", "join", "mesh_axes", "named_leaves",
           "param_spec", "rank_coords", "resolve_spec", "share", "spec_axes"]

DATA, MODEL = "data", "model"
_STACKED = ("blocks", "enc_blocks", "dec_blocks")
_COLUMN = ("wq", "wk", "wv", "wi", "wg", "wa", "wb", "conv", "wr", "ww")
_MODEL_VECTOR = ("bq", "bk", "bv", "lam", "w_bias")


def mesh_axes(data: int = 16, model: int = 16, *, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's mesh as ``{axis: size}`` in its order: (data,
    model), or (pod 2, data, model) across two pods."""
    return {"pod": 2, DATA: data, MODEL: model} if multi_pod else {DATA: data, MODEL: model}


def named_leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` of a nested dict in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, path + (str(k),))
    else:
        yield path, tree


def _policy(spec: tuple, cfg, *, fsdp: bool) -> tuple:
    """The reference's ``_maybe_fsdp``."""
    if cfg.dp_over_model:
        spec = tuple(None if s == MODEL else s for s in spec)
    if not fsdp:
        return spec
    for i, s in enumerate(spec):
        if s is None:
            return spec[:i] + (DATA,) + spec[i + 1:]
    return spec


def param_spec(path: Tuple[str, ...], cfg, *, serve: bool = False) -> tuple:
    """A parameter's spec from its path in the model's tree (module
    docstring)."""
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if name == "embed":
        spec = (MODEL, None)
    elif name == "lm_head":
        spec = (None, MODEL)
    elif parent == "moe":
        if name == "router":
            spec = (None, None)
        elif cfg.moe_dispatch == "rafi_ep":
            spec = (MODEL, None, None)
        else:
            spec = (None, MODEL, None) if name == "wo" else (None, None, MODEL)
    elif name == "wo" or name == "u":
        spec = (MODEL, None)
    elif name in _MODEL_VECTOR:
        spec = (MODEL,)
    elif name in _COLUMN:
        spec = (None, MODEL)
    else:  # the norms' gains
        spec = (None,)
    if path[0] in _STACKED:
        spec = (None,) + spec
    return _policy(spec, cfg, fsdp=cfg.fsdp and not serve)


def cache_spec(path: Tuple[str, ...], cfg) -> tuple:
    """A decode cache leaf's spec from its path (``blocks.k0_global.k``,
    ``tail.k1_recurrent.h``, ``blocks.k0_rwkv``; the encoder-decoder's
    ``k``/``v``/``pos``, stacked)."""
    if cfg.kind == "encdec":
        kind, name, stacked = "global", path[-1], True
    else:
        kind, name, stacked = path[1].split("_", 1)[1], path[-1], path[0] == "blocks"
    if kind == "rwkv":
        spec = (DATA, MODEL, None, None)
    elif kind == "recurrent":
        spec = (DATA, MODEL) if name == "h" else (DATA, None, MODEL)
    else:
        spec = (DATA,) if name == "pos" else (DATA, MODEL, None, None)
    return ((None,) + spec) if stacked else spec


def batch_spec(ndim: int, cfg, axes: Dict[str, int]) -> tuple:
    """A batch leaf's spec: its first dimension over the batch axes."""
    baxes = tuple(a for a in axes if a != MODEL or cfg.dp_over_model)
    return (baxes,) + (None,) * (ndim - 1)


def resolve_spec(shape, spec: tuple, axes: Dict[str, int], *, allow_move: bool = True) -> tuple:
    """The reference's ``resolve_spec``: ``spec`` made legal for ``shape``
    on a mesh of ``axes``."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    placed, pending = [], []
    for dim, part in zip(shape, parts):
        names = () if part is None else (part if isinstance(part, tuple) else (part,))
        keep, factor = [], 1
        for ax in names:
            if dim % (factor * axes[ax]) == 0:
                keep.append(ax)
                factor *= axes[ax]
            else:
                pending.append(ax)
        placed.append(tuple(keep))
    if allow_move:
        for ax in pending:
            if ax in {a for p in placed for a in p}:
                continue
            for i, dim in enumerate(shape):
                if not placed[i] and dim % axes[ax] == 0 and axes[ax] > 1:
                    placed[i] = (ax,)
                    break
    return tuple((p[0] if len(p) == 1 else p) if p else None for p in placed)


def share(shape, spec: tuple, axes: Dict[str, int], *, allow_move: bool = True) -> int:
    """The number of pieces a leaf of ``shape`` is cut into under ``spec``."""
    out = 1
    for p in resolve_spec(tuple(shape), spec, axes, allow_move=allow_move):
        for ax in () if p is None else (p if isinstance(p, tuple) else (p,)):
            out *= axes[ax]
    return out


def device_bytes(t: torch.Tensor, spec: Optional[tuple], axes: Dict[str, int], *, allow_move: bool = True) -> int:
    """Bytes of ``t`` on one device under ``spec`` (None: whole)."""
    n = math.prod(t.shape) * t.element_size()
    return n if spec is None else n // share(t.shape, spec, axes, allow_move=allow_move)


def activation_pieces(cfg, batch: Dict[str, torch.Tensor], axes: Dict[str, int]) -> int:
    """The pieces a step's activations are cut into: its batch's (the
    first leaf's, under :func:`batch_spec`), times the model axis where
    the batch does not run over it."""
    first = next(iter(batch.values()))
    spec = batch_spec(first.dim(), cfg, axes)
    model = 1 if MODEL in spec[0] else axes.get(MODEL, 1)
    return share(first.shape, spec, axes, allow_move=False) * model


def spec_axes(part) -> Tuple[str, ...]:
    """The axis names of one entry of a spec (None: none)."""
    return () if part is None else (part if isinstance(part, tuple) else (part,))


def rank_coords(rank: int, axes: Dict[str, int]) -> Dict[str, int]:
    """A rank's index on each mesh axis: mixed radix in the axes' order."""
    out = {}
    for ax in reversed(list(axes)):
        out[ax] = rank % axes[ax]
        rank //= axes[ax]
    return {ax: out[ax] for ax in axes}


def _slices(shape, spec: tuple, axes: Dict[str, int], coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slice of a whole leaf of ``shape`` that the rank at ``coords``
    holds under the resolved ``spec``."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, parts):
        pieces, index = 1, 0
        for ax in spec_axes(part):
            pieces, index = pieces * axes[ax], index * axes[ax] + coords[ax]
        if dim % pieces:
            raise ValueError(f"{part} cuts {dim} into {pieces}: resolve the spec first")
        size = dim // pieces
        out.append(slice(index * size, (index + 1) * size))
    return tuple(out)


def cut(t: torch.Tensor, spec: tuple, axes: Dict[str, int], ranks) -> torch.Tensor:
    """``(len(ranks), *block)``: the block of the whole leaf ``t`` that each
    rank in ``ranks`` holds under the resolved ``spec``, in that order (a
    copy; the dimensions the spec names are cut, whichever they are)."""
    return torch.stack([t[_slices(t.shape, spec, axes, rank_coords(int(r), axes))] for r in ranks])


def join(blocks: torch.Tensor, spec: tuple, axes: Dict[str, int], shape) -> torch.Tensor:
    """The whole leaf of ``shape`` from every rank's block ``(R, *block)``
    (rank order; a replica's block is read once, from the first rank that
    holds it)."""
    whole = blocks.new_empty(tuple(shape))
    seen = set()
    for r in range(blocks.shape[0]):
        sl = _slices(tuple(shape), spec, axes, rank_coords(r, axes))
        key = tuple((s.start, s.stop) for s in sl)
        if key not in seen:
            seen.add(key)
            whole[sl] = blocks[r]
    return whole
