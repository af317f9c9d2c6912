"""Every family's train and serve state placed on a layout's ranks (the
port's counterpart of the shardings of ``repro.launch.steps``'
``build_train_step``, ``build_prefill_step`` and ``build_decode_step``,
and of ``jax.device_put`` onto them).

A :class:`Placement` is the reference's partition rule (``launch.specs``:
``param_spec``, then ``resolve_spec`` on the layout's axes) applied to a
model's parameters, leaf by leaf; it reads the rule and has no copy of
it.  :meth:`Placement.place` cuts a whole tree into every local rank's
blocks, :meth:`Placement.gather` joins them back:

  params  → :class:`Placed`, a nested dict like the parameter tree whose
            leaves are ``(L, *block)``: the blocks of the process's L ranks
            (all ``data·model`` ranks on the stacked backend; over a world
            of W processes process p holds ranks ``[p·L, (p+1)·L)``)
  AdamW   → ``m``, ``v`` (and ``master``, ``residual``) placed as their
            parameters, each a :class:`Placed`; ``step`` whole

The placement lives in the data, as a ``jax.Array``'s sharding does: a
train step given a :class:`Placed` runs the placed step
(``launch.steps``), given whole parameters the unsharded one.  Rank ``(g,
m)``'s block of a leaf is the slice of the whole leaf that the device at
``mesh.devices[g, m]`` of the reference's ``(data, model)`` mesh holds,
bit for bit.

The placed step's gradients and norm (``reduce``, ``sumsq``): a leaf
split over ``data`` (FSDP) gets its gradient ``reduce_scatter``'d in the
backward pass of its gather; one replicated over a batch axis (``data``,
and under ``dp_over_model`` ``model`` too) is ``psum``'d over it here;
both are then divided by the row groups (``Ranks.row_groups``) and
microbatches.
The global norm counts every element once: a rank adds a leaf's squares
only when it is the first replica on every axis the leaf is not split
over (:func:`counted`), and one flat ``psum`` sums the ranks.

Serving (:func:`serve_placement`) places the parameters by the same rule
with FSDP dropped (``specs.param_spec(serve=True)``): split over
``model``, replicated over ``data``, so :meth:`Placement.unshard` gathers
nothing.  The decode caches (:func:`cache_placement`) are placed by
``specs.cache_spec``: ``k`` and ``v`` ``(data, model, None, None)``, the
slots over ``data`` and the sequence over ``model``, ``pos`` over
``data``; griffin's ``h`` and ``conv`` and rwkv's state the slots over
``data`` and the channels or heads over ``model``;
:meth:`Placement.zeros` makes them on the device already placed.

Every family is placed here: dense (text-only, or qwen2-vl's vision stub,
whose ``embeds`` replace the lookup: the forward does not read ``embed``,
so :meth:`Placement.unshard` leaves it ungathered), MoE, the hybrid
(griffin's RG-LRU beside local attention), the ssm (rwkv6) and the
encoder-decoder in both of the reference's layouts.  Split over
``model`` (the smoke config's tensor parallelism) it is placed as the
dense family: the encoder's and the decoder's attention weights on the
heads, the MLP on d_ff, ``embed`` and ``lm_head`` on the vocabulary, the
rows over ``data``.  Under ``dp_over_model`` (the full config's policy)
the rule strips ``model`` from every weight, so each is whole on every
rank (with FSDP's ``data`` where the config asks), the batch rows run
over ``(data, model)``.  Either way the decoder caches keep the slots
over ``data`` and the sequence over ``model``.  An MoE's experts follow its
dispatch plane, as the rule names them: under ``rafi_ep`` ``(E, D, F)``
split over ``model`` on the expert dimension (each model rank owns
E/model experts), under ``dense_tp`` every expert on every rank with
d_ff split over ``model``; the router is whole.  Griffin's ``wa``/``wb``/``conv``/``wr``/``wi`` are
split over ``model`` on their d_rnn output channels, ``lam`` on its
channels and ``wo`` on its rows; its decode state ``h`` and ``conv`` on
the channels.  rwkv6's five projections are split on their output
columns (whole heads, head-major), ``w_bias`` on its channels, ``u`` on
its heads and ``wo`` on its rows; its decode state on the heads.  FSDP
puts ``data`` on the layer stack of a stacked leaf, or on the first
unsplit dimension where the stack does not divide.  Where ``model`` does
not divide the dimension the rule names, the reference moves it to
another; the port refuses the layout instead, naming that dimension (the
full seamless-m4t-medium config without ``dp_over_model``: its
vocabulary of 256,206 = 2 × 128,103 takes a ``model`` of 1 or 2).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.core.collectives import backend
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import DATA_TIER, MODEL_TIER, Layout
from repro_torch.models.api import Model
from repro_torch.models.common import ParamTree
from repro_torch.models.parallel import Ranks, gather
from repro_torch.models.rwkv6 import _heads

__all__ = ["Placed", "Placement", "cache_placement", "counted", "is_placed", "serve_placement", "train_placement"]

_OPT_PLACED = ("m", "v", "master", "residual")  # AdamW leaves placed as their parameters


class Placed(dict):
    """A nested dict of rank blocks ``(L, *block)``, like the parameter
    tree, with the :class:`Placement` that cut it (``placement``)."""

    def __init__(self, tree: Dict[str, Any], placement: "Placement"):
        super().__init__(tree)
        self.placement = placement

    def like(self, tree: Dict[str, Any]) -> "Placed":
        """``tree`` (of the same structure) placed as this one."""
        return Placed(tree, self.placement)


def is_placed(tree: Any) -> bool:
    return isinstance(tree, Placed)


def _split_over(spec: tuple) -> set:
    """The mesh axes a resolved spec splits a leaf over."""
    return {ax for part in spec for ax in S.spec_axes(part)}


def counted(spec: tuple, coords: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``(L,)`` bool: the ranks whose block of a leaf under ``spec`` the
    global norm counts: the first replica on every axis the spec does not
    split (``coords``: each local rank's index on each axis)."""
    split = _split_over(spec)
    out = torch.ones_like(next(iter(coords.values())), dtype=torch.bool)
    for ax, c in coords.items():
        if ax not in split:
            out &= c == 0
    return out


def _with_groups(tree, paths):
    """A cache tree with both ``blocks`` and ``tail``, as the forward reads
    them: a model of whole periods has no leaf under ``tail`` to name it."""
    if paths and paths[0][0] in ("blocks", "tail"):
        tree.setdefault("blocks", {})
        tree.setdefault("tail", {})
    return tree


def _by_path(tree, paths, fn):
    """The nested dict of ``fn(path, leaf)`` over ``paths``."""
    out: Dict[str, Any] = {}
    for path in paths:
        node, leaf = out, tree
        for k in path:
            leaf = leaf[k]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = fn(path, leaf)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """The reference's placement of a model's parameters (or decode caches)
    on ``layout``: ``specs`` maps each leaf's path to its resolved spec,
    ``shapes`` to its whole shape, ``dtypes`` (caches) to its dtype;
    ``rows_over_model``: the config's ``dp_over_model`` (the batch rows
    run over ``model`` too)."""

    layout: Layout
    specs: Dict[Tuple[str, ...], tuple]
    shapes: Dict[Tuple[str, ...], Tuple[int, ...]]
    dtypes: Dict[Tuple[str, ...], torch.dtype] = dataclasses.field(default_factory=dict)
    rows_over_model: bool = False

    @property
    def axes(self) -> Dict[str, int]:
        return S.mesh_axes(self.layout.data, self.layout.model)

    @property
    def comm(self):
        """The backend the ranks run on (the layout's, resolved once)."""
        return self.layout.comm

    def ranks(self, device) -> Ranks:
        """The process's ranks on ``device``, for the placed step's
        collectives."""
        return Ranks(self.layout, self.layout.local_ranks(device), self.rows_over_model)

    @property
    def paths(self) -> List[Tuple[str, ...]]:
        return list(self.specs)

    def zeros(self, device=None) -> "Placed":
        """Zero blocks of every leaf, made on ``device`` (None: the card)
        already placed: ``(L, *block)`` in the leaf's dtype."""
        dev = compat.resolve_device(device)
        L = self.layout.local_ranks().numel()
        tree: Dict[str, Any] = {}
        for path in self.paths:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            block = S._slices(self.shapes[path], self.specs[path], self.axes, S.rank_coords(0, self.axes))
            node[path[-1]] = torch.zeros((L,) + tuple(s.stop - s.start for s in block), dtype=self.dtypes[path],
                                         device=dev)
        return Placed(_with_groups(tree, self.paths), self)

    # ------------------------------------------------------------- place
    def _place_params(self, tree, device) -> Placed:
        ids = self.layout.local_ranks().tolist()

        def cut(path, t):
            if tuple(t.shape) != self.shapes[path]:
                raise ValueError(f"{'.'.join(path)}: shape {tuple(t.shape)} != {self.shapes[path]}")
            return S.cut(t.detach(), self.specs[path], self.axes, ids).to(device)

        return Placed(_with_groups(_by_path(tree, self.paths, cut), self.paths), self)

    def place(self, tree, *, device=None):
        """Whole parameters (a ``ParamTree`` or its ``tree()``) → a
        :class:`Placed`; an AdamW state → the state with ``m``, ``v`` (and
        ``master``, ``residual``) placed and ``step`` whole.  On ``device``
        (None: each leaf's own)."""
        dev = None if device is None else compat.resolve_device(device)
        if isinstance(tree, ParamTree):
            tree = tree.tree()
        if isinstance(tree, dict) and "step" in tree and "m" in tree:
            return {k: (self._place_params(v, dev) if k in _OPT_PLACED else
                        (v if dev is None else v.to(dev))) for k, v in tree.items()}
        return self._place_params(tree, dev)

    def _gather_params(self, placed) -> Dict[str, Any]:
        comm = self.comm

        def join(path, blocks):
            return S.join(comm.gather_all(blocks.detach()), self.specs[path], self.axes, self.shapes[path])

        return _with_groups(_by_path(placed, self.paths, join), self.paths)

    def gather(self, tree):
        """The whole tree in every process (off the call recorder): a
        :class:`Placed` → its whole leaves; an AdamW state with placed
        moments → the whole state."""
        if is_placed(tree):
            return self._gather_params(tree)
        return {k: (self._gather_params(v) if is_placed(v) else v) for k, v in tree.items()}

    # ------------------------------------------------------------ the step
    def unshard(self, placed: Placed, ranks: Ranks, *, skip=()) -> Dict[str, Any]:
        """Every leaf whole over ``data``: an FSDP leaf gathered over it
        along the dimension its spec names (the whole layer stack at once;
        its gradient is ``reduce_scatter``'d back), the rest as they are.
        ``(L, *block)`` with only ``model`` still split.  The top-level
        leaves named in ``skip`` (a forward that does not read them) are
        left out, gathered by no call."""
        def one(path, t):
            dims = [i for i, part in enumerate(self.specs[path]) if S.DATA in S.spec_axes(part)]
            return t if not dims else gather(t, ranks, DATA_TIER, dims[0])

        return _by_path(placed, [p for p in self.paths if p[0] not in skip], one)

    def reduce(self, placed: Placed, ranks: Ranks, scale: float) -> Dict[str, Any]:
        """The gradients of the placed step, as a tree: each leaf's
        ``.grad`` (None stays None), ``psum``'d over every batch axis the
        leaf is replicated over (``data``, and under ``dp_over_model``
        ``model`` too: over both, one flat ``psum`` of every rank; an
        FSDP leaf's ``data`` was ``reduce_scatter``'d in the backward
        pass), then divided by ``scale``."""
        batch_axes = ((S.DATA, ranks.data), (S.MODEL, ranks.model if ranks.rows_over_model else 1))

        def one(path, p):
            g = p.grad
            if g is None:
                return None
            over = [ax for ax, n in batch_axes if n > 1 and ax not in _split_over(self.specs[path])]
            if len(over) == 2:
                g.copy_(ranks.comm.psum(g))
            elif over:
                g = ranks.comm.psum(g, digits=ranks.digits, tier=DATA_TIER if over == [S.DATA] else MODEL_TIER)
            return g.div_(scale)

        return _by_path(placed, self.paths, one)

    def sumsq(self, grads: List[Optional[torch.Tensor]], ranks: Ranks) -> torch.Tensor:
        """The squares of every gradient element summed once over the world
        (``grads`` in AdamW's leaf order: keys sorted, so the paths sorted):
        each rank's counted squares, then one flat ``psum``."""
        coords = {S.DATA: ranks.group, S.MODEL: ranks.mrank}
        local = torch.zeros(ranks.ids.shape[0], dtype=torch.float32, device=ranks.ids.device)
        for path, g in zip(sorted(self.paths), grads):
            if g is None:
                continue
            g32 = g.to(torch.float32)
            sq = (g32 * g32).reshape(g32.shape[0], -1).sum(dim=1)
            local = local + torch.where(counted(self.specs[path], coords), sq, torch.zeros_like(sq))
        return ranks.comm.psum(local)


_PLACED_KINDS = ("dense", "moe", "hybrid", "ssm", "encdec")
_FRONTENDS = {"dense": ("none", "vision"), "encdec": ("audio",)}  # the stub frontends placed beside "none"


def _placed_layout(model: Model, layout: Layout) -> Layout:
    """``layout`` with its backend resolved, for a model of a placed
    family (module docstring)."""
    cfg = model.cfg
    if cfg.kind not in _PLACED_KINDS or cfg.frontend not in _FRONTENDS.get(cfg.kind, ("none",)):
        raise NotImplementedError(f"{cfg.name}: kind={cfg.kind!r} with frontend={cfg.frontend!r} is not placed")
    if cfg.dp_over_model and cfg.kind != "encdec":
        raise NotImplementedError(f"{cfg.name}: dp_over_model is placed for the encoder-decoder only (the decoder "
                                  "families' placed layers split their weights over model)")
    return dataclasses.replace(layout, comm=backend(layout.comm))


def _axis_dims(spec: tuple, ax: str) -> List[int]:
    return [i for i, part in enumerate(spec) if ax in S.spec_axes(part)]


def _what_model_splits(path: Tuple[str, ...], cfg) -> str:
    """The dimension the rule puts ``model`` on, in words, for a refusal."""
    parent = path[-2] if len(path) > 1 else ""
    if path[-1] in ("embed", "lm_head"):
        return f"the vocabulary ({cfg.vocab_size})"
    if parent == "moe" and path[-1] != "router":
        return f"the {cfg.num_experts} experts" if cfg.moe_dispatch == "rafi_ep" else f"d_ff ({cfg.d_ff})"
    if parent == "rwkv":
        return f"the {_heads(cfg)} heads"
    if parent == "rglru":
        return f"d_rnn ({cfg.d_model})"
    return "the dimension the rule names"


def _param_placement(model: Model, layout: Layout, *, serve: bool) -> Placement:
    cfg = model.cfg
    layout = _placed_layout(model, layout)
    axes = S.mesh_axes(layout.data, layout.model)
    specs, shapes = {}, {}
    for path, d in S.named_leaves(model.defs):
        raw = S.param_spec(path, cfg, serve=serve)
        spec = S.resolve_spec(d.shape, raw, axes)
        named, kept = _axis_dims(raw, S.MODEL), _axis_dims(spec, S.MODEL)
        if layout.model > 1 and named != kept:
            raise ValueError(f"{'.'.join(path)} {d.shape}: the model axis ({layout.model}) does not divide "
                             f"{_what_model_splits(path, cfg)} and moves from dimension {named} to {kept} on {axes}")
        specs[path], shapes[path] = spec, d.shape
    return Placement(layout, specs, shapes, rows_over_model=cfg.dp_over_model)


def train_placement(model: Model, layout: Layout) -> Placement:
    """The placement of ``model``'s train state on ``layout`` (its
    ``comm`` the backend: None stacked), as ``build_train_step``'s
    shardings place the reference's on the ``(data, model)`` mesh.
    Raises where the rule would move ``model`` off the dimension it names
    (no dense smoke config does on a layout of 8 ranks; a vocabulary
    ``model`` does not divide; an MoE's experts under
    ``rafi_ep`` where ``model`` does not divide them, as the reference
    asserts, and its d_ff under ``dense_tp``; rwkv6 where ``model`` does
    not divide its heads, griffin where it does not divide d_rnn)."""
    return _param_placement(model, layout, serve=False)


def serve_placement(model: Model, layout: Layout) -> Placement:
    """The placement of ``model``'s parameters for serving on ``layout``,
    as ``build_prefill_step`` and ``build_decode_step``'s shardings place
    the reference's (``Model.specs(serve=True)``): FSDP dropped, every
    weight split over ``model`` and replicated over ``data``.  The same
    refusals as :func:`train_placement`."""
    return _param_placement(model, layout, serve=True)


def _what_cache_model_splits(path: Tuple[str, ...]) -> str:
    """What a cache leaf's spec puts ``model`` on, in words."""
    kind = "global" if len(path) < 2 or "_" not in path[1] else path[1].split("_", 1)[1]
    return {"rwkv": "the heads", "recurrent": "the channels"}.get(kind, "the sequence")


def cache_placement(model: Model, layout: Layout, batch: int, max_len: int) -> Placement:
    """The placement of ``model``'s decode caches of ``batch`` slots and
    ``max_len`` positions on ``layout``, as ``build_decode_step``'s
    shardings place the reference's (``specs.cache_spec`` resolved against
    ``steps.abstract_caches``' shapes, moves allowed): ``k``/``v`` the
    slots over ``data`` and the sequence over ``model``, ``pos`` over
    ``data``; griffin's ``h`` and ``conv`` the slots over ``data`` and the
    channels over ``model``, rwkv's state the heads.  Raises where the
    resolved spec moves ``model`` off what it names (``max_len % model``:
    the placed decode attends over a sequence split; the channels or heads
    the placed blocks hold) or ``data`` off the slots (``batch % data``)."""
    from repro_torch.launch.steps import abstract_caches

    cfg = model.cfg
    layout = _placed_layout(model, layout)
    axes = S.mesh_axes(layout.data, layout.model)
    specs, shapes, dtypes = {}, {}, {}
    for path, a in S.named_leaves(abstract_caches(model, batch, max_len)):
        raw = S.cache_spec(path, cfg)
        spec = S.resolve_spec(tuple(a.shape), raw, axes, allow_move=True)
        for ax, size in ((S.MODEL, layout.model), (S.DATA, layout.data)):
            named, kept = _axis_dims(raw, ax), _axis_dims(spec, ax)
            if size > 1 and named != kept:
                what = _what_cache_model_splits(path) if ax == S.MODEL else "the slots"
                raise ValueError(f"{'.'.join(path)} {tuple(a.shape)}: the {ax} axis moves off {what} (dimension "
                                 f"{named} to {kept}) on {axes}: batch {batch}, max_len {max_len}")
        specs[path], shapes[path], dtypes[path] = spec, tuple(a.shape), a.dtype
    return Placement(layout, specs, shapes, dtypes, rows_over_model=cfg.dp_over_model)
