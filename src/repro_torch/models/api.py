"""Model API: build a config into init / loss / prefill / decode functions
(counterpart of ``repro.models.api``).

``build_model(cfg)`` returns a :class:`Model` holding the config and its
parameter declarations; nothing is allocated until :meth:`Model.init`
(random weights from a ``torch.Generator``) or :func:`params_from_jax` (the
reference's parameter tree, so that both packages compute the same thing).
:meth:`Model.abstract` gives the same module on the meta device, shapes
and dtypes only.
Both give a :class:`~repro_torch.models.transformer.LM` module, or an
:class:`~repro_torch.models.encdec.EncDec` for the ``encdec`` kind, whose
loss, prefill and decode run the encoder and take its memory.  The step
functions take the parameters (the module, or its ``tree()``) and the decode
state explicitly, as the reference's pure functions do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import compat
from repro_torch.models import encdec as ED
from repro_torch.models import parallel as P
from repro_torch.models import transformer as TF
from repro_torch.models.common import (
    ModelConfig, ParamDef, ParamTree, cross_entropy_loss, cross_entropy_loss_placed, cross_entropy_loss_rows,
    init_params, tree_leaves,
)

__all__ = ["Model", "build_model", "params_from_jax", "placed_decode", "placed_loss", "placed_prefill"]


def _module(cfg: ModelConfig, device):
    return ED.EncDec(cfg, device=device) if cfg.kind == "encdec" else TF.LM(cfg, device=device)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    defs: Dict[str, Any]

    # ---------------------------------------------------------- parameters
    def init(self, generator: Optional[torch.Generator] = None, *, device=None) -> ParamTree:
        """Random weights on ``device`` (``None``: the CUDA card), drawn
        leaf by leaf from ``generator`` (default: seed 0 on that device)."""
        dev = compat.resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return init_params(_module(self.cfg, dev), generator)

    def abstract(self) -> ParamTree:
        """The module on ``torch.device("meta")``: every parameter's shape
        and dtype, nothing allocated and nothing drawn (the counterpart of
        the reference's ``abstract_params``; ``launch.dryrun`` runs the
        steps on it)."""
        return _module(self.cfg, torch.device("meta"))

    def param_count(self) -> int:
        """Parameters, from the declared shapes (nothing is allocated)."""
        return int(sum(math.prod(d.shape) for d in tree_leaves(self.defs)))

    # --------------------------------------------------------------- steps
    def loss_fn(self, layout=None) -> Callable:
        """``loss(params, batch)``: the mean next-token CE of ``batch``
        (``tokens`` (B, S); ``labels`` if given, else ``tokens[:, 1:]``;
        ``embeds`` as the frontend; for ``encdec``, ``frames`` (B, T, D)
        and ``tokens``), differentiable in the parameters."""
        cfg = self.cfg
        if cfg.kind == "encdec":
            def loss(params, batch):
                if getattr(params, "placement", None) is not None:
                    return placed_loss(params, batch, cfg)
                memory = ED.encode(params, batch["frames"], cfg)
                logits, _ = ED.decode(params, batch["tokens"], memory, cfg)
                return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:], vocab=cfg.vocab_size)

            return loss

        def loss(params, batch):
            if getattr(params, "placement", None) is not None:
                return placed_loss(params, batch, cfg)
            logits, _, _ = TF.forward(
                params, batch["tokens"], cfg, layout=layout, frontend_embeds=batch.get("embeds"),
            )
            labels = batch["labels"] if "labels" in batch else batch["tokens"][:, 1:]
            if logits.shape[1] != labels.shape[1]:
                logits = logits[:, : labels.shape[1]]
            return cross_entropy_loss(logits, labels, vocab=cfg.vocab_size)

        return loss

    def prefill_fn(self, layout=None) -> Callable:
        """``prefill(params, batch)``: the last position's logits (B, V);
        on placed parameters :func:`placed_prefill`."""
        cfg = self.cfg
        if cfg.kind == "encdec":
            def prefill(params, batch):
                if getattr(params, "placement", None) is not None:
                    return placed_prefill(params, batch, cfg)
                with torch.no_grad():
                    memory = ED.encode(params, batch["frames"], cfg)
                    logits, _ = ED.decode(params, batch["tokens"], memory, cfg)
                return logits[:, -1]

            return prefill

        def prefill(params, batch):
            if getattr(params, "placement", None) is not None:
                return placed_prefill(params, batch, cfg)
            with torch.no_grad():
                logits, _, _ = TF.forward(
                    params, batch["tokens"], cfg, layout=layout, frontend_embeds=batch.get("embeds"),
                )
            return logits[:, -1]

        return prefill

    def decode_fn(self, layout=None, *, drops: bool = False) -> Callable:
        """One token step with caches: (params, token (B,1), caches) →
        (logits (B,V), new_caches), with the step's MoE drops last when
        ``drops``.  For ``encdec`` the step also takes the encoder memory:
        (params, token, caches, memory), its positions read from the first
        layer's cache.  On placed parameters the step is
        :func:`placed_decode`, its caches placed too (an encoder-decoder's
        ``memory`` the global ``(B, T, D)``)."""
        cfg = self.cfg
        if cfg.kind == "encdec":
            def encdec_step(params, token, caches, memory):
                zero = torch.zeros((), dtype=torch.int32, device=token.device)
                if getattr(params, "placement", None) is not None:
                    return placed_decode(params, token, caches, cfg, memory=memory)[:2] + ((zero,) if drops else ())
                positions = caches["pos"][0][:, None].to(torch.int32)  # (B, 1)
                with torch.no_grad():
                    logits, new_caches = ED.decode(params, token, memory, cfg, caches=caches, positions=positions)
                return (logits[:, -1], new_caches) + ((zero,) if drops else ())

            return encdec_step

        def step(params, token, caches):
            if getattr(params, "placement", None) is not None:
                logits, new_caches, moe_drops = placed_decode(params, token, caches, cfg)
                return (logits, new_caches) + ((moe_drops,) if drops else ())
            pos0 = _first_cache_pos(caches, token.shape[0], token.device)
            positions = pos0[:, None].to(torch.int32)  # (B, 1) per-row depth
            with torch.no_grad():
                logits, new_caches, moe_drops = TF.forward(
                    params, token, cfg, layout=layout, caches=caches, positions=positions
                )
            return (logits[:, -1], new_caches) + ((moe_drops,) if drops else ())

        return step

    # --------------------------------------------------------------- caches
    def init_caches(self, batch: int, max_len: int, *, device=None):
        dev = compat.resolve_device(device)
        if self.cfg.kind == "encdec":
            return ED.init_dec_caches(self.cfg, batch, max_len, device=dev)
        return TF.init_caches(self.cfg, batch, max_len, device=dev)


def placed_loss(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """``(L,)``: each local rank's mean next-token CE on placed parameters.
    The global batch's rows split over the row groups in order
    (:func:`_group_rows`); every leaf is gathered whole over ``data``
    first (the FSDP gather), then the placed pass and its loss: the
    tensor-parallel decoder (``TF.forward_placed``; ``embeds`` feed it in
    place of the lookup, whose table is then not gathered) or
    encoder-decoder (``ED.encode_placed``, ``ED.decode_placed``) and the
    loss over the split vocabulary; under ``dp_over_model`` the
    encoder-decoder on each rank's own rows and the loss over the whole
    vocabulary."""
    placement = params.placement
    tokens = batch["tokens"]
    ranks = placement.ranks(tokens.device)
    tokens = _group_rows(tokens, ranks)
    if cfg.kind == "encdec":
        whole = placement.unshard(params, ranks)
        memory = ED.encode_placed(whole, _group_rows(batch["frames"], ranks), cfg, ranks)
        logits, _ = ED.decode_placed(whole, tokens, memory, cfg, ranks)
        if ranks.rows_over_model:
            return cross_entropy_loss_rows(logits[:, :, :-1], tokens[:, :, 1:])
        return cross_entropy_loss_placed(logits[:, :, :-1], tokens[:, :, 1:], ranks)
    embeds = _frontend(batch, ranks)
    logits, _, _ = TF.forward_placed(_unshard(placement, params, ranks, cfg, embeds), tokens, cfg, ranks,
                                     frontend_embeds=embeds)
    labels = _group_rows(batch["labels"], ranks) if "labels" in batch else tokens[:, :, 1:]
    if logits.shape[2] != labels.shape[2]:
        logits = logits[:, :, : labels.shape[2]]
    return cross_entropy_loss_placed(logits, labels, ranks)


def _frontend(batch, ranks) -> Optional[torch.Tensor]:
    """The rank's rows of the batch's ``embeds`` (a stub frontend's), or None."""
    return _group_rows(batch["embeds"], ranks) if "embeds" in batch else None


def _unshard(placement, params, ranks, cfg: ModelConfig, embeds):
    """``Placement.unshard``, leaving ``embed`` out where ``embeds`` replace
    the lookup and the head is not tied: the forward reads no table, so
    none is gathered (and ``embed`` gets no gradient)."""
    skip = ("embed",) if embeds is not None and not cfg.tie_embeddings else ()
    return placement.unshard(params, ranks, skip=skip)


def _group_rows(t: torch.Tensor, ranks) -> torch.Tensor:
    """``(B, …)`` global rows → ``(L, B/G, …)``: each local rank's row
    group's rows, the rows cut into ``G = ranks.row_groups`` blocks in
    order (the data groups, or under ``dp_over_model`` every rank)."""
    G = ranks.row_groups
    if t.shape[0] % G:
        raise ValueError(f"the batch ({t.shape[0]}) does not split over the {ranks.row_groups_in_words()}")
    return t.reshape((G, t.shape[0] // G) + tuple(t.shape[1:]))[ranks.row_group]


def _whole_logits(logits: torch.Tensor, ranks) -> torch.Tensor:
    """Each rank's ``(L, b, V/model)`` → the whole ``(B, V)``: the
    vocabulary gathered over ``model``, then the rows over ``data``; under
    ``dp_over_model`` each rank's ``(L, b, V)`` rows gathered over
    ``model``, then over ``data``.  The same in every process."""
    over_model = P.gather(logits, ranks, P.MODEL_TIER, 0 if ranks.rows_over_model else 1)
    return P.gather(over_model, ranks, P.DATA_TIER, 0)[0]


def placed_prefill(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """The last position's logits ``(B, V)`` on serve-placed parameters
    (``launch.placement.serve_placement``), whole in every process: every
    process takes the global batch, each rank its row group's rows, and
    the placed pass (``TF.forward_placed``, or the encoder-decoder's
    ``ED.encode_placed`` and ``ED.decode_placed``)."""
    placement = params.placement
    tokens = batch["tokens"]
    ranks = placement.ranks(tokens.device)
    with torch.no_grad():
        if cfg.kind == "encdec":
            whole = placement.unshard(params, ranks)
            memory = ED.encode_placed(whole, _group_rows(batch["frames"], ranks), cfg, ranks)
            logits, _ = ED.decode_placed(whole, _group_rows(tokens, ranks), memory, cfg, ranks)
        else:
            embeds = _frontend(batch, ranks)
            logits, _, _ = TF.forward_placed(_unshard(placement, params, ranks, cfg, embeds),
                                             _group_rows(tokens, ranks), cfg, ranks, frontend_embeds=embeds)
        return _whole_logits(logits[:, :, -1], ranks)


def placed_decode(params, token, caches, cfg: ModelConfig, *, memory=None):
    """One decode step on serve-placed parameters and placed caches
    (``launch.placement.cache_placement``): the global token ``(B, 1)`` in
    every process, each rank its row group's rows at their own depths
    (read from ``pos``; an encoder-decoder's ``memory`` the global ``(B,
    T, D)``, each rank its row group's rows).  Returns ``(logits (B, V)`` whole in
    every process, the new caches placed, the step's MoE drops summed over
    every rank)."""
    if getattr(caches, "placement", None) is None:
        raise ValueError("placed parameters decode on placed caches (launch.placement.cache_placement)")
    placement = params.placement
    ranks = placement.ranks(token.device)
    with torch.no_grad():
        if cfg.kind == "encdec":
            positions = caches["pos"][:, 0, :, None].to(torch.int32)  # (L, B/data, 1): the group's, layer 0's
            logits, new = ED.decode_placed(placement.unshard(params, ranks), _group_rows(token, ranks),
                                           _group_rows(memory, ranks), cfg, ranks, caches=caches, positions=positions)
            moe_drops = torch.zeros((), dtype=torch.int32, device=token.device)
        else:
            pos = _first_cache_pos(caches, (ranks.ids.shape[0], token.shape[0] // ranks.data), token.device,
                                   stacked=True)  # (L, b)
            logits, new, moe_drops = TF.forward_placed(placement.unshard(params, ranks), _group_rows(token, ranks),
                                                       cfg, ranks, caches=caches,
                                                       positions=pos[..., None].to(torch.int32))
        return _whole_logits(logits[:, :, -1], ranks), caches.like(new), moe_drops


def _first_cache_pos(caches, batch, device, *, stacked: bool = False) -> torch.Tensor:
    """(B,) current decode positions from any attention cache (all agree);
    ``stacked``: of placed caches, ``(L, b)``.  Zeros of shape ``batch``
    (``B``, or ``(L, b)`` placed) where no layer has an attention cache
    (rwkv6)."""
    lead = 1 if stacked else 0
    for c in caches["blocks"].values():
        if isinstance(c, dict) and "pos" in c:
            return c["pos"].select(lead, 0)
    for c in caches["tail"].values():
        if isinstance(c, dict) and "pos" in c:
            return c["pos"]
    return torch.zeros(batch, dtype=torch.int32, device=device)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.kind == "encdec":
        return Model(cfg, ED.encdec_defs(cfg))
    return Model(cfg, TF.model_defs(cfg))


def _tensor(a) -> torch.Tensor:
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(cfg: ModelConfig, tree, *, device=None) -> ParamTree:
    """The reference's parameter tree (nested dicts with numpy leaves, e.g.
    ``jax.tree.map(np.asarray, params)``; stacked blocks included) as the
    port's :class:`~repro_torch.models.transformer.LM` (or
    :class:`~repro_torch.models.encdec.EncDec`), bit for bit."""
    lm = _module(cfg, compat.resolve_device(device))

    def visit(m: ParamTree, t, path):
        if set(m.defs) != set(t):
            raise ValueError(f"{path or 'params'}: keys {sorted(t)} != the port's {sorted(m.defs)}")
        for name, d in m.defs.items():
            v = getattr(m, name)
            if isinstance(d, ParamDef):
                src = _tensor(t[name])
                if tuple(src.shape) != tuple(v.shape):
                    raise ValueError(f"{path}{name}: shape {tuple(src.shape)} != {tuple(v.shape)}")
                v.data.copy_(src.to(v.dtype))
            else:
                visit(v, t[name], f"{path}{name}.")

    with torch.no_grad():
        visit(lm, tree, "")
    return lm
