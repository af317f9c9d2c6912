"""Decoder-only LM assembly: dense / MoE / SSM / hybrid wiring
(counterpart of ``repro.models.transformer``).

Layers follow the config's repeating ``pattern`` (gemma3's 5×local +
1×global, recurrentgemma's 2×recurrent + 1×local, rwkv6's all-rwkv,
dbrx's all-MoE).  Full pattern periods are stacked along a leading
layer axis, as in the reference; where the reference runs ``lax.scan`` over
the periods, this runs a loop that indexes the stacked parameters and
caches.  Leftover layers (depth % period) run one by one.  With
``cfg.remat`` and grad enabled (training), each period runs under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of its
scan body; serving runs without grad and is untouched.

Decode state is a nested dict mirroring the block structure, stacked like
the parameters: KV caches for attention layers, (h, conv) for RG-LRU, the
(dk×dv) state for RWKV.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import griffin as G
from repro_torch.models import moe as M
from repro_torch.models import parallel as P
from repro_torch.models import rwkv6 as W
from repro_torch.models.common import (
    ModelConfig, ParamDef, ParamTree, glu_mlp, glu_mlp_placed, mlp_defs, rmsnorm, stack_defs, tree_map,
)

__all__ = ["LM", "Layer", "apply_layer", "apply_layer_placed", "embed_placed", "forward", "forward_placed", "head_placed",
           "init_caches", "layer_defs", "model_defs"]

# ----------------------------------------------------------------- defs

def _gamma(cfg):
    return ParamDef((cfg.d_model,), init="zeros")


def layer_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    d: Dict[str, Any] = {"ln1": _gamma(cfg), "ln2": _gamma(cfg)}
    if kind in ("global", "local"):
        d["attn"] = A.attn_defs(cfg)
        d["mlp"] = mlp_defs(cfg)
    elif kind == "moe":
        d["attn"] = A.attn_defs(cfg)
        d["moe"] = M.moe_defs(cfg)
    elif kind == "recurrent":
        d["rglru"] = G.griffin_defs(cfg)
        d["mlp"] = mlp_defs(cfg)
    elif kind == "rwkv":
        d["rwkv"] = W.rwkv_defs(cfg)
        d["mlp"] = mlp_defs(cfg)
    else:
        raise ValueError(kind)
    return d


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    period = len(cfg.pattern)
    n_blocks = cfg.num_layers // period
    tail = cfg.num_layers % period
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), scale=0.02),
        "final_ln": _gamma(cfg),
        "blocks": {
            f"k{j}_{kind}": stack_defs(layer_defs(cfg, kind), n_blocks)
            for j, kind in enumerate(cfg.pattern)
        },
        "tail": {
            f"k{j}_{cfg.pattern[j]}": layer_defs(cfg, cfg.pattern[j])
            for j in range(tail)
        },
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size), scale=0.02)
    return defs


# ----------------------------------------------------------------- apply

def _theta_for(cfg: ModelConfig, kind: str):
    # gemma3: local layers use the short-context base (1e4), global the long one
    if kind == "local" and cfg.rope_theta > 1e5:
        return 1e4
    return cfg.rope_theta


def apply_layer(params, x, cfg: ModelConfig, kind: str, *, positions, layout=None, cache=None):
    """One transformer layer.  Returns (x, new_cache, moe_drops)."""
    drops = torch.zeros((), dtype=torch.int32, device=x.device)
    h = rmsnorm(x, params["ln1"])
    if kind in ("global", "local", "moe"):
        window = cfg.window if kind == "local" else 0
        y, new_cache = A.self_attention(
            params["attn"], h, cfg, positions=positions, window=window,
            theta=_theta_for(cfg, kind), cache=cache,
        )
    elif kind == "recurrent":
        y, new_cache = G.griffin_block(params["rglru"], h, cfg, state=cache)
    elif kind == "rwkv":
        y, new_cache = W.rwkv_block(params["rwkv"], h, cfg, state=cache)
    else:
        raise ValueError(kind)
    x = x + y
    h = rmsnorm(x, params["ln2"])
    if kind == "moe":
        y, d = M.moe_block(params["moe"], h, cfg, layout=layout)
        drops = drops + d.to(torch.int32)
    else:
        y = glu_mlp(h, params["mlp"]["wi"], params["mlp"]["wg"], params["mlp"]["wo"], cfg.act)
    x = x + y
    return x, new_cache, drops


def _index(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _unstack(tree, n: int, dim: int = 0):
    """``n`` trees, tree i holding every leaf's view ``i`` of its axis
    ``dim`` (the leading axis; a rank-stacked leaf's layer axis is 1)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n, dim) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(tree.unbind(dim))


def _period_apply(block_params, x, cfg: ModelConfig, *, positions, layout=None, caches=None):
    """One period of the pattern (one layer of each kind).  Returns (x,
    new_caches, drops)."""
    drops = torch.zeros((), dtype=torch.int32, device=x.device)
    new_caches = {}
    for j, kind in enumerate(cfg.pattern):
        key = f"k{j}_{kind}"
        c = None if caches is None else caches.get(key)
        x, nc, d = apply_layer(block_params[key], x, cfg, kind, positions=positions, layout=layout, cache=c)
        drops = drops + d
        if nc is not None:
            new_caches[key] = nc
    return x, new_caches, drops


def _stack(trees, dim: int = 0):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], dim) for k in trees[0]}
    return torch.stack(trees, dim=dim)


def _as_tree(params):
    return params.tree() if isinstance(params, ParamTree) else params


def forward(
    params, tokens, cfg: ModelConfig, *, layout=None,
    caches: Optional[Dict] = None, positions=None, frontend_embeds=None,
):
    """tokens (B, S) integer (or ``frontend_embeds`` (B,S,D) for stub
    modalities).  caches=None → parallel pass (prefill without cache); else
    decode with S==1.  Returns (logits, new_caches, moe_drops)."""
    params = _as_tree(params)
    dtype = cfg.torch_dtype
    if frontend_embeds is not None:
        x = frontend_embeds.to(dtype)
    else:
        x = params["embed"][tokens.to(torch.int64)]
        if cfg.scale_embed:
            # the reference multiplies by a float32 numpy scalar, which
            # promotes a bfloat16 table to float32 before the cast back
            x = x.to(torch.float32) * float(np.float32(np.sqrt(cfg.d_model)))
        x = x.to(dtype)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)

    period = len(cfg.pattern)
    n_blocks = cfg.num_layers // period
    tail = cfg.num_layers % period
    total_drops = torch.zeros((), dtype=torch.int32, device=x.device)

    new_block_caches = None
    if n_blocks > 0:
        # each stacked leaf split once into its layers' views: a layer's
        # gradient lands in its own slice, not in a zero-filled copy a layer
        blocks = {key: _unstack(params["blocks"][key], n_blocks) for key in params["blocks"]}
        run = _period_apply
        if cfg.remat and caches is None and torch.is_grad_enabled():
            # the reference's jax.checkpoint(scan_body): a period keeps its
            # input and recomputes the rest in the backward pass
            run = functools.partial(checkpoint, _period_apply, use_reentrant=False)
        per_block = []
        for i in range(n_blocks):
            block_caches = None if caches is None else {k: _index(c, i) for k, c in caches["blocks"].items()}
            x, new_caches, d = run({key: blocks[key][i] for key in blocks}, x, cfg, positions=positions,
                                   layout=layout, caches=block_caches)
            total_drops = total_drops + d
            per_block.append(new_caches)
            del d  # not alive through the next period: each period holds what the one before held
        if caches is not None:
            new_block_caches = _stack(per_block)

    new_tail_caches = {}
    for j in range(tail):
        kind = cfg.pattern[j]
        key = f"k{j}_{kind}"
        c = None if caches is None else caches["tail"].get(key)
        x, nc, d = apply_layer(
            params["tail"][key], x, cfg, kind,
            positions=positions, layout=layout, cache=c,
        )
        total_drops = total_drops + d
        if nc is not None:
            new_tail_caches[key] = nc

    x = rmsnorm(x, params["final_ln"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    new_caches = (
        None if caches is None else {"blocks": new_block_caches, "tail": new_tail_caches}
    )
    return logits, new_caches, total_drops


# ----------------------------------------------------------------- placed

def apply_layer_placed(params, x, cfg: ModelConfig, kind: str, ranks, *, positions=None, cache=None):
    """:func:`apply_layer` on every local rank (``models.parallel``): x
    ``(L, b, S, D)``, the norms' gains ``(L, D)`` whole; attention, the
    RG-LRU block (``griffin.griffin_block_placed``: d_rnn over ``model``),
    the rwkv block (``rwkv6.rwkv_block_placed``: the heads over ``model``)
    and the MLP tensor-parallel over ``model``, an MoE layer's experts on
    the rank's blocks (``moe.moe_block_placed``); with ``cache`` (a rank's
    blocks: attention's sequence, griffin's channels, rwkv's heads split
    over ``model``) one decode step at ``positions`` ``(L, b, 1)``.
    Returns ``(x, new_cache, moe_drops)``."""
    gain = lambda g: g[:, None, None, :]
    h = rmsnorm(x, gain(params["ln1"]))
    if kind == "recurrent":
        y, new_cache = G.griffin_block_placed(params["rglru"], h, cfg, ranks, state=cache)
    elif kind == "rwkv":
        y, new_cache = W.rwkv_block_placed(params["rwkv"], h, cfg, ranks, state=cache)
    else:
        window = cfg.window if kind == "local" else 0
        y, new_cache = A.self_attention_placed(params["attn"], h, cfg, ranks, window=window,
                                               theta=_theta_for(cfg, kind), cache=cache, positions=positions)
    x = x + y
    h = rmsnorm(x, gain(params["ln2"]))
    if kind == "moe":
        y, drops = M.moe_block_placed(params["moe"], h, cfg, ranks)
        return x + y, new_cache, drops
    mlp = params["mlp"]
    drops = torch.zeros((), dtype=torch.int32, device=x.device)
    return x + glu_mlp_placed(h, mlp["wi"], mlp["wg"], mlp["wo"], cfg.act, ranks), new_cache, drops


def _period_placed(block_params, x, cfg: ModelConfig, ranks, caches=None, positions=None):
    new_caches = {}
    drops = torch.zeros((), dtype=torch.int32, device=x.device)
    for j, kind in enumerate(cfg.pattern):
        key = f"k{j}_{kind}"
        x, nc, d = apply_layer_placed(block_params[key], x, cfg, kind, ranks, positions=positions,
                                      cache=None if caches is None else caches[key])
        drops = drops + d
        if nc is not None:
            new_caches[key] = nc
    return x, new_caches, drops


def embed_placed(embed, tokens, ranks):
    """Each local rank's rows of the lookup of ``tokens`` ``(L, b, S)`` in
    ``embed`` ``(L, V/model, D)``, the vocabulary split over ``model``
    (rank m holds rows ``[m·V/model, …)``): a masked lookup in the rank's
    rows, then a ``psum`` over ``model`` (exact: one rank holds each
    token).  Where no weight is split over ``model`` (``dp_over_model``'s
    whole table, or one model rank) the plain lookup.  ``(L, b, S, D)`` in
    the table's dtype."""
    rows = torch.arange(tokens.shape[0], device=tokens.device).view(-1, 1, 1)
    ids = tokens.to(torch.int64)
    if not ranks.tensor_parallel:
        return embed[rows, ids]
    vm = embed.shape[1]
    ids = ids - (ranks.mrank * vm).view(-1, 1, 1)
    own = (ids >= 0) & (ids < vm)
    return P.psum_model(embed[rows, ids.clamp(0, vm - 1)].masked_fill(~own[..., None], 0), ranks)


def head_placed(x, head, ranks):
    """The logits of the final normed state ``x`` ``(L, b, S, D)``, whole
    on every model rank, through the column-parallel ``head`` ``(L, D,
    V/model)``: ``(L, b, S, V/model)``, rank m's columns ``[m·V/model,
    …)`` (``x`` through ``copy_model``, so its gradient is summed over
    ``model``)."""
    return P.mm(P.copy_model(x, ranks), head.to(x.dtype))


def forward_placed(params, tokens, cfg: ModelConfig, ranks, *, caches=None, positions=None, frontend_embeds=None):
    """:func:`forward` on every local rank of a placement, the decoder
    families (dense, MoE, hybrid, ssm; the encoder-decoder's is
    ``encdec.decode_placed``).  ``params``: every leaf whole over ``data``
    (``launch.placement.Placement.unshard``; a serve placement's already
    are), ``(L, *block)``; ``tokens`` ``(L, b, S)``, each rank's data
    group's rows.  The embedding over a vocabulary split over ``model`` is
    a masked lookup and a ``psum`` (:func:`embed_placed`);
    ``frontend_embeds`` ``(L, b, S, D)`` (qwen2-vl's vision stub, the
    rank's rows) replace it, and ``embed`` is then read only by a tied
    head.  The logits stay split: ``(L, b, S, V/model)``, rank m's columns
    ``[m·V/model, …)`` (:func:`head_placed`).  ``caches=None``: the
    parallel pass, at ``positions`` ``(L, b, S)`` or M-RoPE's ``(L, b, S,
    3)`` (None: ``0 … S-1``).  Else one decode step (S == 1) at
    ``positions`` ``(L, b, 1)`` on the rank blocks of the caches
    (``launch.placement.cache_placement``: a stacked leaf ``(L, n_blocks,
    …)``, layer i its ``[:, i]``).  Returns ``(logits, new_caches,
    moe_drops)`` as :func:`forward` does: ``new_caches`` None without
    caches, the drops the layers' sum (zero for a dense model)."""
    if frontend_embeds is not None:
        x = frontend_embeds.to(cfg.torch_dtype)
    else:
        x = embed_placed(params["embed"], tokens, ranks)
        if cfg.scale_embed:
            x = x.to(torch.float32) * float(np.float32(np.sqrt(cfg.d_model)))
        x = x.to(cfg.torch_dtype)

    n_blocks = cfg.num_layers // len(cfg.pattern)
    run = _period_placed
    if cfg.remat and caches is None and torch.is_grad_enabled():
        run = functools.partial(checkpoint, _period_placed, use_reentrant=False)
    per_block = []
    total_drops = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(n_blocks):
        block_caches = None if caches is None else {k: tree_map(lambda a: a[:, i], c)
                                                    for k, c in caches["blocks"].items()}
        x, nc, d = run({key: tree_map(lambda a: a[:, i], blk) for key, blk in params["blocks"].items()}, x, cfg,
                       ranks, block_caches, positions)
        total_drops = total_drops + d
        per_block.append(nc)
    new_tail = {}
    for j in range(cfg.num_layers % len(cfg.pattern)):
        kind = cfg.pattern[j]
        key = f"k{j}_{kind}"
        x, nc, d = apply_layer_placed(params["tail"][key], x, cfg, kind, ranks, positions=positions,
                                      cache=None if caches is None else caches["tail"][key])
        total_drops = total_drops + d
        if nc is not None:
            new_tail[key] = nc

    head = params["embed"].transpose(1, 2) if cfg.tie_embeddings else params["lm_head"]
    logits = head_placed(rmsnorm(x, params["final_ln"][:, None, None, :]), head, ranks)
    if caches is None:
        return logits, None, total_drops
    blocks = _stack(per_block, 1) if per_block else caches["blocks"]
    return logits, {"blocks": blocks, "tail": new_tail}, total_drops


# ----------------------------------------------------------------- caches

def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, device=None):
    if kind in ("global", "local", "moe"):
        return A.make_cache(cfg, batch, max_len, cfg.torch_dtype, device=device)
    if kind == "recurrent":
        return G.griffin_state(cfg, batch, device=device)
    if kind == "rwkv":
        return W.rwkv_state(cfg, batch, device=device)
    raise ValueError(kind)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None):
    period = len(cfg.pattern)
    n_blocks = cfg.num_layers // period
    tail = cfg.num_layers % period
    blocks = {
        f"k{j}_{kind}": tree_map(
            lambda a: torch.zeros((n_blocks,) + tuple(a.shape), dtype=a.dtype, device=a.device),
            _layer_cache(cfg, kind, batch, max_len, device=device),
        )
        for j, kind in enumerate(cfg.pattern)
    }
    tails = {
        f"k{j}_{cfg.pattern[j]}": _layer_cache(cfg, cfg.pattern[j], batch, max_len, device=device)
        for j in range(tail)
    }
    return {"blocks": blocks, "tail": tails}


# ----------------------------------------------------------------- modules

class Layer(ParamTree):
    """One layer's parameters (``ln1``, ``ln2``, ``attn``, ``rglru`` or
    ``rwkv``, and ``mlp`` or ``moe``), ``stack`` layers deep when ``stack`` is given; ``forward`` is
    :func:`apply_layer` on layer ``index``'s weights."""

    def __init__(self, cfg: ModelConfig, kind: str, *, stack: Optional[int] = None, dtype=None, device=None):
        defs = layer_defs(cfg, kind)
        self.cfg, self.kind = cfg, kind
        super().__init__(defs if stack is None else stack_defs(defs, stack), dtype=dtype or cfg.torch_dtype,
                         device=device)

    def child(self, name, defs, *, dtype, device):
        if name == "attn":
            return A.Attention(self.cfg, defs=defs, dtype=dtype, device=device)
        if name == "moe":
            return M.MoE(self.cfg, defs=defs, dtype=dtype, device=device)
        return ParamTree(defs, dtype=dtype, device=device)

    def forward(self, x, *, positions, layout=None, cache=None, index=None):
        return apply_layer(self.tree(index), x, self.cfg, self.kind, positions=positions, layout=layout,
                           cache=cache)


class LM(ParamTree):
    """The decoder-only model's parameters: ``embed``, ``final_ln``,
    ``blocks`` (one stacked :class:`Layer` per pattern entry), ``tail`` and
    ``lm_head``, named as the reference's tree; ``forward`` is
    :func:`forward`."""

    def __init__(self, cfg: ModelConfig, *, dtype=None, device=None):
        self.cfg = cfg
        period = len(cfg.pattern)
        self._n_blocks = cfg.num_layers // period
        super().__init__(model_defs(cfg), dtype=dtype or cfg.torch_dtype, device=device)

    def child(self, name, defs, *, dtype, device):
        if name == "blocks":
            return _Group({key: Layer(self.cfg, key.split("_", 1)[1], stack=self._n_blocks, dtype=dtype,
                                      device=device) for key in defs}, defs)
        if name == "tail":
            return _Group({key: Layer(self.cfg, key.split("_", 1)[1], dtype=dtype, device=device)
                           for key in defs}, defs)
        return ParamTree(defs, dtype=dtype, device=device)

    def forward(self, tokens, *, layout=None, caches=None, positions=None, frontend_embeds=None):
        return forward(self.tree(), tokens, self.cfg, layout=layout, caches=caches, positions=positions,
                       frontend_embeds=frontend_embeds)


class _Group(ParamTree):
    """A dict of layers (``blocks`` or ``tail``) as one submodule."""

    def __init__(self, layers: Dict[str, nn.Module], defs):
        nn.Module.__init__(self)
        self.defs = defs
        for key, layer in layers.items():
            self.add_module(key, layer)
