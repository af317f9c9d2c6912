"""Encoder-decoder assembly (Seamless-M4T medium backbone, arXiv:2308.11596)
(counterpart of ``repro.models.encdec``).

The modality frontend is a stub, as in the reference: the encoder consumes
precomputed frame embeddings (B, T_enc, D).  The backbone is the
transformer pair: a bidirectional encoder (RoPE under a full mask) and a
causal decoder with cross-attention (no RoPE) to the encoder memory.  The
layers are stacked along a leading axis, as the reference's, and run one by
one where it runs ``lax.scan``; with ``cfg.remat`` and grad enabled each
layer runs under ``torch.utils.checkpoint``.

Decode: self-attention KV caches stacked over ``num_layers`` (no
blocks / tail split) plus the static encoder memory.

On placed parameters (``launch.placement``) :func:`encode_placed` and
:func:`decode_placed` run every local rank rank-stacked, activations
``(L, b, S, D)``, in either of the reference's two layouts.  Split over
``model`` (the smoke config's tensor parallelism, as the dense family):
each rank its data group's rows, the residual stream whole on every model
rank; the encoder's bidirectional attention, the decoder's causal and
cross-attention (``attention.self_attention_placed``) on the heads and
the MLP (``common.glu_mlp_placed``) on d_ff, each column-parallel in and
row-parallel out with a ``psum``; the embedding and the head over the
vocabulary.  Under ``dp_over_model`` (the full config's policy: every
weight whole on every rank, the batch rows over ``(data, model)``) the
same functions run each rank's own rows with its whole weights, and the
parallel pass issues no collective; the cached decode's self-attention
gathers the group's rows over ``model`` to meet its cache blocks, which
hold the sequence split over ``model`` (``attention.decode_rows_placed``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import parallel as P
from repro_torch.models import rope as R
from repro_torch.models import transformer as TF
from repro_torch.models.common import (
    ModelConfig, ParamDef, ParamTree, glu_mlp, glu_mlp_placed, mlp_defs, rmsnorm, stack_defs, tree_map,
)

__all__ = ["EncDec", "decode", "decode_placed", "encdec_defs", "encode", "encode_placed", "init_dec_caches"]


def encdec_defs(cfg: ModelConfig) -> Dict[str, Any]:
    enc_layer = {
        "ln1": TF._gamma(cfg), "attn": A.attn_defs(cfg),
        "ln2": TF._gamma(cfg), "mlp": mlp_defs(cfg),
    }
    dec_layer = {
        "ln1": TF._gamma(cfg), "attn": A.attn_defs(cfg),
        "lnx": TF._gamma(cfg), "xattn": A.attn_defs(cfg),
        "ln2": TF._gamma(cfg), "mlp": mlp_defs(cfg),
    }
    return {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), scale=0.02),
        "enc_blocks": stack_defs(enc_layer, cfg.encoder_layers),
        "enc_ln": TF._gamma(cfg),
        "dec_blocks": stack_defs(dec_layer, cfg.num_layers),
        "final_ln": TF._gamma(cfg),
        "lm_head": ParamDef((cfg.d_model, cfg.vocab_size), scale=0.02),
    }


def _bidir_attention(params, x, cfg: ModelConfig, positions):
    """Encoder self-attention: full (non-causal) mask."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, kv, hd)
    v = (x @ params["wv"]).reshape(b, s, kv, hd)
    cos, sin = R.rope_angles(positions, hd, cfg.rope_theta)
    q = R.apply_rope(q, cos, sin)
    k = R.apply_rope(k, cos, sin)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device)
    out = A._sdpa(q, k, v, mask, x.dtype).reshape(b, s, h * hd)
    return out @ params["wo"]


def _mlp(blk, h, cfg):
    return glu_mlp(h, blk["mlp"]["wi"], blk["mlp"]["wg"], blk["mlp"]["wo"], cfg.act)


def _enc_layer(blk, x, cfg: ModelConfig, positions):
    x = x + _bidir_attention(blk["attn"], rmsnorm(x, blk["ln1"]), cfg, positions)
    return x + _mlp(blk, rmsnorm(x, blk["ln2"]), cfg)


def _dec_layer(blk, x, memory, cfg: ModelConfig, positions, cache):
    y, nc = A.self_attention(blk["attn"], rmsnorm(x, blk["ln1"]), cfg, positions=positions, cache=cache)
    x = x + y
    x = x + A.cross_attention(blk["xattn"], rmsnorm(x, blk["lnx"]), memory, cfg)
    return x + _mlp(blk, rmsnorm(x, blk["ln2"]), cfg), nc


def _remat(fn, cfg: ModelConfig, training: bool):
    """The reference's ``jax.checkpoint(body)`` where it changes memory:
    with ``cfg.remat`` when a backward pass will follow."""
    if cfg.remat and training and torch.is_grad_enabled():
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return fn


def encode(params, frames, cfg: ModelConfig):
    """frames (B, T, D) stub embeddings → encoder memory (B, T, D)."""
    params = TF._as_tree(params)
    x = frames.to(cfg.torch_dtype)
    b, t = x.shape[:2]
    positions = torch.arange(t, device=x.device).expand(b, t)
    run = _remat(_enc_layer, cfg, True)
    for blk in TF._unstack(params["enc_blocks"], cfg.encoder_layers):
        x = run(blk, x, cfg, positions)
    return rmsnorm(x, params["enc_ln"])


def decode(params, tokens, memory, cfg: ModelConfig, *, caches: Optional[Dict] = None, positions=None):
    """Causal decoder over ``tokens`` with cross-attention to ``memory``.
    caches=None → parallel (training, prefill); else the stacked decoder KV
    caches and S == 1.  Returns (logits, new_caches)."""
    params = TF._as_tree(params)
    x = params["embed"][tokens.to(torch.int64)].to(cfg.torch_dtype)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    run = _remat(_dec_layer, cfg, caches is None)
    new = []
    for i, blk in enumerate(TF._unstack(params["dec_blocks"], cfg.num_layers)):
        x, nc = run(blk, x, memory, cfg, positions, None if caches is None else TF._index(caches, i))
        new.append(nc)
    x = rmsnorm(x, params["final_ln"])
    logits = x @ params["lm_head"].to(x.dtype)
    return logits, (None if caches is None else TF._stack(new))


# ----------------------------------------------------------------- placed

def _gain(g):
    return g[:, None, None, :]


def _mlp_placed(blk, h, cfg: ModelConfig, ranks):
    mlp = blk["mlp"]
    return glu_mlp_placed(h, mlp["wi"], mlp["wg"], mlp["wo"], cfg.act, ranks)


def _enc_layer_placed(blk, x, cfg: ModelConfig, ranks):
    y, _ = A.self_attention_placed(blk["attn"], rmsnorm(x, _gain(blk["ln1"])), cfg, ranks, causal=False)
    x = x + y
    return x + _mlp_placed(blk, rmsnorm(x, _gain(blk["ln2"])), cfg, ranks)


def _dec_layer_placed(blk, x, memory, cfg: ModelConfig, ranks, cache, positions):
    y, nc = A.self_attention_placed(blk["attn"], rmsnorm(x, _gain(blk["ln1"])), cfg, ranks, cache=cache,
                                    positions=positions)
    x = x + y
    y, _ = A.self_attention_placed(blk["xattn"], rmsnorm(x, _gain(blk["lnx"])), cfg, ranks, src=memory)
    x = x + y
    return x + _mlp_placed(blk, rmsnorm(x, _gain(blk["ln2"])), cfg, ranks), nc


def encode_placed(params, frames, cfg: ModelConfig, ranks):
    """:func:`encode` on every local rank's rows (module docstring):
    ``params`` every leaf whole over ``data``, ``(L, *block)``
    (``Placement.unshard``); ``frames`` ``(L, b, T, D)`` → the memory
    ``(L, b, T, D)``, whole on every model rank."""
    x = frames.to(cfg.torch_dtype)
    run = _remat(_enc_layer_placed, cfg, True)
    for blk in TF._unstack(params["enc_blocks"], cfg.encoder_layers, dim=1):
        x = run(blk, x, cfg, ranks)
    return rmsnorm(x, _gain(params["enc_ln"]))


def decode_placed(params, tokens, memory, cfg: ModelConfig, ranks, *, caches=None, positions=None):
    """:func:`decode` on every local rank's rows (module docstring):
    ``tokens`` ``(L, b, S)`` and ``memory`` ``(L, b, T, D)``, the rank's
    rows (its data group's, or under ``dp_over_model`` its own).  The
    embedding is ``transformer.embed_placed`` (over a vocabulary split over
    ``model``, a masked lookup and a ``psum``), the logits
    ``transformer.head_placed``'s ``(L, b, S, V/model)`` (whole ``V``
    under ``dp_over_model``).  The memory passes through ``copy_model``
    once, before the layers: each layer's column-parallel ``wk``/``wv``
    give a rank only its heads' share of the memory's gradient, and the
    copy sums it over ``model`` on its way to the encoder.
    ``caches=None``: the parallel pass.  Else one decode step (S == 1) on
    the placed caches (a stacked leaf ``(L, num_layers, …)``: ``k``/``v``
    the group's slots over the rank's block of the sequence, ``pos`` the
    group's) at ``positions`` ``(L, b_group, 1)``, the group's rows' in
    slot order.  Returns ``(logits, new_caches)``."""
    x = TF.embed_placed(params["embed"], tokens, ranks).to(cfg.torch_dtype)
    memory = P.copy_model(memory, ranks)
    run = _remat(_dec_layer_placed, cfg, caches is None)
    n = cfg.num_layers
    layer_caches = [None] * n if caches is None else TF._unstack(caches, n, dim=1)
    new = []
    for blk, cache in zip(TF._unstack(params["dec_blocks"], n, dim=1), layer_caches):
        x, nc = run(blk, x, memory, cfg, ranks, cache, positions)
        new.append(nc)
    logits = TF.head_placed(rmsnorm(x, _gain(params["final_ln"])), params["lm_head"], ranks)
    return logits, (None if caches is None else TF._stack(new, 1))


def init_dec_caches(cfg: ModelConfig, batch: int, max_len: int, device=None):
    one = A.make_cache(cfg, batch, max_len, cfg.torch_dtype, device=device)
    return tree_map(lambda a: torch.zeros((cfg.num_layers,) + tuple(a.shape), dtype=a.dtype, device=a.device), one)


class EncDec(ParamTree):
    """The encoder-decoder's parameters: ``embed``, ``enc_blocks``,
    ``enc_ln``, ``dec_blocks``, ``final_ln`` and ``lm_head``, named as the
    reference's tree (the blocks stacked over their layers); ``forward`` is
    :func:`decode` over :func:`encode`'s memory."""

    def __init__(self, cfg: ModelConfig, *, dtype=None, device=None):
        self.cfg = cfg
        super().__init__(encdec_defs(cfg), dtype=dtype or cfg.torch_dtype, device=device)

    def forward(self, frames, tokens, *, caches=None, positions=None):
        tree = self.tree()
        return decode(tree, tokens, encode(tree, frames, self.cfg), self.cfg, caches=caches, positions=positions)
