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
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import rope as R
from repro_torch.models import transformer as TF
from repro_torch.models.common import ModelConfig, ParamDef, ParamTree, glu_mlp, mlp_defs, rmsnorm, stack_defs, tree_map

__all__ = ["EncDec", "decode", "encdec_defs", "encode", "init_dec_caches"]


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
