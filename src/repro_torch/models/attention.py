"""GQA attention with global / local-window masks and KV caches
(counterpart of ``repro.models.attention``).

Plain PyTorch, mirroring the reference's arithmetic: scores and the
``p @ v`` product in float32 (``_sdpa``; in float64 for a float64 model,
which the tests run as a float32 decode's exact twin), or online softmax over 1,024-row
KV blocks with float32 accumulation of bfloat16 operands
(``_sdpa_blocked``, taken for a parallel pass longer than 1,024 rows).
Decode writes each row's K/V at that row's own position (serving slots sit
at different depths) and attends over its prefix.  ``cross_attention`` (the
encoder-decoder's) attends from the decoder rows to the whole encoder
memory.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import parallel as P
from repro_torch.models import rope as R
from repro_torch.models.common import ModelConfig, ParamDef, ParamTree

__all__ = [
    "Attention", "attn_defs", "causal_mask", "cross_attention", "decode_rows_placed", "make_cache", "self_attention",
    "self_attention_placed",
]


def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h * hd)),
        "wk": ParamDef((d, kv * hd)),
        "wv": ParamDef((d, kv * hd)),
        "wo": ParamDef((h * hd, d), scale=1.0 / np.sqrt(h * hd)),
    }
    if cfg.qkv_bias:
        defs.update(
            bq=ParamDef((h * hd,), init="zeros"),
            bk=ParamDef((kv * hd,), init="zeros"),
            bv=ParamDef((kv * hd,), init="zeros"),
        )
    return defs


def _split_heads(x, n, hd):
    return x.reshape(tuple(x.shape[:-1]) + (n, hd))


def _angles(cfg: ModelConfig, positions, theta=None):
    theta = theta or cfg.rope_theta
    if cfg.rope_kind == "mrope":
        if positions.dim() == 2:  # text-only: same position in all 3 streams
            positions = positions[..., None].expand(tuple(positions.shape) + (3,))
        return R.mrope_angles(positions, cfg.head_dim, theta)
    return R.rope_angles(positions, cfg.head_dim, theta)


def _sdpa(q, k, v, mask, dtype):
    """q (B,S,H,D), k/v (B,T,Hkv,D) with GQA broadcast; mask (B,S,T) or (S,T).

    Reference (materializing) attention — used for decode (S == 1) and short
    sequences; long ones go through :func:`_sdpa_blocked`."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    group = h // hkv
    qg = q.reshape(b, s, hkv, group, dh)
    wide = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(wide), k.to(wide))
    scores = scores / np.sqrt(dh)
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(wide))
    return out.reshape(b, s, h, dh).to(dtype)


BLOCK_KV = 1024


def _sdpa_blocked(q, k, v, dtype, *, causal: bool, window: int, block: int = BLOCK_KV):
    """Online-softmax attention over KV blocks — (S, T) is never
    materialised.  q (B,S,H,D); k/v (B,T,Hkv,D).  Products of the
    (bfloat16) operands accumulate in float32, as the reference's
    ``preferred_element_type=float32``: the operands are widened first,
    which is exact."""
    b, s, h, dh = q.shape
    t = k.shape[1]
    hkv = k.shape[2]
    g = h // hkv
    block = min(block, t)
    while t % block:
        block //= 2
    nb = t // block
    qg = q.reshape(b, s, hkv, g, dh).to(torch.float32)
    scale = 1.0 / np.sqrt(dh)
    q_idx = torch.arange(s, device=q.device)

    m = torch.full((b, hkv, g, s), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, s, dh), dtype=torch.float32, device=q.device)
    for j in range(nb):
        j0 = j * block
        kblk = k[:, j0:j0 + block].to(torch.float32)
        vblk = v[:, j0:j0 + block].to(torch.float32)
        srow = torch.einsum("bskgd,btkd->bkgst", qg, kblk) * scale  # (b,hkv,g,s,block)
        kv_idx = j0 + torch.arange(block, device=q.device)
        ok = torch.ones((s, block), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kv_idx[None, :] <= q_idx[:, None]
        if window > 0:
            ok &= kv_idx[None, :] > q_idx[:, None] - window
        srow = torch.where(ok[None, None, None], srow, -1e30)
        m_new = torch.maximum(m, srow.amax(dim=-1))
        p = torch.exp(srow - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(dtype).to(torch.float32), vblk
        )
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (b,hkv,g,s,dh)
    return torch.movedim(out, 3, 1).reshape(b, s, h, dh).to(dtype)


def causal_mask(s: int, window: int = 0, device=None) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window > 0:
        m &= j > i - window
    return m


def self_attention(
    params: Dict,
    x: torch.Tensor,                  # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,          # (B, S) or (B, S, 3) for mrope
    window: int = 0,
    theta: Optional[float] = None,
    cache: Optional[Dict] = None,     # {"k","v": (B,Smax,Hkv,Dh), "pos": (B,)}
) -> Tuple[torch.Tensor, Optional[Dict]]:
    b, s, d = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = _split_heads(q, h, hd)
    k = _split_heads(k, kv, hd)
    v = _split_heads(v, kv, hd)

    cos, sin = _angles(cfg, positions, theta)
    q = R.apply_rope(q, cos, sin)
    k = R.apply_rope(k, cos, sin)

    if cache is None:
        if cfg.blocked_attention and s > 1024:
            out = _sdpa_blocked(q, k, v, x.dtype, causal=True, window=window)
        else:
            out = _sdpa(q, k, v, causal_mask(s, window, x.device), x.dtype)
        new_cache = None
    else:
        # decode: s == 1; write k/v at each row's own position, attend over
        # each prefix (out of place: the caller's cache stays as it was)
        pos = cache["pos"].to(torch.int64)  # (B,)
        rows = torch.arange(b, device=x.device)
        ck = cache["k"].index_put((rows, pos), k[:, 0].to(cache["k"].dtype))
        cv = cache["v"].index_put((rows, pos), v[:, 0].to(cache["v"].dtype))
        t = ck.shape[1]
        j = torch.arange(t, device=x.device)[None, :]
        m = j <= pos[:, None]
        if window > 0:
            m &= j > (pos[:, None] - window)
        out = _sdpa(q, ck, cv, m[:, None, :], x.dtype)
        new_cache = {"k": ck, "v": cv, "pos": _advance(cache["pos"], t)}

    out = out.reshape(b, s, h * hd)
    return out @ params["wo"], new_cache


def self_attention_placed(
    params: Dict,
    x: torch.Tensor,                  # (L, b, S, D): each local rank's rows, whole on every model rank
    cfg: ModelConfig,
    ranks,                            # models.parallel.Ranks
    *,
    window: int = 0,
    theta: Optional[float] = None,
    cache: Optional[Dict] = None,     # {"k","v": (L, b, T/model, Hkv, Dh), "pos": (L, b)}
    positions: Optional[torch.Tensor] = None,  # (L, b, S) or (L, b, S, 3) for mrope; decode (L, b, 1)
    causal: bool = True,
    src: Optional[torch.Tensor] = None,        # (L, b, T, D): cross-attention's keys and values
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """:func:`self_attention` on every local rank, heads split over
    ``model``: ``wq``/``wk``/``wv`` (and their biases) column-parallel on
    the flat head×dim axis, ``wo`` row-parallel with a ``psum`` over
    ``model``.  Returns ``(out (L, b, S, D), new_cache)``.

    The parallel pass (``cache`` None) serves three uses: the causal
    self-attention (RoPE at ``positions``, None: ``0 … S-1``; M-RoPE's
    three streams where given; the ``qkv_bias``; blocked past 1,024 rows),
    the encoder's bidirectional self-attention (``causal=False``: RoPE at
    ``0 … S-1``, a full mask, no bias, as the reference's
    ``_bidir_attention``) and the decoder's cross-attention (``src``: k and
    v from the encoder memory, no RoPE, a full ``(S, T)`` mask, no bias, as
    ``cross_attention``).  ``src`` comes already through ``copy_model``
    (the caller copies the memory once for all its layers, so that its
    gradient is summed over ``model`` once).  Where ``model`` does not
    divide the kv heads (or the q heads), its flat split cuts through a
    head: k and v (or q, k and v) are gathered over ``model`` first, as
    the reference's reshard does; a rank then attends with the kv heads of
    its own q heads (or with all heads, keeping its own block of the
    output).  Under ``dp_over_model`` (``ranks.rows_over_model``: every
    weight whole, each rank its own rows) the same body runs with no
    collective.

    Decode (``cache`` given, S == 1) attends over a cache split over the
    sequence (:func:`_decode_placed`; under ``dp_over_model``
    :func:`decode_rows_placed`)."""
    if cache is not None:
        decode = decode_rows_placed if ranks.rows_over_model else _decode_placed
        return decode(params, x, cfg, ranks, cache, positions, window=window, theta=theta)
    L, b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    M = ranks.model if ranks.tensor_parallel else 1
    x = P.copy_model(x, ranks)
    q, k, v = _qkv_placed(params, x, cfg, src, bias=causal and src is None)
    t = k.shape[2]
    q_whole = h % M != 0
    kv_whole = q_whole or kv % M != 0
    if q_whole:
        q = P.gather(q, ranks, P.MODEL_TIER, 2)
    if kv_whole:
        k, v = P.gather(k, ranks, P.MODEL_TIER, 2), P.gather(v, ranks, P.MODEL_TIER, 2)
    nq = q.shape[-1] // hd
    q = _split_heads(q.reshape(L * b, s, -1), nq, hd)
    k = _split_heads(k.reshape(L * b, t, -1), k.shape[-1] // hd, hd)
    v = _split_heads(v.reshape(L * b, t, -1), v.shape[-1] // hd, hd)
    if src is None:
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(L * b, s)
        else:
            positions = positions.reshape((L * b, s) + tuple(positions.shape[3:]))
        cos, sin = _angles(cfg, positions, theta)
        q = R.apply_rope(q, cos, sin)
        k = R.apply_rope(k, cos, sin)
    if kv_whole and not q_whole:  # the kv head of each of the rank's q heads
        heads = (ranks.mrank[:, None] * nq + torch.arange(nq, device=x.device)) // (h // kv)  # (L, nq)
        idx = heads.repeat_interleave(b, dim=0)[:, None, :, None].expand(L * b, t, nq, hd)
        k, v = torch.gather(k, 2, idx), torch.gather(v, 2, idx)
    if not causal or src is not None:
        out = _sdpa(q, k, v, torch.ones((s, t), dtype=torch.bool, device=x.device), x.dtype)
    elif cfg.blocked_attention and s > BLOCK_KV:
        out = _sdpa_blocked(q, k, v, x.dtype, causal=True, window=window)
    else:
        out = _sdpa(q, k, v, causal_mask(s, window, x.device), x.dtype)
    out = out.reshape(L, b, s, nq * hd)
    if q_whole:
        out = P.pick_model(out, ranks)
    return P.psum_model(P.mm(out, params["wo"]), ranks), None


def _qkv_placed(params, x, cfg, src=None, *, bias=True):
    """Each rank's columns of q (from ``x``), k and v (from ``src``, None:
    ``x``): the column-parallel products, with the ``qkv_bias`` where
    ``bias``."""
    src = x if src is None else src
    q, k, v = P.mm(x, params["wq"]), P.mm(src, params["wk"]), P.mm(src, params["wv"])
    if bias and cfg.qkv_bias:
        q, k, v = (t + params[n][:, None, None, :] for t, n in ((q, "bq"), (k, "bk"), (v, "bv")))
    return q, k, v


def _advance(pos: torch.Tensor, length: int) -> torch.Tensor:
    """A decode step's next positions: one on, held at the cache's last
    position ``length - 1``."""
    return torch.clamp(pos + 1, max=length - 1)


def _combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, ranks) -> torch.Tensor:
    """The softmax-weighted sum over a sequence split over ``model``, from
    each rank's float32 partials over its positions: the local max ``m``
    and sum of exponentials ``l`` ``(..., 1)``, the weighted sum of v
    ``acc`` ``(..., Dh)``.  The group max is found by a gather of the
    maxima; each rank's partials are rescaled by ``exp(m - max)`` (a block
    with no live position, every score at -1e30, adds exactly 0), one
    ``psum`` over ``model`` sums them (a decode step's: no gradient), and
    the output is their quotient."""
    if ranks.model > 1:
        top = ranks.comm.all_gather(m, digits=ranks.digits, tier=P.MODEL_TIER).amax(dim=1)
        scale = torch.exp(m - top)
        parts = ranks.comm.psum(torch.cat([acc * scale, l * scale], dim=-1), digits=ranks.digits,
                                tier=P.MODEL_TIER)
        acc, l = parts[..., :-1], parts[..., -1:]
    return acc / l


def _decode_placed(params, x, cfg: ModelConfig, ranks, cache, positions, *, window: int, theta):
    """One decode step's attention on every local rank, the cache split
    over the sequence (:func:`_decode_core`), heads split over ``model``:
    the new token's q, k and v gathered whole over ``model`` (q in one
    call, k and v in one), then each rank keeps its own columns of the
    flat head×dim axis for the row-parallel ``wo``."""
    q, k, v = _qkv_placed(params, P.copy_model(x, ranks), cfg)
    q = P.gather(q, ranks, P.MODEL_TIER, 2)                                   # (L, b, 1, h·hd)
    kvn = P.gather(torch.stack([k, v], dim=3), ranks, P.MODEL_TIER, 3)        # (L, b, 1, 2, kv·hd)
    out, new_cache = _decode_core(q, kvn[:, :, :, 0], kvn[:, :, :, 1], cfg, ranks, cache, positions, window=window,
                                  theta=theta, dtype=x.dtype)
    return P.psum_model(P.mm(P.pick_model(out, ranks), params["wo"]), ranks), new_cache


def _gather_rows(t: torch.Tensor, ranks) -> torch.Tensor:
    """``(L, b/M, …)`` each rank's own rows → ``(L, b, …)`` its data
    group's rows in slot order: model rank m's rows are the group's
    ``[m·b/M, (m+1)·b/M)``, as ``P(('data', 'model'))`` cuts them."""
    return P.gather(t, ranks, P.MODEL_TIER, 0)


def decode_rows_placed(params, x, cfg: ModelConfig, ranks, cache, positions, *, window: int = 0, theta=None):
    """One decode step's self-attention on every local rank under
    ``dp_over_model``: the weights whole on every rank, rank ``(g, m)``'s
    rows ``x`` ``(L, b/M, 1, D)`` its own block ``[m·b/M, (m+1)·b/M)`` of
    group g's b slots, but its cache block positions ``[m·T/M,
    (m+1)·T/M)`` of all b slots (the rows and the cache do not line up).
    q, k and v of the rank's rows are gathered over ``model`` on the rows
    (one call), giving the group's b rows in slot order; the sequence-split
    core (:func:`_decode_core`) runs every head over the rank's block at
    ``positions`` ``(L, b, 1)``, the group's; each rank keeps its own rows
    of the output and applies the whole ``wo`` (no ``psum``).  Returns
    ``(out (L, b/M, 1, D), new_cache)``."""
    L, r = x.shape[:2]
    q, k, v = _qkv_placed(params, x, cfg)
    widths = (q.shape[-1], k.shape[-1], v.shape[-1])
    q, k, v = _gather_rows(torch.cat([q, k, v], dim=-1), ranks).split(widths, dim=-1)
    out, new_cache = _decode_core(q, k, v, cfg, ranks, cache, positions, window=window, theta=theta, dtype=x.dtype)
    own = out.reshape((L, ranks.model, r) + tuple(out.shape[2:]))[torch.arange(L, device=x.device), ranks.mrank]
    return P.mm(own, params["wo"]), new_cache


def _decode_core(q, k, v, cfg: ModelConfig, ranks, cache, positions, *, window: int, theta, dtype):
    """The sequence-split core of a decode step: q ``(L, b, 1, h·hd)``, k
    and v ``(L, b, 1, kv·hd)`` of the group's b slots, whole on every
    model rank; rank ``(g, m)``'s cache holds positions ``[m·T/M,
    (m+1)·T/M)`` of those slots.  q and k are RoPE'd at each row's own
    position (``positions`` ``(L, b, 1)``), k and v written by the rank
    whose block holds the row's position (out of place).  Each rank scores
    every head over its positions (GQA grouped as in :func:`_sdpa`),
    masked on the global index (``j ≤ pos``, the window), keeps float32
    partials, and :func:`_combine` joins the ranks.  Returns ``(out (L, b,
    1, h·hd)`` in ``dtype``, whole on every model rank, the new cache)."""
    L, b, s = q.shape[:3]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = q.device
    cos, sin = _angles(cfg, positions.reshape(L * b, s), theta)
    q = R.apply_rope(_split_heads(q.reshape(L * b, s, -1), h, hd), cos, sin)
    k = R.apply_rope(_split_heads(k.reshape(L * b, s, -1), kv, hd), cos, sin)
    v = _split_heads(v.reshape(L * b, s, -1), kv, hd)

    ck, cv = cache["k"], cache["v"]
    tm = ck.shape[2]
    length = tm * ranks.model
    pos = cache["pos"].to(torch.int64)                                        # (L, b)
    first = (ranks.mrank * tm)[:, None]                                       # (L, 1)
    local = pos - first
    inside = ((local >= 0) & (local < tm))[..., None, None]
    at = (torch.arange(L, device=dev)[:, None].expand(L, b), torch.arange(b, device=dev)[None, :].expand(L, b),
          local.clamp(0, tm - 1))
    ck = ck.index_put(at, torch.where(inside, k.reshape(L, b, kv, hd).to(ck.dtype), ck[at]))
    cv = cv.index_put(at, torch.where(inside, v.reshape(L, b, kv, hd).to(cv.dtype), cv[at]))

    qg = q.reshape(L, b, kv, h // kv, hd).to(torch.float32)
    scores = torch.einsum("lbkgd,lbtkd->lbkgt", qg, ck.to(torch.float32)) / np.sqrt(hd)
    j = first + torch.arange(tm, device=dev)[None, :]                         # (L, T/M) global index
    live = j[:, None, :] <= pos[:, :, None]                                   # (L, b, T/M)
    if window > 0:
        live &= j[:, None, :] > pos[:, :, None] - window
    scores = torch.where(live[:, :, None, None, :], scores, -1e30)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    acc = torch.einsum("lbkgt,lbtkd->lbkgd", p, cv.to(torch.float32))
    out = _combine(m, p.sum(dim=-1, keepdim=True), acc, ranks).reshape(L, b, s, h * hd).to(dtype)
    return out, {"k": ck, "v": cv, "pos": _advance(cache["pos"], length)}


def cross_attention(
    params: Dict,
    x: torch.Tensor,                  # (B, S, D) decoder states
    memory: torch.Tensor,             # (B, T, D) encoder output
    cfg: ModelConfig,
) -> torch.Tensor:
    """Every decoder row attends to every encoder row; no RoPE, no bias."""
    b, s, d = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ params["wq"], h, hd)
    k = _split_heads(memory @ params["wk"], kv, hd)
    v = _split_heads(memory @ params["wv"], kv, hd)
    t = memory.shape[1]
    mask = torch.ones((s, t), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask, x.dtype).reshape(b, s, h * hd)
    return out @ params["wo"]


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device=None) -> Dict:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


class Attention(ParamTree):
    """The attention parameters (``wq``, ``wk``, ``wv``, ``wo`` and the
    biases), ``stack`` layers deep when stacked; ``forward`` is
    :func:`self_attention` on layer ``index``'s weights."""

    def __init__(self, cfg: ModelConfig, *, defs=None, dtype=None, device=None):
        super().__init__(attn_defs(cfg) if defs is None else defs, dtype=dtype or cfg.torch_dtype, device=device)
        self.cfg = cfg

    def forward(self, x, *, positions, window=0, theta=None, cache=None, index=None):
        return self_attention(self.tree(index), x, self.cfg, positions=positions, window=window,
                              theta=theta, cache=cache)
