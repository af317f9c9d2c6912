"""RWKV-6 "Finch": linear attention with data-dependent decay (arXiv:2404.05892)
(counterpart of ``repro.models.rwkv6``).

Per head (dk = dv = head size), with receptance r, key k, value v,
data-dependent decay w_t ∈ (0,1) and bonus u:

    o_t = r_t · S_{t-1} + (r_t·k_t·u) v_t
    S_t = diag(w_t)·S_{t-1} + k_tᵀ v_t

Training and prefill use the chunkwise-parallel form: a (B,H,dk,dv) state is
carried over chunks of length ``CHUNK`` (a loop where the reference runs
``lax.scan``); within a chunk the output splits into an inter-chunk term (r
decayed to the chunk start times the carried state) and an intra-chunk term
with relative decays exp(c_{t-1} − c_i) for i < t, factorised around the
chunk midpoint so that each factor stays within float32 range: with the
per-step clamp ``W_MIN`` a factor reaches e^(|W_MIN|·CHUNK/2) = e^40.  Every
product of the scan therefore runs in float32, as the reference's, and the
port never turns on TF32.  Decode carries the state, one step a token.

The projections run in the model dtype; the decay's softplus and clamp come
before the cast to float32, and the scan's output is cast back before the
``g`` gate, step for step as the reference.

:func:`rwkv_block_placed` runs the block on every local rank of a placement
(``models.parallel``), the heads split over ``model``: the five projections
column-parallel (a rank's columns are H/model whole heads, head-major),
``w_bias`` and ``u`` the rank's blocks, ``wo`` row-parallel.  The chunk scan
and the decode step run as they are, on the ranks' heads side by side.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import parallel as P
from repro_torch.models.common import ModelConfig, ParamDef

__all__ = ["CHUNK", "W_MIN", "naive_scan_oracle", "rwkv_block", "rwkv_block_placed", "rwkv_defs", "rwkv_state"]

CHUNK = 32
W_MIN = -2.5  # per-step log-decay clamp: w ∈ [e^-2.5 ≈ 0.082, ~1)


def rwkv_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    h = _heads(cfg)
    return {
        "wr": ParamDef((d, d)),
        "wk": ParamDef((d, d)),
        "wv": ParamDef((d, d)),
        "ww": ParamDef((d, d), scale=0.02),
        "wg": ParamDef((d, d)),
        "wo": ParamDef((d, d), scale=1.0 / np.sqrt(d)),
        "w_bias": ParamDef((d,), init="zeros"),
        "u": ParamDef((h, d // h), scale=0.5),
    }


def _heads(cfg: ModelConfig) -> int:
    return cfg.num_heads if cfg.num_heads > 0 else cfg.d_model // 64


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    switch to the identity for large x (``F.softplus`` has one past 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _project(params, x, cfg: ModelConfig):
    d = cfg.d_model
    h = _heads(cfg)
    dh = d // h
    b, s, _ = x.shape
    r = (x @ params["wr"]).reshape(b, s, h, dh)
    k = (x @ params["wk"]).reshape(b, s, h, dh)
    v = (x @ params["wv"]).reshape(b, s, h, dh)
    logw = -softplus((x @ params["ww"]) + params["w_bias"])
    logw = torch.clamp(logw, W_MIN, -1e-4).reshape(b, s, h, dh)
    g = F.silu(x @ params["wg"])
    return r, k, v, logw, g, h, dh


def _chunk_scan(r, k, v, logw, u):
    """Chunkwise data-dependent-decay linear attention.  All (B,S,H,D),
    float32 out.  S must be a multiple of ``CHUNK`` (or at most one chunk)."""
    b, s, h, dh = r.shape
    L = min(CHUNK, s)
    if s % L:
        raise ValueError(f"seq {s} must be a multiple of chunk {L}")
    nc = s // L
    shp = (b, nc, L, h, dh)
    r, k, v, logw = (a.to(torch.float32).reshape(shp) for a in (r, k, v, logw))

    c = torch.cumsum(logw, dim=2)          # inclusive in-chunk cumulative decay
    c_prev = c - logw                      # exclusive (c_{t-1}; 0 at t=0)
    c_tot = c[:, :, -1, :, :]              # (b,nc,h,dh) total chunk decay
    m = 0.5 * c_tot[:, :, None]            # midpoint shift for float32 range

    r_in = r * torch.exp(c_prev - m)       # r_t·A_{t-1}, centred
    k_in = k * torch.exp(m - c)            # k_i/A_i, centred
    scores = torch.einsum("bnthd,bnihd->bnhti", r_in, k_in)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), diagonal=-1)  # o_t sees i < t
    scores = torch.where(mask[None, None, None], scores, 0.0)
    o = torch.einsum("bnhti,bnihd->bnthd", scores, v)
    # diagonal bonus: (r_t·k_t·u) v_t
    o = o + torch.sum(r * k * u.to(torch.float32)[None, None, None], dim=-1, keepdim=True) * v

    # inter-chunk: carry the (b,h,dk,dv) state across chunks
    r_dec = r * torch.exp(c_prev)          # decays to chunk start (≤ 1, safe)
    k_dec = k * torch.exp(c_tot[:, :, None] - c)  # decays to chunk end (≤ 1, safe)
    S = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    o_inter = []
    for n in range(nc):
        o_inter.append(torch.einsum("bthd,bhde->bthe", r_dec[:, n], S))
        S = S * torch.exp(c_tot[:, n])[..., None] + torch.einsum("bthd,bthe->bhde", k_dec[:, n], v[:, n])
    o = o + torch.stack(o_inter, dim=1)
    return o.reshape(b, s, h, dh)


def _state_step(r, k, v, logw, u, state):
    """One recurrent step (S == 1): (o (B,1,H,D) float32, new state)."""
    r1, k1, v1 = (a[:, 0].to(torch.float32) for a in (r, k, v))
    w1 = torch.exp(logw[:, 0].to(torch.float32))
    kv = torch.einsum("bhd,bhe->bhde", k1, v1)
    o = torch.einsum("bhd,bhde->bhe", r1, state) + torch.sum(
        r1 * k1 * u.to(torch.float32)[None], dim=-1, keepdim=True
    ) * v1
    return o[:, None], state * w1[..., None] + kv


def rwkv_block(params, x, cfg: ModelConfig, *, state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B,S,D).  Training / prefill (state=None): chunk scan over S.
    Decode (state (B,H,dk,dv) float32): one recurrent step, S must be 1."""
    b, s, d = x.shape
    r, k, v, logw, g, h, dh = _project(params, x, cfg)
    u = params["u"]
    if state is None:
        o = _chunk_scan(r, k, v, logw, u)
        new_state = None
    else:
        o, new_state = _state_step(r, k, v, logw, u, state)
    o = o.reshape(b, s, d).to(x.dtype) * g
    return o @ params["wo"], new_state


def _heads_side_by_side(t: torch.Tensor, dh: int) -> torch.Tensor:
    """``(L, b, S, n·dh)`` → ``(b, S, L·n, dh)``: each rank's n heads after
    the rank before's, as one tensor of heads for the scan."""
    L, b, s, _ = t.shape
    return t.reshape(L, b, s, -1, dh).permute(1, 2, 0, 3, 4).reshape(b, s, -1, dh)


def rwkv_block_placed(params, x, cfg: ModelConfig, ranks, *, state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`rwkv_block` on every local rank, the heads split over
    ``model`` (module docstring): x ``(L, b, S, D)`` whole over ``model``;
    ``state`` None → the chunk scan, else the rank's ``(L, b, H/model, dk,
    dv)`` state and one step.  Returns ``(out (L, b, S, D)`` after the
    row-parallel ``psum``, the new state)."""
    L, b, s, _ = x.shape
    dh = cfg.d_model // _heads(cfg)
    x = P.copy_model(x, ranks)
    r, k, v = (_heads_side_by_side(P.mm(x, params[n]), dh) for n in ("wr", "wk", "wv"))
    logw = -softplus(P.mm(x, params["ww"]) + params["w_bias"][:, None, None, :])
    logw = _heads_side_by_side(torch.clamp(logw, W_MIN, -1e-4), dh)
    g = F.silu(P.mm(x, params["wg"]))
    u = params["u"].reshape(-1, dh)  # (L·H/model, dh), as the heads lie
    if state is None:
        o = _chunk_scan(r, k, v, logw, u)
        new_state = None
    else:
        n = state.shape[2]
        o, new = _state_step(r, k, v, logw, u, state.transpose(0, 1).reshape((b, L * n) + state.shape[3:]))
        new_state = new.reshape((b, L, n) + state.shape[3:]).transpose(0, 1).contiguous()
    o = o.reshape(b, s, L, -1).permute(2, 0, 1, 3).to(x.dtype) * g
    return P.psum_model(P.mm(o, params["wo"]), ranks), new_state


def rwkv_state(cfg: ModelConfig, batch: int, device=None) -> torch.Tensor:
    h = _heads(cfg)
    dh = cfg.d_model // h
    return torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device)


def naive_scan_oracle(r, k, v, logw, u):
    """Step-by-step recurrence — ground truth for the chunk algorithm."""
    b, s, h, dh = r.shape
    r, k, v, logw = (a.to(torch.float32) for a in (r, k, v, logw))
    u = u.to(torch.float32)
    S = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    out = []
    for t in range(s):
        rt, kt, vt, lw = r[:, t], k[:, t], v[:, t], logw[:, t]
        kv = torch.einsum("bhd,bhe->bhde", kt, vt)
        out.append(torch.einsum("bhd,bhde->bhe", rt, S) + torch.sum(rt * kt * u[None], dim=-1, keepdim=True) * vt)
        S = S * torch.exp(lw)[..., None] + kv
    return torch.stack(out, dim=1)
