"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427)
(counterpart of ``repro.models.griffin``).

The recurrent branch: x → conv1d(width 4) → RG-LRU, gated by a GeLU branch
(``jax.nn.gelu``'s tanh approximation):

    r_t = σ(W_r ξ_t)             (recurrence gate)
    i_t = σ(W_i ξ_t)             (input gate)
    a_t = exp(c·softplus(Λ)·(−r_t))        — i.e. a_t = a^{c·r_t}, a = σ(Λ)
    h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ ξ_t)

The gates and the scan run in float32 (the conv output is cast up, and the
gate weights with it, as the reference's type promotion does).  The
training scan is a loop over S steps, two launches each, where the
reference runs ``lax.scan``; decode carries (h, the conv tail of 3 inputs in
the activation dtype).

:func:`griffin_block_placed` runs the block on every local rank of a
placement (``models.parallel``), d_rnn split over ``model``: ``wa``, ``wb``,
``conv``, ``wr``, ``wi`` and ``lam`` on the rank's channels, ``wo`` on its
rows.  The gates contract over the whole ξ, so the rank's conv output is
gathered over ``model`` first (:func:`_whole_xi`); the scan and the decode
state run on the rank's channels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import parallel as P
from repro_torch.models.common import ModelConfig, ParamDef, activation
from repro_torch.models.rwkv6 import softplus

__all__ = ["CONV_W", "LRU_C", "griffin_block", "griffin_block_placed", "griffin_defs", "griffin_state"]

CONV_W = 4
LRU_C = 8.0


def griffin_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    dr = d  # lru width = d_model for recurrentgemma-2b
    return {
        "wa": ParamDef((d, dr)),
        "wb": ParamDef((d, dr)),
        "conv": ParamDef((CONV_W, dr), scale=0.5),
        "wr": ParamDef((dr, dr), scale=0.02),
        "wi": ParamDef((dr, dr), scale=0.02),
        "lam": ParamDef((dr,), init="ones"),
        "wo": ParamDef((dr, d), scale=1.0 / np.sqrt(dr)),
    }


def _lru_coeffs(params, xi):
    """xi float32; the gate weights are promoted to it."""
    r = torch.sigmoid(xi @ params["wr"].to(xi.dtype))
    i = torch.sigmoid(xi @ params["wi"].to(xi.dtype))
    log_a = -LRU_C * softplus(params["lam"]) * r  # log a_t ≤ 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xi)
    return a, gated


def _causal_conv(x, w, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width CONV_W.  x (B,S,D), w (CONV_W,D); tail
    (B,CONV_W-1,D).  On every rank of a placement: x (L,b,S,c), w
    (L,CONV_W,c), tail (L,b,CONV_W-1,c)."""
    if tail is None:
        pad = torch.zeros(x.shape[:-2] + (CONV_W - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=-2)
    s = x.shape[-2]
    tap = lambda i: w[..., i, :].reshape(w.shape[:-2] + (1,) * (x.dim() - w.dim() + 1) + w.shape[-1:])
    out = sum(xp[..., i: i + s, :] * tap(i) for i in range(CONV_W))
    return out, xp[..., -(CONV_W - 1):, :]


def _lru_scan(a, gated):
    """h_t = a_t·h_{t-1} + gated_t from h_0 = 0, step by step in float32.
    a, gated (B,S,D); returns every h_t, (B,S,D)."""
    h = torch.zeros_like(a[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + gated[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _lru_step(a, gated, h):
    """One decode step of the recurrence: a, gated (B,1,D), h (B,D)."""
    return a[:, 0] * h + gated[:, 0]


def griffin_block(params, x, cfg: ModelConfig, *, state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B,S,D).  state None → training scan; else {"h": (B,Dr), "conv": (B,3,Dr)}."""
    gate = activation(x @ params["wa"], "gelu")
    xb = x @ params["wb"]
    if state is None:
        conv, _ = _causal_conv(xb, params["conv"])
        a, gated = _lru_coeffs(params, conv.to(torch.float32))
        y = _lru_scan(a, gated).to(x.dtype)
        new_state = None
    else:
        conv, tail = _causal_conv(xb, params["conv"], state["conv"])
        a, gated = _lru_coeffs(params, conv.to(torch.float32))
        h = _lru_step(a, gated, state["h"])
        y = h[:, None].to(x.dtype)
        new_state = {"h": h, "conv": tail}
    return (gate * y) @ params["wo"], new_state


def _whole_xi(xi: torch.Tensor, ranks) -> torch.Tensor:
    """The conv output ``(L, b, S, dr/model)`` gathered whole over
    ``model`` (float32; its backward a ``reduce_scatter``): the gates
    ``xi @ wr`` and ``xi @ wi`` contract over every channel."""
    return P.gather(xi, ranks, P.MODEL_TIER, 2)


def griffin_block_placed(params, x, cfg: ModelConfig, ranks, *, state: Optional[Dict] = None
                         ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """:func:`griffin_block` on every local rank, d_rnn split over
    ``model`` (module docstring): x ``(L, b, S, D)`` whole over ``model``;
    ``state`` None → the scan over S, else the rank's ``{"h": (L, b, c),
    "conv": (L, b, CONV_W-1, c)}``, c = d_rnn/model, and one step.
    Returns ``(out (L, b, S, D)`` after the row-parallel ``psum``, the new
    state)."""
    L, b, s, _ = x.shape
    x = P.copy_model(x, ranks)
    gate = activation(P.mm(x, params["wa"]), "gelu")
    xb = P.mm(x, params["wb"])
    conv, tail = _causal_conv(xb, params["conv"], None if state is None else state["conv"])
    own = conv.to(torch.float32)
    xi = _whole_xi(own, ranks)
    r = torch.sigmoid(P.mm(xi, params["wr"].to(xi.dtype)))
    i = torch.sigmoid(P.mm(xi, params["wi"].to(xi.dtype)))
    a = torch.exp(-LRU_C * softplus(params["lam"])[:, None, None, :] * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * own)
    c = a.shape[-1]
    if state is None:
        y = _lru_scan(a.reshape(L * b, s, c), gated.reshape(L * b, s, c)).reshape(L, b, s, c).to(x.dtype)
        new_state = None
    else:
        h = _lru_step(a.reshape(L * b, 1, c), gated.reshape(L * b, 1, c), state["h"].reshape(L * b, c))
        h = h.reshape(L, b, c)
        y = h[:, :, None].to(x.dtype)
        new_state = {"h": h, "conv": tail}
    return P.psum_model(P.mm(gate * y, params["wo"]), ranks), new_state


def griffin_state(cfg: ModelConfig, batch: int, device=None) -> Dict:
    d = cfg.d_model
    return {
        "h": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_W - 1, d), dtype=torch.float32, device=device),
    }
