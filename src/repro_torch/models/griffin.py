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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, ParamDef, activation
from repro_torch.models.rwkv6 import softplus

__all__ = ["CONV_W", "LRU_C", "griffin_block", "griffin_defs", "griffin_state"]

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
    """Depthwise causal conv, width CONV_W.  x (B,S,D); tail (B,CONV_W-1,D)."""
    if tail is None:
        pad = torch.zeros((x.shape[0], CONV_W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i: i + x.shape[1]] * w[i][None, None, :] for i in range(CONV_W))
    return out, xp[:, -(CONV_W - 1):]


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


def griffin_state(cfg: ModelConfig, batch: int, device=None) -> Dict:
    d = cfg.d_model
    return {
        "h": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_W - 1, d), dtype=torch.float32, device=device),
    }
