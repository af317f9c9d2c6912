"""Gradient compression with error feedback (counterpart of
``repro.optim.grad_compress``).

Each gradient is cast to bfloat16 (round to nearest even) after adding the
residual the last cast left behind; the new residual is what this cast
lost, so it re-enters the next step's gradient.  The reference casts before
its data-axis reduction to halve the reduced bytes; the port's ranks share
one device, so the cast keeps the reference's arithmetic and moves no wire.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.models.common import ParamTree, tree_map

__all__ = ["compress_gradients", "compress_one", "init_residuals"]


def init_residuals(params) -> Any:
    """Float32 zeros shaped like each parameter (a tree, or a ``ParamTree``)."""
    tree = params.tree() if isinstance(params, ParamTree) else params
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), tree)


def compress_one(g: Optional[torch.Tensor], r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf: ``(bf16 gradient, new residual)``; a ``None`` gradient is a zero one."""
    corrected = r.clone() if g is None else g.to(torch.float32) + r
    q = corrected.to(torch.bfloat16)
    return q, corrected - q.to(torch.float32)


def compress_gradients(grads, residuals) -> Tuple[Any, Any]:
    """bf16-compress grads with error feedback.  Returns (bf16 grads, new residuals)."""
    if isinstance(grads, dict):
        pairs = {k: compress_gradients(grads[k], residuals[k]) for k in grads}
        return {k: q for k, (q, _) in pairs.items()}, {k: r for k, (_, r) in pairs.items()}
    return compress_one(grads, residuals)
