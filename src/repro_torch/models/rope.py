"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE
(counterpart of ``repro.models.rope``).

M-RoPE splits the head dimension into (temporal, height, width) sections and
rotates each with its own position stream; for the text backbone (vision
frontend stubbed) all three streams carry the text position.

Angles are float32.  ``apply_rope`` multiplies the activations by them, so a
bfloat16 ``x`` is promoted to float32 there and cast back, as JAX promotes
bf16 × f32.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["MROPE_SECTIONS", "apply_rope", "mrope_angles", "rope_angles", "rope_freqs"]

MROPE_SECTIONS = (16, 24, 24)  # qwen2-vl: t/h/w sections of head_dim/2


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) → cos/sin (..., S, head_dim/2)."""
    ang = positions[..., None].to(torch.float32) * rope_freqs(head_dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """M-RoPE: three position streams → per-section frequencies.

    positions: (..., S, 3) (t, h, w) — text-only inputs use the same value in
    all three streams."""
    freqs = rope_freqs(head_dim, theta, positions.device)  # (hd/2,)
    sizes = MROPE_SECTIONS
    if sum(sizes) != head_dim // 2:
        # scale sections proportionally for non-128 head dims
        total = head_dim // 2
        s0 = int(round(total * sizes[0] / sum(sizes)))
        s1 = int(round(total * sizes[1] / sum(sizes)))
        sizes = (s0, s1, total - s0 - s1)
    stream = torch.cat(
        [torch.full((s,), i, dtype=torch.int64, device=positions.device) for i, s in enumerate(sizes)]
    )  # (hd/2,) which position stream drives each frequency
    pos = positions[..., stream]  # (..., S, hd/2)
    ang = pos.to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) rotated pairwise; cos/sin (..., S, D/2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
