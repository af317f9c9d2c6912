"""K9 ``pairwise_accel`` — softened all-pairs gravity for the N-body app
(§5.5) — with the plain version of ``repro/kernels/nbody_forces/ref.py``.

Rank-stacked: ``xi (B, N, 3)``, ``xj (B, M, 3)`` and ``mj (B, M)`` give one
independent problem per row b, all rows in one launch.  The unbatched
``(N, 3)``, ``(M, 3)``, ``(M,)`` form of the reference is accepted too.
``G`` is folded in by the caller, as in the reference.  A zero-mass source
is inert: ``r² ≥ ε² > 0``, so its term is exactly zero.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import kernels as KN
from repro_torch.kernels import build

__all__ = ["pairwise_accel", "pairwise_accel_plain"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_SIGS = {"rafi_pairwise_accel": (_P, _P, _P, _P, _I, _I, _I, _F, _P)}
_TEMP_BYTES = 2**30  # the plain version's (chunk, M, 3) float32 temporaries
_TINY = float(np.finfo(np.float32).tiny)  # r² ≥ ε² stays a normal float


def pairwise_accel_plain(xi, xj, mj, *, eps2: float = 1e-4):
    """``a_i = Σ_j m_j (x_j − x_i) / (|x_j − x_i|² + ε²)^{3/2}``, the
    arithmetic of ``ref.pairwise_accel``, with ``(r²)^{-3/2}`` formed as
    ``(1/√r²)³``: IEEE square root and division round the same way at any
    tensor size, where torch's CPU ``pow`` has a vector and a scalar path
    that can differ by an ulp.  Targets go as many at a time as keep each
    ``(B, chunk, M, 3)`` temporary under 1 GiB; each target's sum over M is
    still one reduction over all M sources."""
    batched = xi.dim() == 3
    if not batched:
        xi, xj, mj = xi[None], xj[None], mj[None]
    b, n, m = xi.shape[0], xi.shape[1], xj.shape[1]
    rows = max(1, _TEMP_BYTES // max(1, b * m * 12))
    out = xi.new_empty(b, n, 3)
    for s in range(0, n, rows):
        dx = xj[:, None, :, :] - xi[:, s:s + rows, None, :]  # (B, c, M, 3)
        r2 = dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1] + dx[..., 2] * dx[..., 2] + eps2
        inv = 1.0 / torch.sqrt(r2)
        w = mj[:, None, :] * (inv * inv * inv)
        out[:, s:s + rows] = (w[..., None] * dx).sum(dim=2)
    return out if batched else out[0]


def _check(xi, xj, mj, eps2) -> bool:
    """Validate shapes, types and ε²; returns whether the call is batched."""
    batched = xi.dim() == 3
    lead = tuple(xi.shape[:1]) if batched else ()
    if (xi.dim() not in (2, 3) or xi.shape[-1] != 3 or xj.dim() != xi.dim()
            or tuple(xj.shape[:-2]) != lead or xj.shape[-1] != 3
            or tuple(mj.shape) != tuple(xj.shape[:-1])):
        raise ValueError(
            "pairwise_accel takes xi (B, N, 3), xj (B, M, 3), mj (B, M) or the "
            f"unbatched (N, 3), (M, 3), (M,); got {tuple(xi.shape)}, "
            f"{tuple(xj.shape)}, {tuple(mj.shape)}"
        )
    if {xi.dtype, xj.dtype, mj.dtype} != {torch.float32}:
        raise TypeError(f"pairwise_accel takes float32 tensors, got {xi.dtype}, {xj.dtype}, {mj.dtype}")
    if not eps2 >= _TINY:
        raise ValueError(f"eps2 must be a normal float32 > 0 (it keeps zero-mass padding inert), got {eps2}")
    return batched


def pairwise_accel(xi: torch.Tensor, xj: torch.Tensor, mj: torch.Tensor, *,
                   eps2: float = 1e-4) -> torch.Tensor:
    """K9: ``(B, N, 3)`` float32 accelerations (``(N, 3)`` unbatched)."""
    batched = _check(xi, xj, mj, eps2)
    if KN.use_plain(xi, xj, mj):
        return pairwise_accel_plain(xi, xj, mj, eps2=eps2)
    if not batched:
        return pairwise_accel(xi[None], xj[None], mj[None], eps2=eps2)[0]
    b, n, m = xi.shape[0], xi.shape[1], xj.shape[1]
    if b > 65535 or n >= 2**31 or m >= 2**31:
        raise ValueError(f"pairwise_accel: ({b}, {n}, {m}) exceeds the kernel's limits")
    xi, xj, mj = xi.contiguous(), xj.contiguous(), mj.contiguous()
    out = torch.empty(b, n, 3, dtype=torch.float32, device=xi.device)
    lib = build.load(_SIGS)
    rc = lib.rafi_pairwise_accel(
        xi.data_ptr(), xj.data_ptr(), mj.data_ptr(), out.data_ptr(), b, n, m,
        float(np.float32(eps2)), KN.stream_handle(),
    )
    KN.check_launch(rc, "pairwise_accel")
    pairwise_accel.launches += 1
    return out


pairwise_accel.launches = 0
