"""K10 ``track`` — K Woodcock (delta-tracking) steps per ray through a
Gaussian-blob density (§5.1) — with the plain version of
``repro/kernels/delta_tracking/ref.py``.

Per step k each ray still tracking draws a tentative free flight
``t ← t − log1p(−u₀)/μ̄``; it exits if ``t ≥ t_exit``, else it collides for
real if ``u₁·μ̄ < σ(o + t·d)``.  The uniforms are passed in, so both
versions are free of random state.  No app calls it: the VoPaT app steps
its walk in plain tensors, as the reference's does.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch import kernels as KN
from repro_torch.kernels import build

__all__ = ["EXITED", "HIT", "STILL", "density", "track", "track_plain"]

STILL, HIT, EXITED = 0, 1, 2

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_SIGS = {"rafi_track": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
         "rafi_track_quotients": (_P, _P, _P, _P, _I, _P)}
_MAX_BLOBS = 48 * 1024 // 32  # each blob's constants take 32 B of shared memory


def density(p: torch.Tensor, blobs: torch.Tensor) -> torch.Tensor:
    """σ(p) = Σ_g amp_g · exp(−½|p − c_g|²/s_g²) for ``p (..., 3)``, summed
    over g in index order, each |·|² as sequential adds (the kernel's
    order)."""
    out = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for g in range(blobs.shape[0]):
        d = p - blobs[g, :3]
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        out = out + blobs[g, 4] * torch.exp(-0.5 * r2 / (blobs[g, 3] * blobs[g, 3]))
    return out


def track_plain(origins, dirs, t0, t_exit, uniforms, blobs, *, majorant: float, steps: int = 8):
    """``(t (N,), status (N,) int32)`` after ``steps`` Woodcock steps.  The
    majorant is a float32 tensor, so the flight divides by it (torch on the
    card would multiply by the reciprocal of a Python scalar)."""
    maj = torch.tensor(np.float32(majorant), device=t0.device)
    t = t0
    status = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    for k in range(steps):
        active = status == STILL
        t_new = t - torch.log1p(-uniforms[:, k, 0]) / maj
        p = origins + t_new[:, None] * dirs
        dens = density(p, blobs)
        exited = active & (t_new >= t_exit)
        hit = active & ~exited & (uniforms[:, k, 1] * maj < dens)
        t = torch.where(active, t_new, t)
        status = torch.where(exited, EXITED, torch.where(hit, HIT, status)).to(torch.int32)
    return t, status


def track(origins: torch.Tensor, dirs: torch.Tensor, t0: torch.Tensor, t_exit: torch.Tensor,
          uniforms: torch.Tensor, blobs: torch.Tensor, *, majorant: float,
          steps: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: ``origins, dirs (N, 3)``, ``t0, t_exit (N,)``, ``uniforms (N, K, 2)``
    with K ≥ ``steps``, ``blobs (G, 5)`` rows (cx, cy, cz, s, amp), all
    float32 → ``(t (N,) float32, status (N,) int32)``."""
    n = origins.shape[0] if origins.dim() == 2 else -1
    if (origins.shape != (n, 3) or dirs.shape != (n, 3) or t0.shape != (n,)
            or t_exit.shape != (n,) or uniforms.dim() != 3 or uniforms.shape[0] != n
            or uniforms.shape[2] != 2 or blobs.dim() != 2 or blobs.shape[1] != 5):
        raise ValueError(
            "track takes origins, dirs (N, 3), t0, t_exit (N,), uniforms (N, K, 2), "
            f"blobs (G, 5); got {tuple(origins.shape)}, {tuple(dirs.shape)}, "
            f"{tuple(t0.shape)}, {tuple(t_exit.shape)}, {tuple(uniforms.shape)}, {tuple(blobs.shape)}"
        )
    if not 0 <= steps <= uniforms.shape[1]:
        raise ValueError(f"steps ({steps}) must be in [0, K={uniforms.shape[1]}]")
    args = (origins, dirs, t0, t_exit, uniforms, blobs)
    if any(a.dtype != torch.float32 for a in args):
        raise TypeError(f"track takes float32 tensors, got {[str(a.dtype) for a in args]}")
    if KN.use_plain(*args):
        return track_plain(*args, majorant=majorant, steps=steps)
    if blobs.shape[0] > _MAX_BLOBS:
        raise ValueError(f"track: {blobs.shape[0]} blobs exceed the kernel's {_MAX_BLOBS}")
    args = tuple(a.contiguous() for a in args)
    if args[4].data_ptr() % 8:  # the kernel reads a step's two uniforms as one 8-byte word
        args = args[:4] + (args[4].clone(),) + args[5:]
    t = torch.empty(n, dtype=torch.float32, device=t0.device)
    status = torch.empty(n, dtype=torch.int32, device=t0.device)
    lib = build.load(_SIGS)
    rc = lib.rafi_track(
        *(a.data_ptr() for a in args), t.data_ptr(), status.data_ptr(),
        n, uniforms.shape[1], steps, blobs.shape[0], float(np.float32(majorant)),
        KN.stream_handle(),
    )
    KN.check_launch(rc, "track")
    track.launches += 1
    return t, status


track.launches = 0


def _quotients(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two divisions on the card, elementwise over ``(n,)``
    float32 CUDA tensors: ``(a / b, (−0.5·a) / (b·b))`` as ``track`` computes
    ``log1p(−u₀) / μ̄`` and a blob's ``(−0.5·r²) / s²`` (``a`` as r², ``b`` as
    s).  For the tests that hold them against IEEE division; not a launch of
    ``track``."""
    a, b = a.contiguous(), b.contiguous()
    q, q_gauss = torch.empty_like(a), torch.empty_like(a)
    rc = build.load(_SIGS).rafi_track_quotients(a.data_ptr(), b.data_ptr(), q.data_ptr(),
                                                q_gauss.data_ptr(), a.numel(), KN.stream_handle())
    KN.check_launch(rc, "track quotients")
    return q, q_gauss
