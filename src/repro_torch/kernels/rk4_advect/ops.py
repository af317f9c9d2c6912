"""K8 ``rk4_step`` — RK4 particle advection (§5.4) — with the plain version
of ``repro/kernels/rk4_advect/ref.py``."""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch import kernels as KN
from repro_torch.kernels import build

__all__ = ["ABC", "TAYLOR_GREEN", "TORNADO", "rk4_step", "rk4_step_plain", "velocity"]

ABC, TORNADO, TAYLOR_GREEN = 0, 1, 2

_P, _F = ctypes.c_void_p, ctypes.c_float
_SIGS = {
    "rafi_rk4_step": (_P, _P, _P, ctypes.c_int64, ctypes.c_int, _F, _F, _F, _F, _F, _F, _P),
}


def velocity(p: torch.Tensor, field_id: int, params=(1.0, 0.8, 0.6)) -> torch.Tensor:
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    a, b, c = params
    if field_id == ABC:
        return torch.stack(
            [a * torch.sin(z) + c * torch.cos(y),
             b * torch.sin(x) + a * torch.cos(z),
             c * torch.sin(y) + b * torch.cos(x)],
            dim=-1,
        )
    if field_id == TORNADO:
        r2 = x * x + y * y + 1e-3
        swirl = a / r2
        return torch.stack([-y * swirl, x * swirl, b + c * torch.sqrt(r2)], dim=-1)
    if field_id == TAYLOR_GREEN:
        return torch.stack(
            [a * torch.cos(x) * torch.sin(y) * torch.sin(z),
             -a * torch.sin(x) * torch.cos(y) * torch.sin(z),
             c * torch.sin(x) * torch.sin(y) * torch.cos(z)],
            dim=-1,
        )
    raise ValueError(f"unknown field {field_id}")


def rk4_step_plain(pos, *, dt, field_id=ABC, params=(1.0, 0.8, 0.6)):
    k1 = velocity(pos, field_id, params)
    k2 = velocity(pos + 0.5 * dt * k1, field_id, params)
    k3 = velocity(pos + 0.5 * dt * k2, field_id, params)
    k4 = velocity(pos + dt * k3, field_id, params)
    return pos + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), k1


def rk4_step(
    pos: torch.Tensor, *, dt: float, field_id: int = ABC, params=(1.0, 0.8, 0.6)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One RK4 step: ``pos (N, 3)`` float32 → ``(new_pos, velocity-at-pos)``."""
    if pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"rk4_step takes pos (N, 3), got {tuple(pos.shape)}")
    if field_id not in (ABC, TORNADO, TAYLOR_GREEN):
        raise ValueError(f"unknown field {field_id}")
    if KN.use_plain(pos):
        return rk4_step_plain(pos, dt=dt, field_id=field_id, params=params)
    if pos.dtype != torch.float32:
        raise TypeError(f"rk4_step takes float32 positions, got {pos.dtype}")
    pos = pos.contiguous()
    new_pos, vel = torch.empty_like(pos), torch.empty_like(pos)
    # the float32 constants the plain version's Python-scalar products use
    h, dt32, dt6 = (float(np.float32(v)) for v in (0.5 * dt, dt, dt / 6.0))
    a, b, c = (float(np.float32(v)) for v in params)
    lib = build.load(_SIGS)
    rc = lib.rafi_rk4_step(
        pos.data_ptr(), new_pos.data_ptr(), vel.data_ptr(), pos.shape[0],
        field_id, h, dt32, dt6, a, b, c, KN.stream_handle(),
    )
    KN.check_launch(rc, "rk4_step")
    rk4_step.launches += 1
    return new_pos, vel


rk4_step.launches = 0
