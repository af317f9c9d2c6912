"""rafi/StreamLines — data-parallel particle advection (§5.4), rank-stacked.

Each round, every rank advances the particles in its slab of the domain by
one RK4 step (kernel K8, one launch for all ranks), records the new position
in the particle's trace, finds the owner of the new position by projecting
it onto the slab partition, and emits the particle there.  ``forward_work``
plays ``forwardRays()``; the drive ends when no particle is alive anywhere
(or every one has used its step budget).  A particle's trajectory depends
only on its own position, so an R-rank run reproduces the single-rank
integration of :func:`oracle` bit for bit.

Domain: [0, 2π]³ with an ABC / tornado / Taylor-Green field; slab partition
along x.  Counterpart of ``repro.apps.streamlines``, whose ForwardConfig has
no ``use_pallas``, so on a TPU its forwarding never ran the marshal kernels;
here, on the card, every round runs K3, K1 and K2.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core import DISCARD, RafiContext, enqueue, make_queue, work_item
from repro_torch.kernels.rk4_advect import ops as rk4

TWO_PI = 2.0 * math.pi

__all__ = ["Particle", "StreamlineConfig", "oracle", "run"]


@work_item
@dataclasses.dataclass
class Particle:
    """§5.4: 'a unique ID … and a 3D position (float3)' (+ step counter)."""

    uid: torch.Tensor    # () i32
    pos: torch.Tensor    # (3,) f32
    steps: torch.Tensor  # () i32


def _proto() -> Particle:
    return Particle(
        uid=torch.zeros((), dtype=torch.int32),
        pos=torch.zeros(3, dtype=torch.float32),
        steps=torch.zeros((), dtype=torch.int32),
    )


@dataclasses.dataclass(frozen=True)
class StreamlineConfig:
    num_particles: int = 64
    max_steps: int = 128
    dt: float = 0.1
    field_id: int = rk4.ABC
    params: tuple = (1.0, 0.8, 0.6)
    seed: int = 0


def _owner(x: torch.Tensor, num_ranks: int) -> torch.Tensor:
    return torch.clamp((x / (TWO_PI / num_ranks)).to(torch.int32), 0, num_ranks - 1)


def _inside(p: torch.Tensor) -> torch.Tensor:
    return ((p >= 0.0) & (p <= TWO_PI)).all(dim=-1)


def _seeds(cfg: StreamlineConfig, seeds, device: torch.device) -> torch.Tensor:
    """``(N, 3)`` float32 start points: the caller's, or uniform in
    [0.5, 2π-0.5)³ from a ``torch.Generator`` seeded with ``cfg.seed``."""
    n = cfg.num_particles
    if seeds is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        lo, hi = 0.5, TWO_PI - 0.5
        seeds = torch.rand((n, 3), generator=gen, dtype=torch.float32) * (hi - lo) + lo
    if not torch.is_tensor(seeds):
        seeds = torch.from_numpy(np.array(seeds, np.float32))
    if seeds.shape != (n, 3) or seeds.dtype != torch.float32:
        raise ValueError(f"seeds must be ({n}, 3) float32, got {tuple(seeds.shape)} {seeds.dtype}")
    return seeds.to(device)


def run(
    cfg: StreamlineConfig = StreamlineConfig(),
    *,
    num_ranks: int = 8,
    exchange: str = "padded",
    seeds=None,
    device=None,
    comm=None,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Advect on ``num_ranks`` stacked ranks.  Returns ``(traces (N,
    max_steps+1, 3) with NaN padding, lengths (N,), stats)``.  With
    ``comm`` a ``DistributedCollectives`` this process holds its block of
    the ranks; the traces merge over the world (``comm.pmin``) and the
    stats are the world's, the same in every process."""
    dev = compat.resolve_device(device)
    R, n = num_ranks, cfg.num_particles
    cap = max(64, n)
    ctx = RafiContext(
        R, _proto(), capacity=cap, exchange=exchange, device=dev,
        peer_capacity=cap if exchange == "padded" else 0, comm=comm,
    )
    comm, L = ctx.comm, ctx.local_ranks
    r_idx = torch.arange(L, device=dev)[:, None].expand(L, cap)
    lane = torch.arange(cap, device=dev)

    def round_fn(q_in, traces, rnd):
        p = q_in.items
        valid = lane[None, :] < q_in.count[:, None]
        new_pos, _ = rk4.rk4_step(
            p.pos.reshape(L * cap, 3), dt=cfg.dt, field_id=cfg.field_id, params=cfg.params
        )
        new_pos = new_pos.reshape(L, cap, 3)
        steps = p.steps + 1
        # record traces[r, uid, steps] = new_pos, in place: uids are globally
        # unique, and invalid lanes write to the trash row n, cut after the run
        uid_idx = torch.where(valid, p.uid, n).to(torch.int64)
        step_idx = torch.where(valid, steps, 0).to(torch.int64)
        traces.index_put_((r_idx, uid_idx, step_idx), new_pos)
        alive = valid & _inside(new_pos) & (steps < cfg.max_steps)
        dest = torch.where(alive, _owner(new_pos[..., 0], R), DISCARD).to(torch.int32)
        out = make_queue(_proto(), cap, num_ranks=L, device=dev)
        out = enqueue(out, Particle(uid=p.uid, pos=new_pos, steps=steps), dest, valid)
        return out, traces

    start = _seeds(cfg, seeds, dev)
    uid = torch.arange(n, dtype=torch.int32, device=dev).expand(L, n)
    me = comm.ranks(R, dev).to(torch.int32)[:, None]
    # every rank computes all seeds but emits only those it owns (§5.1 ray-gen)
    mine = _owner(start[:, 0], R)[None, :] == me
    traces = torch.full((L, n + 1, cfg.max_steps + 1, 3), math.nan, device=dev)
    traces[:, :n, 0] = torch.where(mine[:, :, None], start[None], math.nan)
    q0 = enqueue(
        make_queue(_proto(), cap, num_ranks=L, device=dev),
        Particle(uid=uid, pos=start.expand(L, n, 3),
                 steps=torch.zeros(L, n, dtype=torch.int32, device=dev)),
        torch.where(mine, me, DISCARD).to(torch.int32),
        torch.ones(L, n, dtype=torch.bool, device=dev),
    )
    q, traces, rounds, _done = ctx.run_until_done(round_fn, max_rounds=cfg.max_steps + 2)(q0, traces)
    # traces are disjoint across ranks (NaN elsewhere) — merge via min
    merged = comm.pmin(torch.where(torch.isnan(traces[:, :n]), math.inf, traces[:, :n]))
    out = merged.cpu().numpy()
    out[~np.isfinite(out)] = np.nan
    lengths = np.sum(np.isfinite(out[:, :, 0]), axis=1)
    return out, lengths, {"rounds": int(rounds), "drops": int(comm.gather_all(q.drops).sum())}


def oracle(cfg: StreamlineConfig = StreamlineConfig(), *, seeds=None, device=None) -> np.ndarray:
    """Single-rank direct integration (no forwarding) — the ground truth.
    Positions are padded to the run's queue capacity, as the reference
    pads them, so the RK4 step sees the same lane count per rank."""
    dev = compat.resolve_device(device)
    n = cfg.num_particles
    cap = max(64, n)
    start = _seeds(cfg, seeds, dev)
    traces = torch.full((n, cfg.max_steps + 1, 3), math.nan, device=dev)
    traces[:, 0] = start
    pos = torch.zeros(cap, 3, device=dev)
    pos[:n] = start
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for s in range(1, cfg.max_steps + 1):
        pos, _ = rk4.rk4_step(pos, dt=cfg.dt, field_id=cfg.field_id, params=cfg.params)
        npos = pos[:n]
        traces[:, s] = torch.where(alive[:, None], npos, traces[:, s])
        alive = alive & _inside(npos)
    return traces.cpu().numpy()
