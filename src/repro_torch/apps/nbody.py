"""rafi/NBody — distributed Barnes-Hut-style N-body (§5.5), rank-stacked
(counterpart of ``repro.apps.nbody``).

The paper's multi-phase demonstration: THREE work-item types travel through
three forwarding contexts of very different capacities in every timestep
(its Listing 2, field for field):

  Particle        migration after integration (pos, vel, force, mass, uid)
  VirtualParticle the essential-tree exchange (com, mass, size, source rank)
  RefinementReq   requests for finer remote data (sender rank)

Per timestep, for all R ranks at once (a fixed number of forwarding rounds):

  1. every rank aggregates its region's monopole (centre of mass, mass, node
     size) and its 8 octant monopoles, the two-level essential tree;
  2. the roots go to every peer through the VirtualParticle context;
  3. peers apply the multipole-acceptance criterion (size > θ·dist) and send
     a RefinementReq back to the owners that are too close;
  4. owners answer each request with their 8 octants (VirtualParticle again);
  5. forces: one launch of kernel K9 for all ranks sums gravity from the
     local particles ∪ the kept roots ∪ the received octants (zero-mass
     lanes are inert);
  6. leapfrog kick-drift with reflective walls;
  7. particles migrate to ``owner(new_pos)`` through the Particle context.

Every ``forward_work`` round runs K3, K1 and K2 on the card and every
``enqueue`` K6.  The per-step totals stay on the device and are read once
at the end, as the reference's single ``jit`` returns them: the drive makes
no host sync per step.  The octant monopoles are a one-hot reduction, not a
scatter-add: deterministic on the card, where ``index_add_`` would add in
an order that changes from run to run.

Domain: [0,1]³ split into a (gx, gy, gz) rank grid (R = gx·gy·gz).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core import (
    DISCARD,
    ForwardConfig,
    StackedCollectives,
    enqueue,
    forward_work,
    make_queue,
    work_item,
)
from repro_torch.kernels.nbody_forces import ops as nb

__all__ = ["NBodyConfig", "Particle", "RefinementReq", "VirtualParticle", "oracle", "run"]


@work_item
@dataclasses.dataclass
class Particle:
    """Paper Listing 2: pos, vel, force, mass (+uid for cross-rank tracking)."""

    pos: torch.Tensor    # (3,) f32
    vel: torch.Tensor    # (3,) f32
    force: torch.Tensor  # (3,) f32
    mass: torch.Tensor   # () f32
    uid: torch.Tensor    # () i32


@work_item
@dataclasses.dataclass
class VirtualParticle:
    """Paper Listing 2: centre of mass, mass, node size (0 = leaf), source."""

    pos: torch.Tensor          # (3,) f32
    mass: torch.Tensor         # () f32
    size: torch.Tensor         # () f32
    source_rank: torch.Tensor  # () i32


@work_item
@dataclasses.dataclass
class RefinementReq:
    """Paper Listing 2: the rank requesting refinement."""

    sender_rank: torch.Tensor  # () i32


def _p_proto() -> Particle:
    z, zi = torch.zeros(()), torch.zeros((), dtype=torch.int32)
    return Particle(torch.zeros(3), torch.zeros(3), torch.zeros(3), z, zi)


def _vp_proto() -> VirtualParticle:
    z, zi = torch.zeros(()), torch.zeros((), dtype=torch.int32)
    return VirtualParticle(torch.zeros(3), z, z, zi)


def _rq_proto() -> RefinementReq:
    return RefinementReq(torch.zeros((), dtype=torch.int32))


@dataclasses.dataclass(frozen=True)
class NBodyConfig:
    """The reference's fields; its ``use_pallas`` has no counterpart (the
    tensors' device picks kernel or plain version)."""

    num_particles: int = 128
    steps: int = 4
    dt: float = 1e-3
    theta: float = 0.6  # MAC opening angle; smaller ⇒ more refinement
    g: float = 1.0
    eps2: float = 1e-3
    seed: int = 0


def _grid_dims(R: int) -> Tuple[int, int, int]:
    dims = [1, 1, 1]
    i = 0
    while R > 1:
        if R % 2:
            raise ValueError("rank count must be a power of two")
        dims[i % 3] *= 2
        R //= 2
        i += 1
    return tuple(dims)


def _owner(pos: torch.Tensor, dims) -> torch.Tensor:
    gx, gy, gz = dims
    ix = torch.clamp((pos[..., 0] * gx).to(torch.int32), 0, gx - 1)
    iy = torch.clamp((pos[..., 1] * gy).to(torch.int32), 0, gy - 1)
    iz = torch.clamp((pos[..., 2] * gz).to(torch.int32), 0, gz - 1)
    return ix + gx * (iy + gy * iz)


def _region_center(me: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centre ``(..., 3)`` of rank ``me``'s region, and the region's extent
    ``(3,)``."""
    gx, gy, gz = dims
    ix, iy, iz = me % gx, (me // gx) % gy, me // (gx * gy)
    center = torch.stack([(ix.to(torch.float32) + 0.5) / gx,
                          (iy.to(torch.float32) + 0.5) / gy,
                          (iz.to(torch.float32) + 0.5) / gz], dim=-1)
    return center, torch.tensor([1.0 / gx, 1.0 / gy, 1.0 / gz], device=me.device)


def _octant_monopoles(pos: torch.Tensor, mass: torch.Tensor, center: torch.Tensor):
    """The 8 octant ``(com (R, 8, 3), mass (R, 8))`` of each rank's region,
    by position-bit index, for ``pos (R, n, 3)``, ``mass (R, n)`` and
    ``center (R, 3)``.  A one-hot sum over the lanes, deterministic on the
    card."""
    bits = (pos >= center[:, None, :]).to(torch.int32)
    oct_id = bits[..., 0] + 2 * bits[..., 1] + 4 * bits[..., 2]
    onehot = oct_id[..., None] == torch.arange(8, device=pos.device)  # (R, n, 8)
    m_lane = torch.where(onehot, mass[..., None], 0.0)
    m_oct = m_lane.sum(dim=1)
    wx = (m_lane[..., None] * pos[:, :, None, :]).sum(dim=1)  # (R, 8, 3)
    return wx / torch.clamp(m_oct[..., None], min=1e-20), m_oct


def _initial_state(cfg: NBodyConfig, init, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(pos0 (n, 3), vel0 (n, 3), mass0 (n,))`` float32 on ``device``: the
    caller's numpy arrays, or the reference's distribution drawn with a
    ``torch.Generator`` seeded with ``cfg.seed`` (positions 0.5 ± 0.15
    clipped to [0.05, 0.95], velocities 0.05·normal, masses in [0.5, 1.5))."""
    n = cfg.num_particles
    if init is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        pos0 = torch.clamp(0.5 + 0.15 * torch.randn((n, 3), generator=gen), 0.05, 0.95)
        vel0 = 0.05 * torch.randn((n, 3), generator=gen)
        mass0 = torch.rand((n,), generator=gen) * 1.0 + 0.5
    else:
        pos0, vel0, mass0 = (torch.from_numpy(np.array(a, np.float32)) for a in init)
    for name, a, shape in (("pos0", pos0, (n, 3)), ("vel0", vel0, (n, 3)), ("mass0", mass0, (n,))):
        if tuple(a.shape) != shape:
            raise ValueError(f"init {name} must be {shape}, got {tuple(a.shape)}")
    return pos0.to(device), vel0.to(device), mass0.to(device)


def _leapfrog(pos, vel, a, dt):
    """Kick-drift with reflective walls at 0 and 1."""
    vel = vel + dt * a
    pos = pos + dt * vel
    vel = torch.where((pos < 0) | (pos > 1), -vel, vel)
    pos = torch.abs(pos)
    return 1.0 - torch.abs(1.0 - pos), vel


def run(
    cfg: NBodyConfig = NBodyConfig(),
    *,
    num_ranks: int = 8,
    init=None,
    device=None,
    comm=None,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Simulate on ``num_ranks`` stacked ranks.  Returns ``(pos (N, 3), vel
    (N, 3), stats)`` as numpy arrays in uid order; ``stats`` holds the
    per-step global particle ``totals``, the queue ``drops`` and the rank
    grid ``dims``.  ``init = (pos0, vel0, mass0)`` numpy arrays replace the
    seeded draw.  With ``comm`` a ``DistributedCollectives`` this process
    holds its block of the ranks; the final state merges over the world
    (``comm.pmin``) and the stats are the world's, the same in every
    process."""
    dev = compat.resolve_device(device)
    R, n = num_ranks, cfg.num_particles
    dims = _grid_dims(R)
    cap_p = max(64, n)       # all particles may cluster on one rank
    cap_vp = max(16, 9 * R)  # R roots + 8·R octants worst case
    cap_rq = max(8, R)
    pcfg = ForwardConfig(R, cap_p, peer_capacity=cap_p, exchange="padded")
    vcfg = ForwardConfig(R, cap_vp, peer_capacity=cap_vp, exchange="padded")
    rcfg = ForwardConfig(R, cap_rq, peer_capacity=cap_rq, exchange="padded")
    comm = StackedCollectives() if comm is None else comm
    L = comm.local_ranks(R)

    me = comm.ranks(R, dev).to(torch.int32)  # (L,) my ranks' global ids
    peers = torch.arange(R, dtype=torch.int32, device=dev)[None, :].expand(L, R)
    center, ext = _region_center(me, dims)  # (L, 3), (3,)
    node_size = torch.linalg.norm(ext)
    lane_p = torch.arange(cap_p, device=dev)
    lane_v = torch.arange(cap_vp, device=dev)
    lane_r = torch.arange(cap_rq, device=dev)
    col = lambda v, k: v[:, None].expand(L, k)

    def timestep(pq):
        pvalid = lane_p[None, :] < pq.count[:, None]
        p = pq.items
        mass = torch.where(pvalid, p.mass, 0.0)

        # ---- 1. local essential tree (root + 8 octants) ---------------------
        m_tot = mass.sum(dim=1)
        com = (mass[..., None] * p.pos).sum(dim=1) / torch.clamp(m_tot, min=1e-20)[:, None]
        oct_com, oct_m = _octant_monopoles(p.pos, mass, center)

        # ---- 2. broadcast roots (VirtualParticle context) --------------------
        roots = VirtualParticle(
            pos=com[:, None, :].expand(L, R, 3),
            mass=col(m_tot, R),
            size=node_size.expand(L, R),
            source_rank=col(me, R),
        )
        vq = make_queue(_vp_proto(), cap_vp, num_ranks=L, device=dev)
        vq = enqueue(vq, roots, peers, peers != me[:, None])
        vq, _ = forward_work(vq, vcfg, comm=comm)

        # ---- 3. MAC test → refinement requests -------------------------------
        vvalid = lane_v[None, :] < vq.count[:, None]
        vp = vq.items
        dist = torch.linalg.norm(vp.pos - center[:, None, :], dim=-1)
        too_close = vvalid & (vp.size > cfg.theta * dist) & (vp.mass > 0)
        rq = make_queue(_rq_proto(), cap_rq, num_ranks=L, device=dev)
        rq = enqueue(rq, RefinementReq(sender_rank=col(me, cap_vp)),
                     torch.where(too_close, vp.source_rank, DISCARD), vvalid)
        rq, _ = forward_work(rq, rcfg, comm=comm)

        # roots we asked to refine are replaced by their octants when they come
        refined = torch.zeros(L, R + 1, dtype=torch.bool, device=dev)
        refined.scatter_(1, torch.where(too_close, vp.source_rank, R).to(torch.int64), True)
        src = torch.clamp(vp.source_rank, 0, R - 1).to(torch.int64)
        keep_root = vvalid & ~torch.gather(refined[:, :R], 1, src)

        # ---- 4. answer requests with octants ---------------------------------
        rvalid = lane_r[None, :] < rq.count[:, None]
        octs = VirtualParticle(
            pos=oct_com.repeat(1, cap_rq, 1),
            mass=oct_m.repeat(1, cap_rq),
            size=(node_size * 0.5).expand(L, cap_rq * 8),
            source_rank=col(me, cap_rq * 8),
        )
        vq2 = make_queue(_vp_proto(), cap_vp, num_ranks=L, device=dev)
        vq2 = enqueue(vq2, octs, rq.items.sender_rank.repeat_interleave(8, dim=1),
                      rvalid.repeat_interleave(8, dim=1))
        vq2, _ = forward_work(vq2, vcfg, comm=comm)
        v2valid = lane_v[None, :] < vq2.count[:, None]

        # ---- 5. forces: local ∪ kept roots ∪ octants (one K9 launch) --------
        src_pos = torch.cat([p.pos, vp.pos, vq2.items.pos], dim=1)
        src_m = torch.cat([mass, torch.where(keep_root, vp.mass, 0.0),
                           torch.where(v2valid, vq2.items.mass, 0.0)], dim=1)
        a = cfg.g * nb.pairwise_accel(p.pos, src_pos, src_m, eps2=cfg.eps2)

        # ---- 6. leapfrog + reflective walls; 7. migration (Particle context) -
        pos, vel = _leapfrog(p.pos, p.vel, a, cfg.dt)
        moved = Particle(pos=pos, vel=vel, force=a, mass=p.mass, uid=p.uid)
        dest = torch.where(pvalid, _owner(pos, dims), DISCARD)
        out = enqueue(make_queue(_p_proto(), cap_p, num_ranks=L, device=dev), moved, dest, pvalid)
        return forward_work(out, pcfg, comm=comm)

    pos0, vel0, mass0 = _initial_state(cfg, init, dev)
    uid = torch.arange(n, dtype=torch.int32, device=dev)
    mine = _owner(pos0, dims)[None, :] == me[:, None]  # every rank draws all, keeps its own
    pq = enqueue(
        make_queue(_p_proto(), cap_p, num_ranks=L, device=dev),
        Particle(pos=pos0.expand(L, n, 3), vel=vel0.expand(L, n, 3),
                 force=torch.zeros(L, n, 3, device=dev), mass=mass0.expand(L, n), uid=uid.expand(L, n)),
        torch.where(mine, me[:, None], DISCARD),
        torch.ones(L, n, dtype=torch.bool, device=dev),
    )
    totals = []
    for _ in range(cfg.steps):
        pq, total = timestep(pq)
        totals.append(total)

    # merge the final state by uid (disjoint ownership: pmin over +inf pad)
    pvalid = lane_p[None, :] < pq.count[:, None]
    idx = torch.where(pvalid, pq.items.uid, n).to(torch.int64)[..., None].expand(L, cap_p, 3)

    def merged(x):
        buf = torch.full((L, n + 1, 3), torch.inf, device=dev)
        buf.scatter_reduce_(1, idx, torch.where(pvalid[..., None], x, torch.inf), reduce="amin")
        return comm.pmin(buf[:, :n])

    pos, vel = merged(pq.items.pos), merged(pq.items.vel)
    stats = {
        "totals": torch.stack(totals).cpu().tolist() if totals else [],
        "drops": int(comm.gather_all(pq.drops).sum()),
        "dims": dims,
    }
    return pos.cpu().numpy(), vel.cpu().numpy(), stats


def oracle(cfg: NBodyConfig = NBodyConfig(), *, init=None, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Single-device direct-sum leapfrog, the ground truth for force
    accuracy.  Forces come from K9's wrapper on ``device``: the kernel on
    the card, its plain version on the CPU."""
    dev = compat.resolve_device(device)
    pos, vel, mass = _initial_state(cfg, init, dev)
    for _ in range(cfg.steps):
        a = cfg.g * nb.pairwise_accel(pos, pos, mass, eps2=cfg.eps2)
        pos, vel = _leapfrog(pos, vel, a, cfg.dt)
    return pos.cpu().numpy(), vel.cpu().numpy()
