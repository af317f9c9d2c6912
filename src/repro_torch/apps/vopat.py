"""VoPaT — data-parallel volume path tracer on the forwarding core (§5.1),
rank-stacked (counterpart of ``repro.apps.vopat``).

The wavefront of the paper's Fig. 1:

  1. every rank holds the same slab partition (the "proxies") and generates
     a disjoint share of the primary rays;
  2. per round, every ray advances by ONE Woodcock event:
     * no pending flight → draw a tentative free flight from the global
       majorant (one RNG event, keyed by (pixel, events), so the walk is the
       same at any rank count);
     * the flight ends inside the slab → acceptance test: a real collision
       scatters isotropically (with albedo Russian roulette) and re-emits to
       the same rank; a null collision re-arms from the new position;
     * the flight crosses a slab face → the ray moves to the face and is
       forwarded to the neighbour rank carrying its remaining flight;
     * leaving [0,1]³ → deposit throughput·sky into the rank's framebuffer
       and terminate;
  3. ``forward_work`` moves the rays; ``run_until_done`` repeats until the
     global in-flight count is zero (§4.2.3);
  4. the per-rank framebuffers are summed (the distributed frame buffer):
     one ``psum`` of the collective layer.

The uniforms come from ``apps.rng``, bit-equal to the reference's
``jax.random`` draws.  With spp=1 every pixel receives one deposit, so an
R-rank render equals the 1-rank render bit for bit, and the scatter marshal
equals the sort marshal.  With ``comm=`` a ``DistributedCollectives`` each
process generates and traces the rays of its block of ranks, and the
merge's ``psum`` sums the gathered frame buffers in the stacked order, so a
world's image equals the stacked image bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.apps import fields as F
from repro_torch.apps import rng
from repro_torch.core import DISCARD, RafiContext, enqueue, make_queue, work_item
from repro_torch.telemetry import stats as TS

__all__ = ["PathRay", "VopatScene", "render"]


@work_item
@dataclasses.dataclass
class PathRay:
    """Forwardable path state: 11 leaves, 15 words (60 B) on the wire.  (The
    reference's docstring calls it 44-byte, after the paper's Fig-8 ray;
    its 3-float origin and direction make it 60.)"""

    origin: torch.Tensor      # (3,) f32 current path-segment origin
    dir: torch.Tensor         # (3,) f32
    t: torch.Tensor           # () f32 current param along segment
    t_tgt: torch.Tensor       # () f32 pending tentative-collision param
    u2: torch.Tensor          # () f32 carried acceptance uniform
    throughput: torch.Tensor  # () f32
    pixel: torch.Tensor       # () i32
    events: torch.Tensor      # () i32 RNG event counter
    bounces: torch.Tensor     # () i32
    slab: torch.Tensor        # () i32 current slab index
    in_flight: torch.Tensor   # () i32 pending flight valid?


def _proto() -> PathRay:
    z, zi = torch.zeros(()), torch.zeros((), dtype=torch.int32)
    return PathRay(torch.zeros(3), torch.zeros(3), z, z, z, z, zi, zi, zi, zi, zi)


@dataclasses.dataclass(frozen=True)
class VopatScene:
    width: int = 64
    height: int = 64
    spp: int = 1
    albedo: float = 0.8
    max_bounces: int = 3
    seed: int = 0
    num_blobs: int = 6


def _round_fn(q_in, fb, rnd, *, part: F.SlabPartition, blobs, mu, key, scene, cap, me):
    del rnd
    r = q_in.items
    lane = torch.arange(cap, device=fb.device)
    valid = lane[None, :] < q_in.count[:, None]

    # --- arm pending flights (one RNG event) -------------------------------
    draw = valid & (r.in_flight == 0)
    u = rng.event_uniforms(key, r.pixel, r.events, 2)
    t_tgt = torch.where(draw, r.t - torch.log1p(-u[..., 0]) / mu, r.t_tgt)
    u2 = torch.where(draw, u[..., 1], r.u2)
    events = r.events + draw.to(torch.int32)

    # --- slab geometry ------------------------------------------------------
    lo, hi = part.bounds(r.slab)
    t_exit, axis, pos_side = F.ray_box_exit(r.origin, r.dir, r.t, lo, hi)
    arrives = valid & (t_tgt <= t_exit)
    crosses = valid & ~arrives

    # --- arrivals: acceptance test ------------------------------------------
    p_tgt = r.origin + t_tgt[..., None] * r.dir
    dens = F.density(p_tgt, blobs)
    hit = arrives & (u2 * mu < dens)
    null = arrives & ~hit

    # --- real collisions: Russian-roulette scatter (one RNG event) ----------
    su = rng.event_uniforms(key, r.pixel, events, 3)
    events = events + hit.to(torch.int32)
    absorbed = hit & (su[..., 2] >= scene.albedo)
    exhausted = hit & ~absorbed & (r.bounces + 1 > scene.max_bounces)
    scattered = hit & ~absorbed & ~exhausted
    z = 1.0 - 2.0 * su[..., 0]
    phi = 2.0 * math.pi * su[..., 1]
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    new_dir = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)

    # --- boundary crossings --------------------------------------------------
    next_slab = r.slab + torch.where(pos_side, 1, -1).to(torch.int32)
    stays_in = (next_slab >= 0) & (next_slab < part.num_slabs)
    to_neighbor = crosses & (axis == 0) & stays_in
    escapes = crosses & ~((axis == 0) & stays_in)

    # --- terminal deposits ----------------------------------------------------
    F.deposit(fb, r.pixel, r.throughput * F.sky(r.dir), escapes)

    # --- assemble next-round rays ---------------------------------------------
    alive = null | scattered | to_neighbor
    new = PathRay(
        origin=torch.where(scattered[..., None], p_tgt, r.origin),
        dir=torch.where(scattered[..., None], new_dir, r.dir),
        t=torch.where(scattered, 0.0, torch.where(null, t_tgt, t_exit)),
        t_tgt=t_tgt,
        u2=u2,
        throughput=r.throughput,
        pixel=r.pixel,
        events=events,
        bounces=r.bounces + scattered.to(torch.int32),
        slab=torch.where(to_neighbor, next_slab, r.slab),
        in_flight=to_neighbor.to(torch.int32),
    )
    dest = torch.where(
        to_neighbor, part.owner_of_slab(next_slab), torch.where(alive, me, DISCARD)
    ).to(torch.int32)
    out = make_queue(_proto(), cap, num_ranks=q_in.num_ranks, device=fb.device)
    return enqueue(out, new, dest, alive), fb


def _raygen(*, part, scene, cap, num_ranks, me, device):
    """Per-rank primary rays (disjoint pixel ranges) + direct sky for
    misses, for the ranks of ``me`` (``(L, 1)`` global ids).  Returns
    ``(q0, fb (L, HW + F.TRASH_PIXELS))``."""
    R, L, hw_px = num_ranks, me.shape[0], scene.width * scene.height
    ppr = (hw_px * scene.spp) // R
    pix = me * ppr + torch.arange(ppr, dtype=torch.int32, device=device)  # (R, ppr)
    o_all, d_all = F.camera_rays(scene.width, scene.height, device=device)
    px = (pix // scene.spp) % hw_px
    o, d = o_all[px.to(torch.int64)], d_all[px.to(torch.int64)]
    t_entry, hits = F.ray_domain_entry(o, d)

    fb = torch.zeros(L, hw_px + F.TRASH_PIXELS, dtype=torch.float32, device=device)
    F.deposit(fb, pix // scene.spp, torch.where(hits, 0.0, F.sky(d)), torch.ones_like(hits))

    p_in = o + (t_entry[..., None] + 1e-4) * d
    slab = part.slab_of(torch.clamp(p_in[..., 0], 0.0, 1.0 - 1e-6))
    z = torch.zeros(L, ppr, device=device)
    zi = torch.zeros(L, ppr, dtype=torch.int32, device=device)
    rays = PathRay(
        origin=o, dir=d, t=t_entry, t_tgt=z, u2=z, throughput=torch.ones_like(z),
        pixel=(pix // scene.spp).to(torch.int32),
        events=(pix % scene.spp) * (1 << 20) + zi,
        bounces=zi, slab=slab, in_flight=zi,
    )
    dest = torch.where(hits, part.owner_of_slab(slab), DISCARD).to(torch.int32)
    q0 = make_queue(_proto(), cap, num_ranks=L, device=device)
    return enqueue(q0, rays, dest, torch.ones_like(hits)), fb


def render(
    scene: VopatScene = VopatScene(),
    *,
    num_ranks: int,
    blobs=None,
    max_rounds: int = 512,
    exchange: str = "padded",
    marshal: str = "sort",
    telemetry: bool = False,
    telemetry_window: int = 32,
    device=None,
    comm=None,
) -> Tuple[np.ndarray, dict]:
    """Distributed render on ``num_ranks`` stacked ranks.  Returns ``(image
    (H, W) float32, stats)``; stats hold rounds, drops, the majorant and the
    queue capacity.  With ``telemetry`` the drive carries the flight
    recorder's ring and stats gain ``"telemetry"``, its
    ``telemetry.summarize`` (per-tier demand histogram and max, clamp
    drops): the measured basis for sizing the queues below their §6.3
    worst case.  ``device=None`` is the CUDA card.  With ``comm`` a
    ``DistributedCollectives`` this process holds its block of the ranks;
    the image and the stats are the world's, the same in every process."""
    dev = compat.resolve_device(device)
    R = num_ranks
    if blobs is None:
        blobs = F.default_blobs(scene.num_blobs, scene.seed)
    blobs = torch.as_tensor(np.asarray(blobs, np.float32), device=dev)
    mu = F.majorant(blobs)
    part = F.SlabPartition(num_slabs=R, num_ranks=R)
    hw = scene.width * scene.height * scene.spp
    # worst-case wavefront (§6.3): the whole frustum can enter one slab
    cap = max(256, hw)
    ctx = RafiContext(
        R, _proto(), capacity=cap, exchange=exchange, marshal=marshal, device=dev,
        peer_capacity=cap if exchange == "padded" else 0,
        telemetry=telemetry, telemetry_window=telemetry_window, comm=comm,
    )
    comm = ctx.comm
    key = rng.key_from_seed(scene.seed, device=dev)
    me = comm.ranks(R, dev).to(torch.int32)[:, None]
    round_fn = partial(_round_fn, part=part, blobs=blobs, mu=mu, key=key, scene=scene, cap=cap, me=me)

    q0, fb = _raygen(part=part, scene=scene, cap=cap, num_ranks=R, me=me, device=dev)
    q, fb, rounds, _done, *ring = ctx.run_until_done(round_fn, max_rounds=max_rounds)(q0, fb)
    img = comm.psum(fb)[:-F.TRASH_PIXELS]  # the distributed frame buffer's reduce
    img = img.cpu().numpy().reshape(scene.height, scene.width) / scene.spp
    stats = {"rounds": int(rounds), "drops": int(comm.gather_all(q.drops).sum()), "majorant": mu, "capacity": cap}
    if telemetry:
        stats["telemetry"] = TS.summarize(comm.gather_tree(ring[0]), tier_capacities=TS.tier_capacities(ctx.cfg))
    return img, stats
