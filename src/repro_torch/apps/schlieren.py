"""SchlieRaFI — data-parallel Schlieren renderer (§5.3), rank-stacked
(counterpart of ``repro.apps.schlieren``).

Straight-ray Schlieren (Yates' formulation): each ray integrates the
projected density gradient along its path,

    I_u = ∫ (∇σ(p) · u) ds      I_v = ∫ (∇σ(p) · v) ds

where (u, v) are the camera's right/up axes.  A *knife edge* then filters
the integral into an image — a "U" knife edge emphasizes horizontal
gradients, "V" vertical ones (paper Fig. 5).

The forwarded state mirrors the paper's Listing 1 (FWDRay: origin,
direction, restart parameter, pixelID, partial integral): rays march a
globally aligned sample grid through the slab partition and forward
themselves at partition boundaries carrying their partial integrals,
through ``RafiContext.run_until_done`` (K3, K1, K2 every round, K6 under
every ``enqueue``).  The two integrals land in two rank-stacked frame
buffers, summed over the rank axis at the end (one ``psum`` of the
collective layer); the sums are sequential (``apps.fields``), so an R-rank
render equals the 1-rank render bit for bit.  With ``comm=`` a
``DistributedCollectives`` each process traces the rays of its block of
ranks and the ``psum`` sums the gathered frame buffers in the stacked
order: a world's images equal the stacked images bit for bit.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.apps import fields as F
from repro_torch.core import DISCARD, RafiContext, enqueue, make_queue, work_item

__all__ = ["SchlierenRay", "SchlierenScene", "render"]

MARCH_PER_ROUND = 32


@work_item
@dataclasses.dataclass
class SchlierenRay:
    """Paper Listing 1's FWDRay, adapted: two knife-edge partial integrals;
    8 leaves, 12 words (48 B) on the wire."""

    origin: torch.Tensor   # (3,) f32
    dir: torch.Tensor      # (3,) f32
    t_entry: torch.Tensor  # () f32 "restart parameter" analogue (grid anchor)
    k: torch.Tensor        # () i32 next sample index
    pixel: torch.Tensor    # () i32 framebuffer index
    slab: torch.Tensor     # () i32
    iu: torch.Tensor       # () f32 accumulated u-gradient integral
    iv: torch.Tensor       # () f32 accumulated v-gradient integral


def _proto() -> SchlierenRay:
    z, zi = torch.zeros(()), torch.zeros((), dtype=torch.int32)
    return SchlierenRay(torch.zeros(3), torch.zeros(3), z, zi, zi, zi, z, z)


@dataclasses.dataclass(frozen=True)
class SchlierenScene:
    width: int = 32
    height: int = 32
    num_slabs: int = 32
    samples_per_slab: int = 8
    gain: float = 0.15
    seed: int = 2
    num_blobs: int = 6


def _camera_axes(device=None):
    """The camera's (right, up) axes, ``(3,)`` float32 each."""
    fwd = torch.tensor([1.0, 0.0, 0.0], device=device)
    up0 = torch.tensor([0.0, 0.0, 1.0], device=device)
    right = torch.linalg.cross(fwd, up0)
    right = right / torch.linalg.norm(right)
    return right, torch.linalg.cross(right, fwd)


def _dot(g: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    return g[..., 0] * axis[0] + g[..., 1] * axis[1] + g[..., 2] * axis[2]


def _round_fn(q_in, fb2, rnd, *, part, blobs, ds, cap, right, up, me):
    del rnd
    fb_u, fb_v = fb2
    r = q_in.items
    lane = torch.arange(cap, device=fb_u.device)
    valid = lane[None, :] < q_in.count[:, None]

    lo, hi = part.bounds(r.slab)
    t_cur = r.t_entry + r.k.to(torch.float32) * ds
    t_exit, axis, pos_side = F.ray_box_exit(r.origin, r.dir, t_cur, lo, hi)

    k, iu, iv = r.k, r.iu, r.iv
    for _ in range(MARCH_PER_ROUND):
        t_k = r.t_entry + (k.to(torch.float32) + 0.5) * ds
        inside = t_k < t_exit
        g = F.density_gradient(r.origin + t_k[..., None] * r.dir, blobs)
        iu = torch.where(inside, iu + _dot(g, right) * ds, iu)
        iv = torch.where(inside, iv + _dot(g, up) * ds, iv)
        k = k + inside.to(torch.int32)
    t_next = r.t_entry + (k.to(torch.float32) + 0.5) * ds
    done_seg = t_next >= t_exit

    next_slab = r.slab + torch.where(pos_side, 1, -1).to(torch.int32)
    stays = (next_slab >= 0) & (next_slab < part.num_slabs) & (axis == 0)
    finish = valid & done_seg & ~stays
    cross = valid & done_seg & stays
    again = valid & ~done_seg

    F.deposit(fb_u, r.pixel, iu, finish)
    F.deposit(fb_v, r.pixel, iv, finish)

    new = SchlierenRay(
        origin=r.origin, dir=r.dir, t_entry=r.t_entry, k=k, pixel=r.pixel,
        slab=torch.where(cross, next_slab, r.slab), iu=iu, iv=iv,
    )
    alive = cross | again
    dest = torch.where(cross, part.owner_of_slab(next_slab), torch.where(again, me, DISCARD)).to(torch.int32)
    out = make_queue(_proto(), cap, num_ranks=q_in.num_ranks, device=fb_u.device)
    return enqueue(out, new, dest, alive), (fb_u, fb_v)


def render(
    scene: SchlierenScene = SchlierenScene(),
    *,
    num_ranks: int,
    blobs=None,
    max_rounds: int = 4096,
    exchange: str = "padded",
    device=None,
    comm=None,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Returns ``(knife_u image, knife_v image, stats)`` — paper Fig. 5's
    pair; stats hold rounds, drops and ``raw``, the ``(H·W, 2)`` float32
    integrals.  ``device=None`` is the CUDA card; with ``comm`` (a world)
    every process returns the world's images and stats."""
    dev = compat.resolve_device(device)
    R = num_ranks
    if blobs is None:
        blobs = F.default_blobs(scene.num_blobs, scene.seed)
    blobs = torch.as_tensor(np.asarray(blobs, np.float32), device=dev)
    part = F.SlabPartition(num_slabs=scene.num_slabs, num_ranks=R)
    ds = part.width / scene.samples_per_slab
    hw = scene.width * scene.height
    cap = max(256, hw)
    # peer slots only exist for the padded exchange (onehot rejects them)
    ctx = RafiContext(R, _proto(), capacity=cap, exchange=exchange, device=dev,
                      peer_capacity=cap if exchange == "padded" else 0, comm=comm)
    comm, L = ctx.comm, ctx.local_ranks
    right, up = _camera_axes(dev)
    me = comm.ranks(R, dev).to(torch.int32)[:, None]
    round_fn = partial(_round_fn, part=part, blobs=blobs, ds=ds, cap=cap, right=right, up=up, me=me)

    ppr = hw // R
    pix = me * ppr + torch.arange(ppr, dtype=torch.int32, device=dev)  # (L, ppr)
    o_all, d_all = F.camera_rays(scene.width, scene.height, device=dev)
    o, d = o_all[pix.to(torch.int64)], d_all[pix.to(torch.int64)]
    t_entry, hits = F.ray_domain_entry(o, d)
    fb2 = tuple(torch.zeros(L, hw + F.TRASH_PIXELS, dtype=torch.float32, device=dev) for _ in range(2))
    p_in = o + (t_entry[..., None] + 1e-4) * d
    slab = part.slab_of(torch.clamp(p_in[..., 0], 0.0, 1.0 - 1e-6))
    z = torch.zeros(L, ppr, device=dev)
    rays = SchlierenRay(
        origin=o, dir=d, t_entry=t_entry, k=torch.zeros(L, ppr, dtype=torch.int32, device=dev),
        pixel=pix, slab=slab, iu=z, iv=z,
    )
    dest = torch.where(hits, part.owner_of_slab(slab), DISCARD).to(torch.int32)
    q0 = enqueue(make_queue(_proto(), cap, num_ranks=L, device=dev), rays, dest, torch.ones_like(hits))
    q, fb2, rounds, _done = ctx.run_until_done(round_fn, max_rounds=max_rounds)(q0, fb2)
    # the distributed frame buffers' reduce (one psum of both), then the
    # knife-edge filter: mid-gray plus the (signed) projected gradient integral
    raw = comm.psum(torch.stack(fb2, dim=1))[:, :-F.TRASH_PIXELS].T.contiguous().cpu().numpy()
    img_u = np.clip(0.5 + scene.gain * raw[:, 0], 0, 1).reshape(scene.height, scene.width)
    img_v = np.clip(0.5 + scene.gain * raw[:, 1], 0, 1).reshape(scene.height, scene.width)
    return img_u, img_v, {"rounds": int(rounds), "drops": int(comm.gather_all(q.drops).sum()), "raw": raw}
