"""rafi/Lander — volume rendering of NON-CONVEX partitions (§5.2),
rank-stacked (counterpart of ``repro.apps.lander``).

The Mars-Lander problem: with the solver's native partitioning, one rank's
domain is not convex, so a ray enters and leaves the same rank many times.
The structure is reproduced with interleaved slab ownership: ``num_slabs =
k·R`` x-slabs, rank r owning slabs {r, r+R, r+2R, ...} — every ray crosses
every rank up to k times.

Two renderers over the same partition and the same globally aligned sample
grid (samples at t_entry + (k+½)·Δs, so partitioning cannot change *where*
the field is sampled):

* :func:`render_forwarding` — the RaFI realization: each ray carries its
  accumulated (L, T) emission-absorption state slab to slab through
  ``RafiContext.run_until_done``; segments per ray are unlimited.  Every
  round runs K3, K1 and K2 (the sort marshal) and K6 under ``enqueue``.
* :func:`render_deep_compositing` — the baseline it replaced (Sahistan et
  al.): every rank integrates each of its *owned segments* independently
  into a fixed-depth fragment list (at most ``max_fragments`` per pixel per
  rank — fragments past that are DROPPED, the paper's artifact mechanism),
  then a depth-sorted composite merges all ranks' fragments.  The
  composite runs on the device: a stable sort by depth and a front-to-back
  sum in float64, the reference's host numpy arithmetic.

With ``max_fragments >= slabs_per_rank`` the two agree to float tolerance;
with fewer fragments the compositor mis-renders exactly as §5.2 describes
while the forwarding renderer stays correct.  The per-pixel sums are
sequential (``apps.fields``), so an R-rank forwarding image equals the
1-rank image bit for bit.

With ``comm=`` a ``DistributedCollectives`` each process renders its block
of ranks: the forwarding renderer's frame buffers merge in one ``psum``
(summed in the stacked order), the compositor's fragment lists in one
``all_gather`` and its dropped-fragment count in one integer ``psum``, so
a world's images equal the stacked images bit for bit.
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
from repro_torch.core.collectives import backend

__all__ = ["EARay", "LanderScene", "render_deep_compositing", "render_forwarding"]

MARCH_PER_ROUND = 32


@work_item
@dataclasses.dataclass
class EARay:
    """Emission-absorption ray state forwarded between partitions: 8
    leaves, 12 words (48 B) on the wire."""

    origin: torch.Tensor    # (3,) f32
    dir: torch.Tensor       # (3,) f32
    t_entry: torch.Tensor   # () f32 domain entry (sample-grid anchor)
    k: torch.Tensor         # () i32 next sample index
    pixel: torch.Tensor     # () i32
    slab: torch.Tensor      # () i32
    radiance: torch.Tensor  # () f32 accumulated L
    trans: torch.Tensor     # () f32 accumulated transmittance T


def _proto() -> EARay:
    z, zi = torch.zeros(()), torch.zeros((), dtype=torch.int32)
    return EARay(torch.zeros(3), torch.zeros(3), z, zi, zi, zi, z, z)


@dataclasses.dataclass(frozen=True)
class LanderScene:
    width: int = 32
    height: int = 32
    num_slabs: int = 32        # total slabs — independent of R so the sample
    samples_per_slab: int = 8  # grid (and hence the image) is R-invariant
    seed: int = 1
    num_blobs: int = 6


def _delta_s(part: F.SlabPartition, scene: LanderScene) -> float:
    return part.width / scene.samples_per_slab


def _march(origin, dirs, t_entry, k, L, T, t_hi, ok, blobs, ds, steps: int):
    """Advance ≤ ``steps`` samples of every lane of ``ok`` while t_k <
    t_hi; returns the updated (k, L, T)."""
    for _ in range(steps):
        t_k = t_entry + (k.to(torch.float32) + 0.5) * ds
        inside = ok & (t_k < t_hi)
        p = origin + t_k[..., None] * dirs
        a = 1.0 - torch.exp(-F.density(p, blobs) * ds)
        L = torch.where(inside, L + T * a, L)
        T = torch.where(inside, T * (1.0 - a), T)
        k = k + inside.to(torch.int32)
    return k, L, T


def _round_fn(q_in, fb, rnd, *, part, blobs, ds, cap, me):
    del rnd
    r = q_in.items
    lane = torch.arange(cap, device=fb.device)
    valid = lane[None, :] < q_in.count[:, None]

    lo, hi = part.bounds(r.slab)
    t_cur = r.t_entry + r.k.to(torch.float32) * ds  # lower bound on position
    t_exit, axis, pos_side = F.ray_box_exit(r.origin, r.dir, t_cur, lo, hi)

    k, L, T = _march(r.origin, r.dir, r.t_entry, r.k, r.radiance, r.trans, t_exit, True, blobs, ds,
                     MARCH_PER_ROUND)
    t_next = r.t_entry + (k.to(torch.float32) + 0.5) * ds
    done_seg = t_next >= t_exit  # consumed the whole in-slab segment

    next_slab = r.slab + torch.where(pos_side, 1, -1).to(torch.int32)
    stays = (next_slab >= 0) & (next_slab < part.num_slabs) & (axis == 0)
    finish = valid & done_seg & ~stays
    cross = valid & done_seg & stays
    again = valid & ~done_seg  # more samples needed in this slab

    F.deposit(fb, r.pixel, L + T * F.sky(r.dir), finish)

    new = EARay(
        origin=r.origin, dir=r.dir, t_entry=r.t_entry, k=k, pixel=r.pixel,
        slab=torch.where(cross, next_slab, r.slab), radiance=L, trans=T,
    )
    alive = cross | again
    dest = torch.where(cross, part.owner_of_slab(next_slab), torch.where(again, me, DISCARD)).to(torch.int32)
    out = make_queue(_proto(), cap, num_ranks=q_in.num_ranks, device=fb.device)
    return enqueue(out, new, dest, alive), fb


def _blobs(scene, blobs, dev) -> torch.Tensor:
    if blobs is None:
        blobs = F.default_blobs(scene.num_blobs, scene.seed)
    return torch.as_tensor(np.asarray(blobs, np.float32), device=dev)


def render_forwarding(
    scene: LanderScene = LanderScene(),
    *,
    num_ranks: int,
    blobs=None,
    max_rounds: int = 4096,
    exchange: str = "padded",
    device=None,
    comm=None,
) -> Tuple[np.ndarray, dict]:
    """RaFI-style renderer on ``num_ranks`` stacked ranks.  Returns ``(image
    (H, W) float32, stats)``; stats hold rounds and drops.  ``device=None``
    is the CUDA card; ``comm`` a world's backend (module docstring)."""
    dev = compat.resolve_device(device)
    R = num_ranks
    blobs = _blobs(scene, blobs, dev)
    part = F.SlabPartition(num_slabs=scene.num_slabs, num_ranks=R)
    ds = _delta_s(part, scene)
    hw = scene.width * scene.height
    cap = max(256, hw)
    # peer slots only exist for the padded exchange (onehot rejects them)
    ctx = RafiContext(R, _proto(), capacity=cap, exchange=exchange, device=dev,
                      peer_capacity=cap if exchange == "padded" else 0, comm=comm)
    comm, L = ctx.comm, ctx.local_ranks
    me = comm.ranks(R, dev).to(torch.int32)[:, None]
    round_fn = partial(_round_fn, part=part, blobs=blobs, ds=ds, cap=cap, me=me)

    ppr = hw // R
    pix = me * ppr + torch.arange(ppr, dtype=torch.int32, device=dev)  # (L, ppr)
    o_all, d_all = F.camera_rays(scene.width, scene.height, device=dev)
    o, d = o_all[pix.to(torch.int64)], d_all[pix.to(torch.int64)]
    t_entry, hits = F.ray_domain_entry(o, d)
    fb = torch.zeros(L, hw + F.TRASH_PIXELS, dtype=torch.float32, device=dev)
    F.deposit(fb, pix, F.sky(d), ~hits)
    p_in = o + (t_entry[..., None] + 1e-4) * d
    slab = part.slab_of(torch.clamp(p_in[..., 0], 0.0, 1.0 - 1e-6))
    z = torch.zeros(L, ppr, device=dev)
    rays = EARay(
        origin=o, dir=d, t_entry=t_entry, k=torch.zeros(L, ppr, dtype=torch.int32, device=dev),
        pixel=pix, slab=slab, radiance=z, trans=torch.ones_like(z),
    )
    dest = torch.where(hits, part.owner_of_slab(slab), DISCARD).to(torch.int32)
    q0 = enqueue(make_queue(_proto(), cap, num_ranks=L, device=dev), rays, dest, torch.ones_like(hits))
    q, fb, rounds, _done = ctx.run_until_done(round_fn, max_rounds=max_rounds)(q0, fb)
    img = comm.psum(fb)[:-F.TRASH_PIXELS]  # the distributed frame buffer's reduce
    return (
        img.cpu().numpy().reshape(scene.height, scene.width),
        {"rounds": int(rounds), "drops": int(comm.gather_all(q.drops).sum())},
    )


def render_deep_compositing(
    scene: LanderScene = LanderScene(),
    *,
    num_ranks: int,
    blobs=None,
    max_fragments: int = 4,
    device=None,
    comm=None,
) -> Tuple[np.ndarray, dict]:
    """The §5.2 baseline: per-rank fragment lists + depth-sorted compositing.

    Every rank integrates each of its owned segments of every ray locally
    (no forwarding), keeping at most ``max_fragments`` (L, T, depth) triples
    per pixel — excess fragments are dropped, which is the artifact
    mechanism the paper describes.  The ranks' lists are gathered (one
    ``all_gather``) and go through one stable depth sort and a
    front-to-back composite on the device.  Returns ``(image (H, W)
    float64, {"dropped_fragments": n})``, the same in every process of a
    world ``comm``."""
    dev = compat.resolve_device(device)
    R = num_ranks
    blobs = _blobs(scene, blobs, dev)
    part = F.SlabPartition(num_slabs=scene.num_slabs, num_ranks=R)
    ds = _delta_s(part, scene)
    hw = scene.width * scene.height
    FMAX = max_fragments
    comm = backend(comm)
    me = comm.ranks(R, dev).to(torch.int32)[:, None]
    L = me.shape[0]

    o, d = F.camera_rays(scene.width, scene.height, device=dev)
    t_entry, hits = F.ray_domain_entry(o, d)
    # in-slab parameter range along each ray (x is monotone for d_x ≠ 0)
    eps = 1e-12
    dx = torch.where(d[:, 0].abs() < eps, eps, d[:, 0])
    inv = 1.0 / torch.where(d.abs() < eps, torch.where(d >= 0, eps, -eps), d)
    tfar = torch.where(d >= 0, (1.0 - o) * inv, (0.0 - o) * inv).amin(dim=-1)  # domain y/z exit
    fragL = torch.zeros(L, hw, FMAX, device=dev)
    fragT = torch.ones(L, hw, FMAX, device=dev)
    fragD = torch.full((L, hw, FMAX), float("inf"), device=dev)
    nfrag = torch.zeros(L, hw, dtype=torch.int64, device=dev)
    dropped = torch.zeros(L, dtype=torch.int64, device=dev)
    for j in range(-(-scene.num_slabs // R)):  # owned slabs: me, me+R, ...
        lo, hi = part.bounds((me + j * R).expand(L, hw))
        ta = (lo - o[:, 0]) / dx
        tb = (hi - o[:, 0]) / dx
        t0s = torch.maximum(torch.minimum(ta, tb), t_entry)
        t1s = torch.minimum(torch.maximum(ta, tb), tfar)
        seg_ok = hits & (t1s > t0s)
        # globally aligned samples: k in [ceil((t0 - te)/ds - .5), …)
        k0 = torch.clamp(torch.ceil((t0s - t_entry) / ds - 0.5).to(torch.int32), min=0)
        z = torch.zeros(L, hw, device=dev)
        k, rad, T = _march(o, d, t_entry, k0, z, torch.ones_like(z), t1s, seg_ok, blobs, ds,
                           scene.samples_per_slab + 2)
        has = seg_ok & (k > k0)
        slot = torch.clamp(nfrag, max=FMAX - 1)[..., None]
        fits = has & (nfrag < FMAX)
        dropped += (has & ~fits).sum(dim=1)
        for frag, v in ((fragL, rad), (fragT, T), (fragD, t0s)):
            frag.scatter_(2, slot, torch.where(fits, v, frag.gather(2, slot)[..., 0])[..., None])
        nfrag += fits.to(torch.int64)

    # the "sort-last" stage: every rank's fragments of a pixel (one gather
    # over the ranks), depth-sorted (stable), composited front to back in
    # float64
    fragL, fragT, fragD = comm.all_gather(torch.stack([fragL, fragT, fragD], dim=1))[0].unbind(1)
    flat = lambda a: a.transpose(0, 1).reshape(hw, R * FMAX)
    order = torch.sort(flat(fragD), dim=1, stable=True).indices
    L = flat(fragL).gather(1, order).to(torch.float64)
    T = flat(fragT).gather(1, order).to(torch.float64)
    img = torch.zeros(hw, dtype=torch.float64, device=dev)
    t_acc = torch.ones(hw, dtype=torch.float64, device=dev)
    for i in range(L.shape[1]):
        img += t_acc * L[:, i]
        t_acc *= T[:, i]
    sky = F.sky(d).to(torch.float64)  # background through the remaining transmittance, and misses
    img = torch.where(hits, img + t_acc * sky, sky)
    return (
        img.cpu().numpy().reshape(scene.height, scene.width),
        {"dropped_fragments": int(comm.psum(dropped))},
    )
