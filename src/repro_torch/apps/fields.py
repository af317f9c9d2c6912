"""Shared scene infrastructure for the sample apps (counterpart of
``repro.apps.fields``).

* a procedural scalar field (Gaussian-blob mixture) with analytic gradient;
* slab domain partitions (the 1-D case of VoPaT's k-d partitioning) with
  proxy arithmetic: every rank knows every slab's bounds;
* a pinhole camera for the renderers.

Domain: the unit cube [0,1]³.  The small sums (over the three axes and over
the blobs) are written out as sequential adds, so that a lane's value never
depends on how many lanes a tensor holds: a ray's walk is the same whichever
rank, and however many ranks, trace it.  ``default_blobs`` stays numpy, as
in the reference; the other functions take float32 tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "SlabPartition",
    "camera_rays",
    "default_blobs",
    "density",
    "deposit",
    "density_gradient",
    "majorant",
    "ray_box_exit",
    "ray_domain_entry",
    "sky",
    "write_ppm",
]

_EPS = 1e-12

# ------------------------------------------------------------------ fields


def default_blobs(num: int = 6, seed: int = 0) -> np.ndarray:
    """``(G, 5)`` float32 rows (cx, cy, cz, sigma, amplitude) inside the
    unit cube."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, size=(num, 3))
    s = rng.uniform(0.05, 0.15, size=(num, 1))
    a = rng.uniform(1.0, 3.0, size=(num, 1))
    return np.concatenate([c, s, a], axis=1).astype(np.float32)


def _blob_terms(p: torch.Tensor, blobs: torch.Tensor):
    """Per blob: ``(d (..., 3), amplitude · exp(-r²/2σ²), σ²)``."""
    for g in range(blobs.shape[0]):
        d = p - blobs[g, :3]
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        s2 = blobs[g, 3] ** 2
        yield d, blobs[g, 4] * torch.exp(-0.5 * r2 / s2), s2


def density(p: torch.Tensor, blobs: torch.Tensor) -> torch.Tensor:
    """σ(p) for ``p (..., 3)``; ``blobs (G, 5)``."""
    out = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for _d, term, _s2 in _blob_terms(p, blobs):
        out = out + term
    return out


def density_gradient(p: torch.Tensor, blobs: torch.Tensor) -> torch.Tensor:
    """∇σ(p) ``(..., 3)``, closed form for the Gaussian mixture."""
    out = torch.zeros_like(p)
    for d, term, s2 in _blob_terms(p, blobs):
        out = out + (term / s2)[..., None] * d
    return -out


def majorant(blobs: torch.Tensor) -> float:
    """A safe global majorant: Σ amplitudes (blob peaks can coincide)."""
    return float(blobs[:, 4].sum() * 1.05)


# ------------------------------------------------------------- slab proxies


@dataclasses.dataclass(frozen=True)
class SlabPartition:
    """``num_slabs`` equal x-slabs of [0,1]³, owned round-robin by R ranks
    (``num_slabs == R``: convex per-rank domains, VoPaT §5.1)."""

    num_slabs: int
    num_ranks: int

    @property
    def width(self) -> float:
        return 1.0 / self.num_slabs

    def slab_of(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp((x / self.width).to(torch.int32), 0, self.num_slabs - 1)

    def owner_of_slab(self, slab: torch.Tensor) -> torch.Tensor:
        return (slab % self.num_ranks).to(torch.int32)

    def owner_of(self, p: torch.Tensor) -> torch.Tensor:
        return self.owner_of_slab(self.slab_of(p[..., 0]))

    def bounds(self, slab: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        lo = slab.to(torch.float32) * self.width
        return lo, lo + self.width


def _inverse(d: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(d.abs() < _EPS, torch.where(d >= 0, _EPS, -_EPS), d)


def ray_box_exit(o, d, t, lo_x, hi_x):
    """First exit of the ray ``p = o + t·d`` (current parameter ``t``) from
    the box [lo_x, hi_x]×[0,1]×[0,1].  Returns ``(t_exit, axis,
    positive_side)``; ``axis`` is the first axis of least exit parameter (as
    ``argmin``), and for axis 0 the ray crosses a slab face."""
    inv = _inverse(d)
    lo = (lo_x, torch.zeros_like(lo_x), torch.zeros_like(lo_x))
    hi = (hi_x, torch.ones_like(hi_x), torch.ones_like(hi_x))
    t_far = [
        torch.where(d[..., k] >= 0, (hi[k] - o[..., k]) * inv[..., k], (lo[k] - o[..., k]) * inv[..., k])
        for k in range(3)
    ]
    t_exit, axis = t_far[0], torch.zeros_like(lo_x, dtype=torch.int32)
    for k in (1, 2):
        less = t_far[k] < t_exit
        t_exit = torch.where(less, t_far[k], t_exit)
        axis = torch.where(less, k, axis)
    d_axis = torch.where(axis == 0, d[..., 0], torch.where(axis == 1, d[..., 1], d[..., 2]))
    return torch.maximum(t_exit, t), axis, d_axis >= 0


def ray_domain_entry(o, d):
    """Entry parameter of the ray into [0,1]³ (clipped at 0) and a hit
    mask.  Rays starting inside enter at t=0."""
    inv = _inverse(d)
    t0 = (0.0 - o) * inv
    t1 = (1.0 - o) * inv
    near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
    t_near = torch.maximum(torch.maximum(near[..., 0], near[..., 1]), near[..., 2])
    t_far = torch.minimum(torch.minimum(far[..., 0], far[..., 1]), far[..., 2])
    t_entry = torch.clamp(t_near, min=0.0)
    return t_entry, t_far > t_entry


# ----------------------------------------------------------------- camera


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])[..., None]


def camera_rays(width: int, height: int, *, eye=(-1.2, 0.5, 0.5), look=(1.0, 0.0, 0.0),
                fov: float = 0.9, device=None):
    """Pinhole camera: ``(origins (H·W, 3), dirs (H·W, 3))``, dirs
    normalised, row-major over (y, x)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    fwd = _normalize(f32(look))
    right = _normalize(torch.linalg.cross(fwd, f32([0.0, 0.0, 1.0])))
    up = torch.linalg.cross(right, fwd)
    ys, xs = torch.meshgrid(
        torch.linspace(-1, 1, height, device=device), torch.linspace(-1, 1, width, device=device),
        indexing="ij",
    )
    half = torch.tan(f32(fov / 2))
    d = fwd[None, :] + half * (xs.reshape(-1)[:, None] * right[None, :] + ys.reshape(-1)[:, None] * up[None, :])
    d = _normalize(d)
    return f32(eye).expand(d.shape), d


TRASH_PIXELS = 4096  # trash pixels past the image, one per lane modulo this


def deposit(fb: torch.Tensor, pixel: torch.Tensor, value: torch.Tensor, mask: torch.Tensor) -> None:
    """``fb[b, pixel] += value`` on the lanes of ``mask``, in place: the
    rank-stacked framebuffer deposit of the renderers.  Every other lane is
    aimed at a trash pixel past the image (``fb`` is ``(R, HW +
    TRASH_PIXELS)``): an index_add with an out-of-range index would be a
    device assert on the card, not the reference's ``mode="drop"``.  Lane
    ``i`` uses trash pixel ``i % TRASH_PIXELS``, so the unmasked lanes'
    atomic adds do not all meet on one address."""
    rows, width = fb.shape
    hw = width - TRASH_PIXELS
    lane = torch.arange(pixel.shape[-1], device=fb.device)
    b = torch.arange(rows, device=fb.device)[:, None]
    idx = b * width + torch.where(mask, pixel, hw + lane % TRASH_PIXELS).to(torch.int64)
    fb.view(-1).index_add_(0, idx.reshape(-1), value.reshape(-1))


def sky(d: torch.Tensor) -> torch.Tensor:
    """Simple gradient environment light (grayscale)."""
    return 0.5 + 0.5 * torch.clamp(d[..., 2], -1.0, 1.0)


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write a grayscale or RGB float image in [0,1] as binary PPM."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    h, w, _ = u8.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())

