"""Rank-health remap law: the draining half of the recovery law.

A ``health (R,) bool`` mask marks ranks that should stop RECEIVING work
(draining before maintenance, browned out, about to be preempted).  The
contract is a pure local destination remap applied before the marshal:

  * a destination on a healthy rank is untouched;
  * a destination on an unhealthy rank ``d`` becomes the fixed fallback
    ``healthy[d % n_healthy]``, ``healthy`` the ascending list of healthy
    ranks — the same arithmetic on every rank, no coordination;
  * ``DISCARD`` lanes (anything negative) pass through.

The remap is integer work on the destination vector the marshal already
reads: it adds no collective and no kernel launch.  With every rank healthy
the table is the identity, so ``health=None`` and an all-True mask give the
same round bit for bit.  An all-unhealthy mask has no fallback: the table
is then the identity (draining every rank is a shutdown, not a remap).

Built without ``nonzero`` (whose output size depends on the data and would
sync with the host): healthy rank ``r`` is scattered to its slot
``cumsum(h)[r] − 1``.  The chaos oracle's numpy twin applies the same law
(``repro_torch.chaos.oracle._health_table_np``).
"""
from __future__ import annotations

import torch

__all__ = ["health_table", "remap_dest"]


def health_table(health: torch.Tensor) -> torch.Tensor:
    """``(R,) int32`` destination-rewrite table of a ``(R,) bool`` mask:
    ``table[d] == d`` for healthy ``d``, ``healthy[d % n_h]`` for unhealthy
    ``d``; the identity when no rank is healthy."""
    h = torch.as_tensor(health).to(torch.bool)
    R = h.shape[0]
    rank = torch.arange(R, dtype=torch.int64, device=h.device)
    h32 = h.to(torch.int64)
    n_h = h32.sum()
    # ascending healthy ranks: healthy rank r lands at cumsum(h)[r] - 1,
    # unhealthy ranks aim at a trash slot R that is sliced off
    slot = torch.where(h, torch.cumsum(h32, 0) - 1, R)
    healthy = torch.zeros(R + 1, dtype=torch.int64, device=h.device).scatter_(0, slot, rank)[:R]
    fallback = healthy[rank % torch.clamp(n_h, min=1)]
    table = torch.where(h, rank, fallback)
    return torch.where(n_h > 0, table, rank).to(torch.int32)


def remap_dest(dest: torch.Tensor, health: torch.Tensor) -> torch.Tensor:
    """Re-address a destination tensor (any shape, e.g. the rank-stacked
    ``(R, C)``) through :func:`health_table`: entries in ``[0, R)`` are
    rewritten, negative entries pass through.  Entries past a queue's
    ``count`` may hold junk; they are clamped for the lookup and ignored by
    the marshal, as without the remap."""
    table = health_table(health).to(dest.device)
    R = table.shape[0]
    looked = table[dest.to(torch.int64).clamp(0, R - 1)]
    return torch.where(dest >= 0, looked, dest.to(torch.int32)).to(torch.int32)
