"""Fixed-capacity, rank-stacked work queues (§3.2-3.3).

One queue holds every rank's queue: item leaves ``(R, C, ...)``, ``dest
(R, C)``, ``count (R,)``, ``drops (R,)`` — the layout of the reference's
``RafiContext`` global queue with the rank axis split out.  Over a
``torch.distributed`` world (``core.collectives.DistributedCollectives``)
a process's queue is its local block: R reads L, its ranks, while every
``dest`` stays a global rank id.  Entries
``[0, count[r])`` of rank r are valid and contiguous.  Kernels emit
``(item, dest, mask)`` lanes; :func:`enqueue` appends the masked lanes in
lane order by an exclusive prefix sum (kernel K6, ``kernels/compact``) —
the deterministic, order-stable form of the paper's atomic append — and
drops and counts emits past
capacity ("calls that would exceed the output queue size will simply get
dropped").  Destination ``-1`` (``DISCARD``) marks an item that goes nowhere.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import compat
from repro_torch.core import types as T
from repro_torch.kernels.compact import ops as compact_ops

__all__ = [
    "DISCARD", "WorkQueue", "clear", "enqueue", "get_incoming", "make_queue", "num_incoming",
]

DISCARD = -1  # sentinel destination: the item goes nowhere (paper §3.2)


@dataclasses.dataclass
class WorkQueue:
    """Rank-stacked bounded queues with per-item destination ranks.

    Attributes:
      items: pytree, every leaf ``(R, capacity, ...)``.
      dest:  ``(R, capacity)`` int32 destination rank per item; ``-1`` = discard.
      count: ``(R,)`` int32 valid items at the front of each rank's queue.
      drops: ``(R,)`` int32 cumulative overflow-dropped emits.
    """

    items: Any
    dest: torch.Tensor
    count: torch.Tensor
    drops: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.dest.shape[1]

    @property
    def num_ranks(self) -> int:
        return self.dest.shape[0]


def make_queue(proto, capacity: int, *, num_ranks: int = 1, device=None) -> WorkQueue:
    """Empty queues for ``num_ranks`` ranks, items shaped like ``proto``
    (a single-item pytree).  ``device=None`` is the CUDA card."""
    if not isinstance(capacity, int) or isinstance(capacity, bool):
        raise ValueError(
            f"capacity must be a static Python int (got {type(capacity).__name__}): "
            "it fixes the queue's buffer shapes"
        )
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    dev = compat.resolve_device(device)
    return WorkQueue(
        items=T.batched_zeros(proto, (num_ranks, capacity), device=dev),
        dest=torch.full((num_ranks, capacity), DISCARD, dtype=torch.int32, device=dev),
        count=torch.zeros(num_ranks, dtype=torch.int32, device=dev),
        drops=torch.zeros(num_ranks, dtype=torch.int32, device=dev),
    )


def num_incoming(q: WorkQueue) -> torch.Tensor:
    """Paper's ``DeviceInterface::numIncoming()``, per rank."""
    return q.count


def get_incoming(q: WorkQueue, i) -> Any:
    """Paper's ``DeviceInterface::getIncoming(rayID)``: item ``i`` of every rank."""
    return T.tree_map(lambda a: a[:, i], q.items)


def _scatter_rows(buf: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``buf[r, slot[r, i]] = vals[r, i]`` with ``slot == cap`` dropped: a
    trash row past the end absorbs the drops and is sliced off."""
    rows, cap = buf.shape[:2]
    padded = torch.cat([buf, buf.new_zeros((rows, 1) + tuple(buf.shape[2:]))], dim=1)
    r_idx = torch.arange(rows, device=buf.device)[:, None].expand_as(slot)
    padded.index_put_((r_idx, slot), vals.to(buf.dtype))
    return padded[:, :cap]


def enqueue(q: WorkQueue, items, dest, mask, *, num_ranks: int | None = None) -> WorkQueue:
    """Paper's ``DeviceInterface::emitOutgoing(ray, dest)``, vectorised.

    Appends the masked lanes of ``items``/``dest`` (``(R, n, ...)``/``(R, n)``)
    to each rank's queue in lane order; lanes that would land past capacity
    are dropped and counted.  ``mask`` may be bool or integer (nonzero
    emits): it is normalised with ``!= 0`` BEFORE it meets the dest check.
    A float ``dest`` raises — it would truncate-cast and misroute.  With
    ``num_ranks`` a masked lane with ``dest >= num_ranks`` raises here
    instead of being sanitised to a silent drop in the marshal.  Over a
    ``DistributedCollectives`` world ``q`` is the process's block of ranks
    and the check reads that block alone, so it may raise in one process
    only: that process's error ends the world (``launch.dist.spawn_world``
    and ``torchrun`` stop the others), never a wait on a collective the
    raising process will not issue.
    """
    cap = q.capacity
    dest = torch.as_tensor(dest, device=q.dest.device)
    if dest.is_floating_point() or dest.is_complex() or dest.dtype == torch.bool:
        raise ValueError(
            f"dest must have an integer dtype, got {dest.dtype}: a float "
            "dest would truncate-cast and misroute emits silently"
        )
    emit = torch.as_tensor(mask, device=q.dest.device) != 0
    if num_ranks is not None:
        bad = torch.where(emit & (dest >= 0), dest, 0) >= num_ranks
        if bool(bad.any()):
            raise ValueError(
                f"enqueue got dest >= num_ranks ({num_ranks}): max offending "
                f"value {int(torch.where(bad, dest, 0).max())} — emits must "
                "target a rank on the mesh (or DISCARD)"
            )
    emit = emit & (dest >= 0)
    # exclusive prefix sum → append slots (kernel K6 on CUDA tensors)
    excl, n_emit = compact_ops.compact_positions(emit)
    pos = q.count[:, None] + excl
    ok = emit & (pos < cap)
    slot = torch.where(ok, pos, cap).to(torch.int64)
    new_items = T.tree_map(lambda b, v: _scatter_rows(b, slot, v), q.items, items)
    new_dest = _scatter_rows(q.dest, slot, dest.to(torch.int32))
    new_count = torch.clamp(q.count + n_emit, max=cap)
    dropped = q.count + n_emit - new_count
    return WorkQueue(new_items, new_dest, new_count.to(torch.int32), (q.drops + dropped).to(torch.int32))


def clear(q: WorkQueue) -> WorkQueue:
    """Reset to empty (the paper's post-forward counter reset, §4.2.3)."""
    return WorkQueue(
        items=q.items,
        dest=torch.full_like(q.dest, DISCARD),
        count=torch.zeros_like(q.count),
        drops=q.drops,
    )
