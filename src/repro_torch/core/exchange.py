"""Packed-payload exchange (§4.2.2, MPI_Alltoallv) over rank-stacked tensors.

The caller packs the work items into ONE ``(R, C, W)`` buffer of words
(``core.types.pack_payload``).  Backends of this slice:

* ``padded`` — fixed per-peer slots of ``peer_capacity`` rows, moved with a
  single ``all_to_all``; a stage composition (``core.stages``):
  SpillExtract → Marshal → CountExchange → PayloadExchange → Unmarshal.
* ``onehot`` — the all-gather reference oracle, a deliberately different
  code path used by the tests and the chip smoke run.

Both take either marshal plan: ``marshal="sort"`` with the destination-sort
``perm``, or ``marshal="scatter"`` with the bucket plan ``dest_clean`` /
``dest_rank`` (``perm`` is then None).

Budget per round on ``padded``: 1 payload ``all_to_all`` + 1 count
``all_to_all`` (recorded by ``core.collectives``).  Segment overflow —
sender-side ``> peer_capacity`` or receiver-side ``> capacity`` — is dropped
and counted exactly once.  ``ragged`` and ``hierarchical`` come later
(ROADMAP Queue 1 items 16 and 7).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import stages as ST
from repro_torch.core.collectives import StackedCollectives
from repro_torch.kernels.bucket_scatter import ops as bs_ops

__all__ = ["exchange_counts", "exchange_onehot", "exchange_padded"]


def exchange_counts(send_counts: torch.Tensor, comm: StackedCollectives) -> torch.Tensor:
    """§4.2.2 step 2 — MPI_Alltoall of per-peer counts: ``send_counts
    (R, R)`` (what rank b sends each peer) → ``(R, R)`` (what each peer
    sends rank b)."""
    return comm.all_to_all(send_counts[:, :, None]).reshape(send_counts.shape)


def exchange_padded(
    packed: torch.Tensor,  # (R, C, W) UNSORTED packed payload
    perm: torch.Tensor,  # (R, C) destination-sort permutation
    send_counts: torch.Tensor,  # (R, R) valid-destination counts
    *,
    comm: StackedCollectives,
    num_ranks: int,
    capacity: int,
    peer_capacity: int,
    marshal: str = "sort",
    dest_clean: Optional[torch.Tensor] = None,
    dest_rank: Optional[torch.Tensor] = None,
    on_stage: Optional[Callable[[str], None]] = None,
):
    """Padded-slot exchange.  Returns ``(recv_packed (R, capacity, W),
    recv_counts (R, R), new_count (R,), drops (R,))``.  ``on_stage`` is
    passed to :func:`core.stages.compose`."""
    R, S = num_ranks, peer_capacity
    st = ST.RoundState(
        packed=packed, perm=perm, send_counts=send_counts,
        marshal=marshal, dest_clean=dest_clean, dest_rank=dest_rank,
    )
    st = ST.compose(
        ST.SpillExtract(R, capacity, S),
        ST.Marshal(R, S),
        ST.CountExchange(comm),
        ST.PayloadExchange(comm),
        ST.Unmarshal(capacity),
        on_stage=on_stage,
    )(st)
    return st.out, st.recv_counts, st.new_count, st.send_drops + st.recv_drops


def exchange_onehot(
    packed: torch.Tensor,
    perm: torch.Tensor,
    send_counts: torch.Tensor,
    *,
    comm: StackedCollectives,
    num_ranks: int,
    capacity: int,
    peer_capacity: int = 0,
    marshal: str = "sort",
    dest_clean: Optional[torch.Tensor] = None,
    dest_rank: Optional[torch.Tensor] = None,
):
    """All-gather reference oracle: every rank sees every rank's sorted
    queue, selects what is addressed to it, and compacts stably by
    (source, lane).  In scatter mode the queue is placed into sorted order
    with kernel K5's ``scatter_rows`` (the only step that differs).
    Same returns as :func:`exchange_padded`."""
    del peer_capacity
    R = num_ranks
    rows, cap, w = packed.shape
    dev = packed.device
    if marshal == "scatter":
        off = torch.cumsum(send_counts, dim=1, dtype=torch.int32) - send_counts
        pos = torch.gather(off, 1, dest_clean.clamp(0, R - 1).to(torch.int64)) + dest_rank
        sorted_packed = bs_ops.scatter_rows(packed, torch.where(dest_clean < R, pos, cap), num_slots=cap)
    else:
        sorted_packed = torch.gather(packed, 1, perm.to(torch.int64)[:, :, None].expand(-1, -1, w))
    lane = torch.arange(cap, dtype=torch.int32, device=dev)
    # per-item dest from the segments: dest[i] = r iff off[r] <= i < off[r] + cnt[r]
    seg_end = torch.cumsum(send_counts, dim=1, dtype=torch.int32)
    dest = (lane[None, :, None] >= seg_end[:, None, :]).sum(dim=2, dtype=torch.int32)
    dest = torch.where(lane[None, :] < seg_end[:, -1:], dest, R)

    all_packed = comm.all_gather(sorted_packed)  # (R_me, R_src, C, W)
    all_dest = comm.all_gather(dest)  # (R_me, R_src, C)
    me = torch.arange(rows, dtype=torch.int32, device=dev)[:, None, None]
    mine = (all_dest == me).reshape(rows, R * cap)
    # mine first, stable (source, lane) order
    order = torch.sort((~mine).to(torch.int8), dim=1, stable=True).indices[:, :capacity]
    flat = all_packed.reshape(rows, R * cap, w)
    gathered = torch.gather(flat, 1, order[:, :, None].expand(-1, -1, w))
    total = mine.sum(dim=1, dtype=torch.int32)
    new_count = torch.clamp(total, max=capacity)
    recv_counts = (all_dest == me).sum(dim=2, dtype=torch.int32)
    return gathered, recv_counts, new_count, total - new_count
