"""Work rebalancing — straggler mitigation on the forwarding core.

The paper notes (§6.3) that RaFI "does not inherently address issues such as
bottlenecks, starvation, or long-tail problems".  This module does, with
the forwarding round itself: from a (possibly badly skewed) per-rank queue
population it computes a balanced layout and re-addresses the surplus so
ONE ``forward_work`` round evens the load out.

Flat plan: an ``all_gather`` of the per-rank resident counts (R ints), the
target ``ceil(total / R)``, and resident item ``j`` of the global order
(ranks laid out on a line of cumulative counts) goes to rank
``j // target`` — an order-preserving balanced assignment, oblivious and
single-round.

Topology-aware plan (``exchange="hierarchical"``): groups of ``F =
level_sizes[-1]`` fast-tier ranks keep up to the balanced group quota
``ceil(total / groups)`` of their own residents, spread over their lanes;
each group's surplus fills other groups' deficits in group order.  A skew
confined to one group moves nothing across the slower tiers; a skew across
groups moves exactly the surplus.

``scope="intra"`` restricts the plan AND the round to the fast tier: the
count gather and both exchange calls are calls of the last tier, so no
payload crosses a slower tier.  Pending items addressed inside the group
are delivered (their global rank becomes a fast-tier lane); pending items
addressed across groups cannot ride such a round and stay in the queue,
destination intact.  On the rank-stacked layer the intra round is the flat
padded round over the ``F`` lanes of every group at once
(``forwarding._forward`` with a tier scope), not an R-rank round with
remapped ranks.

Only resident work (``dest == DISCARD``) is re-addressed; pending items
(``dest >= 0``) keep their destination and ride the same round.  The plan
is computed per rank from the gathered counts (every row of the gather is
the same vector, so every rank derives the same plan) with no host sync;
a rank finds itself on the line by its global id (``comm.ranks``), so the
plan is the same over a ``DistributedCollectives`` world.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.collectives import StackedCollectives, backend, tier_digit
from repro_torch.core.forwarding import ForwardConfig, _forward, forward_work
from repro_torch.core.queue import DISCARD, WorkQueue, enqueue
from repro_torch.obs import trace as OT

__all__ = ["plan_rebalance", "plan_rebalance_hierarchical", "rebalance"]


def _ceil_div(a: torch.Tensor, b) -> torch.Tensor:
    return (a + b - 1) // b


def _excl(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1, dtype=x.dtype) - x


def plan_rebalance(
    count: torch.Tensor,
    num_ranks: int,
    *,
    comm: Optional[StackedCollectives] = None,
    digits: Optional[Sequence[int]] = None,
    tier: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank ``(start, target)`` ``(R,)``: rank b's residents ``[0,
    count[b])`` sit at positions ``[start[b], start[b] + count[b])`` of the
    line, and position j belongs on rank (or lane) ``j // target[b]``.  With
    ``digits`` and ``tier`` the line is each rank's tier group of
    ``num_ranks`` lanes (a tier ``all_gather``)."""
    comm = backend(comm)
    counts = comm.all_gather(count, digits=digits, tier=tier)  # (B, N): my line
    if digits is None:
        me = comm.ranks(counts.shape[1], count.device)
    else:
        me = tier_digit(digits, tier, ranks=comm.ranks(math.prod(digits), count.device))
    start = torch.gather(_excl(counts), 1, me[:, None])[:, 0]
    target = torch.clamp(_ceil_div(counts.sum(dim=1, dtype=counts.dtype), num_ranks), min=1)
    return start.to(torch.int32), target.to(torch.int32)


def plan_rebalance_hierarchical(
    count: torch.Tensor, level_sizes: Sequence[int], *, comm: Optional[StackedCollectives] = None
) -> Dict[str, torch.Tensor]:
    """The topology-aware plan: one ``all_gather`` of the resident counts,
    from which every rank derives the group quotas, the surplus / deficit
    line and the lane targets.  Returns per-rank tensors (``G = R // F``
    groups of ``F = level_sizes[-1]`` lanes): ``start (R,)`` (my residents'
    offset on my group's line), ``group (R,)``, and ``kept``,
    ``lane_target``, ``sur_start``, ``cum_def`` ``(R, G)`` — the residents
    each group keeps, its lane stride, the exclusive prefix of the surplus
    line and the inclusive prefix of the deficit slots."""
    comm = backend(comm)
    F = int(level_sizes[-1])
    counts = comm.all_gather(count)  # (B, R), lexicographic
    B, R = counts.shape
    G = R // F
    me = comm.ranks(R, count.device)  # row i is global rank me[i]
    grp = me // F
    gtot = counts.reshape(B, G, F).sum(dim=2, dtype=counts.dtype)  # (B, G)
    total = gtot.sum(dim=1, keepdim=True, dtype=counts.dtype)
    quota = torch.clamp(_ceil_div(total, G), min=1)
    kept = torch.minimum(gtot, quota)
    surplus = gtot - kept
    deficit = quota - kept
    cum_sur = torch.cumsum(surplus, dim=1, dtype=counts.dtype)
    cum_def = torch.cumsum(deficit, dim=1, dtype=counts.dtype)
    s_total = cum_sur[:, -1:]
    # each group's intake: its deficit, first come in group order, until the
    # surplus line runs out
    recv = torch.clamp(torch.minimum(cum_def, s_total) - torch.minimum(cum_def - deficit, s_total), min=0)
    lane_target = torch.clamp(_ceil_div(kept + recv, F), min=1)
    off = _excl(counts)  # (B, R) resident offsets
    start = (torch.gather(off, 1, me[:, None]) - torch.gather(off, 1, (grp * F)[:, None]))[:, 0]
    i32 = lambda t: t.to(torch.int32)
    return {"start": i32(start), "group": i32(grp), "kept": i32(kept), "lane_target": i32(lane_target),
            "sur_start": i32(cum_sur - surplus), "cum_def": i32(cum_def)}


def _hierarchical_dest(plan: Dict[str, torch.Tensor], pos: torch.Tensor, fast_size: int) -> torch.Tensor:
    """Destination rank of every resident at in-group position ``pos (R, C)``."""
    F = fast_size
    g = plan["group"].to(torch.int64)[:, None]
    G = plan["kept"].shape[1]
    at = lambda t, i: torch.gather(t, 1, i.to(torch.int64))
    kept_g = at(plan["kept"], g)
    stay = pos < kept_g
    # keepers: order-preserving ceil assignment over the group's lanes
    dest_stay = g * F + torch.clamp(pos // at(plan["lane_target"], g), max=F - 1)
    # surplus: position on the global surplus line → deficit slot → group m
    j = at(plan["sur_start"], g) + (pos - kept_g)
    m = torch.searchsorted(plan["cum_def"].contiguous(), j.to(torch.int32).contiguous(), right=True).clamp(0, G - 1)
    k = j - torch.where(m > 0, at(plan["cum_def"], (m - 1).clamp(min=0)), 0)
    lane = torch.clamp((at(plan["kept"], m) + k) // at(plan["lane_target"], m), max=F - 1)
    return torch.where(stay, dest_stay, m * F + lane).to(torch.int32)


def _resident_positions(q: WorkQueue) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(resident mask, rank among the residents per lane, resident
    count)``, each per rank."""
    lane = torch.arange(q.capacity, device=q.dest.device)[None, :]
    resident = (lane < q.count[:, None]) & (q.dest == DISCARD)
    r32 = resident.to(torch.int32)
    return resident, _excl(r32), r32.sum(dim=1, dtype=torch.int32)


def _intra_config(cfg: ForwardConfig) -> ForwardConfig:
    """The fast tier as a flat padded config of ``level_sizes[-1]`` ranks:
    a round forwarded with it (tier-scoped) calls the fast tier only."""
    return ForwardConfig(
        num_ranks=cfg.level_sizes[-1],
        capacity=cfg.capacity,
        peer_capacity=cfg.level_capacities[-1],
        exchange="padded",
        marshal=cfg.marshal,
        sort_method=cfg.sort_method,
        telemetry=cfg.telemetry,
        telemetry_window=cfg.telemetry_window,
        telemetry_buckets=cfg.telemetry_buckets,
        overflow=cfg.overflow,
        pipeline_shards=cfg.pipeline_shards,
    )


def rebalance(
    q: WorkQueue,
    cfg: ForwardConfig,
    *,
    scope: str = "global",
    health: Optional[torch.Tensor] = None,
    comm: Optional[StackedCollectives] = None,
):
    """One balanced redistribution round over the rank-stacked queue ``q``.

    Only resident items (``dest == DISCARD``) are re-addressed; pending
    items keep their destination and ride the same round.  Returns
    ``(balanced_queue, total)`` (plus the round's ``RoundStats`` with
    ``cfg.telemetry``; an intra round records against the fast-tier
    sub-config's single tier).  A global call passes ``forward_work``'s
    retain (and credit) arity straight through; an intra retain round keeps
    its clamp-cut rows with their GLOBAL destination restored, ages
    restarting.  Afterwards every rank holds ``floor`` or ``ceil`` of the
    mean resident population (subject to the capacity clamps) plus the
    pending work addressed to it.

    ``scope``: ``"global"`` evens out across all ranks (hierarchical configs
    use the topology-aware plan); ``"intra"`` (hierarchical only) evens out
    within each fast-tier group and calls the fast tier alone — in-group
    pending items are delivered, cross-group pending items stay.

    ``health`` (global scope only): a ``(R,) bool`` rank mask; the plan's
    destinations AND the pending ones are re-addressed away from unhealthy
    ranks, which is how a draining rank's residents are evacuated.
    ``comm`` records the calls."""
    if OT.enabled():
        OT.event(
            "route.rebalance", OT.CAT_ROUTE,
            scope=scope, exchange=cfg.exchange,
            num_ranks=cfg.num_ranks, health_aware=health is not None,
        )
    comm = backend(comm)
    resident, idx, n_res = _resident_positions(q)
    if health is not None and scope != "global":
        raise ValueError(
            "health-aware rebalance is global-scope only: an intra round's "
            "rank space is the fast-axis group, where a global health mask "
            "has no meaning"
        )

    if scope == "intra":
        if cfg.exchange != "hierarchical":
            raise ValueError(
                "scope='intra' needs a hierarchical ForwardConfig — a flat "
                "config has no topology to restrict the rebalance to"
            )
        sub = _intra_config(cfg)
        F, fast = sub.num_ranks, len(cfg.level_sizes) - 1
        dev = q.dest.device
        me = comm.ranks(cfg.num_ranks, dev).to(torch.int32)[:, None]
        lane = torch.arange(q.capacity, device=dev)[None, :]
        # pending items carry GLOBAL destinations but the round's rank space
        # is the F lanes of my group: in-group ones translate to their lane,
        # cross-group ones sit the round out and are appended afterwards
        pending = (lane < q.count[:, None]) & (q.dest >= 0)
        in_group = pending & (q.dest // F == me // F)
        held_back = pending & ~in_group
        start, target = plan_rebalance(n_res, F, comm=comm, digits=cfg.level_sizes, tier=fast)
        plan_dest = torch.clamp((start[:, None] + idx) // target[:, None], max=F - 1)
        new_dest = torch.where(resident, plan_dest, torch.where(in_group, q.dest % F, DISCARD))
        q_round = dataclasses.replace(q, dest=new_dest.to(torch.int32))
        res = _forward(q_round, sub, comm=comm, digits=cfg.level_sizes, tier=fast)
        balanced, stats = res[0], (res[-1] if cfg.telemetry else None)
        if sub.overflow == "retain":
            # the retained front carries fast-lane destinations: back to
            # global ranks, beside the held-back pending items
            ret = (lane < balanced.count[:, None]) & (balanced.dest >= 0)
            balanced = dataclasses.replace(
                balanced, dest=torch.where(ret, (me // F) * F + balanced.dest, balanced.dest).to(torch.int32)
            )
        balanced = enqueue(balanced, q.items, q.dest, held_back)
        total = comm.psum(balanced.count)
        return (balanced, total, stats) if cfg.telemetry else (balanced, total)
    if scope != "global":
        raise ValueError(f"unknown rebalance scope {scope!r}")

    if cfg.exchange == "hierarchical":
        plan = plan_rebalance_hierarchical(n_res, cfg.level_sizes, comm=comm)
        new_dest = _hierarchical_dest(plan, plan["start"][:, None] + idx, cfg.level_sizes[-1])
    else:
        start, target = plan_rebalance(n_res, cfg.num_ranks, comm=comm)
        new_dest = torch.clamp((start[:, None] + idx) // target[:, None], max=cfg.num_ranks - 1)
    q = dataclasses.replace(q, dest=torch.where(resident, new_dest, q.dest).to(torch.int32))
    return forward_work(q, cfg, health=health, comm=comm)
