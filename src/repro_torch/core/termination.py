"""Distributed-termination drive loop (paper §4.2.3), open flow.

The paper's applications loop: launch kernel → ``forwardRays()`` → check the
reduced global count → repeat.  The reference traces the whole loop into
one ``jax.lax.while_loop``; here it is a Python loop whose condition reads
the psum'd in-flight ``total`` once per round — ONE host synchronisation per
round, the only one the drive adds.  Every rank keeps iterating (possibly
with an empty queue) until the global count hits zero: a rank that received
nothing this round may still be sent work later.

Spill and retry (``overflow="retain"``): ``forward_work`` hands back
clamp-cut rows at the FRONT of the queue with their ``dest`` intact.  The
drive keeps them out of ``round_fn``'s way — the app sees an arrivals-only
view — and merges them back (retained first, so the stable marshal gives
them FIFO oldest-first send priority) before the next forward, threading
the per-lane ``age`` counter alongside.  Split and merge are branch-free
tensor work: the reference's ``lax.cond`` pass-through equals the shifted
merge bit for bit when nothing is retained, so the port always shifts and
adds no host sync.  The termination ``psum`` counts retained rows, so the
loop cannot end with work still spilled.

Factored like the reference into ``drive_start`` (the initial routing
forward → carry), ``drive_segment`` (body rounds while ``rnd < seg_end``)
and ``drive_finalize`` (carry → results).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core import types as T
from repro_torch.core.collectives import StackedCollectives
from repro_torch.core.forwarding import ForwardConfig, forward_work
from repro_torch.core.queue import DISCARD, WorkQueue

__all__ = ["drive_finalize", "drive_segment", "drive_start", "run_until_done"]


def _split_retained(q: WorkQueue) -> Tuple[torch.Tensor, WorkQueue]:
    """``(n_ret (R,), arrivals_view)``: retained rows sit at each queue's
    FRONT with ``dest >= 0``; the view shifts them out so ``round_fn``
    consumes only the round's arrivals (dest all DISCARD, zero drops)."""
    R, C = q.num_ranks, q.capacity
    lane = torch.arange(C, device=q.dest.device)[None, :]
    n_ret = ((lane < q.count[:, None]) & (q.dest >= 0)).sum(dim=1, dtype=torch.int32)
    src = torch.clamp(lane + n_ret[:, None], 0, C - 1)
    b = torch.arange(R, device=q.dest.device)[:, None]
    view = WorkQueue(
        items=T.tree_map(lambda a: a[b, src], q.items),
        dest=torch.full_like(q.dest, DISCARD),
        count=q.count - n_ret,
        drops=torch.zeros_like(q.drops),
    )
    return n_ret, view


def _merge_retained(
    q: WorkQueue, n_ret: torch.Tensor, out_q: WorkQueue, age: torch.Tensor
) -> Tuple[WorkQueue, torch.Tensor]:
    """Recombine the retained front of ``q`` with ``round_fn``'s output
    queue (retained FIRST).  Emissions that do not fit behind the backlog
    are cut and counted.  Returns ``(merged_queue, age_in)`` for
    ``forward_work``."""
    R, C = q.num_ranks, q.capacity
    lane = torch.arange(C, device=q.dest.device)[None, :]
    tail = torch.clamp(lane - n_ret[:, None], 0, C - 1)
    n_tot = n_ret + out_q.count
    count = torch.clamp(n_tot, max=C)
    front = lane < n_ret[:, None]
    b = torch.arange(R, device=q.dest.device)[:, None]

    def merge_leaf(a, o):
        keep = front.reshape(front.shape + (1,) * (a.dim() - 2))
        return torch.where(keep, a, o[b, tail])

    valid_tail = ~front & (tail < out_q.count[:, None])
    dest = torch.where(front, q.dest, torch.where(valid_tail, out_q.dest[b, tail], DISCARD))
    merged = WorkQueue(
        items=T.tree_map(merge_leaf, q.items, out_q.items),
        dest=dest.to(torch.int32),
        count=count.to(torch.int32),
        drops=(out_q.drops + (n_tot - count)).to(torch.int32),
    )
    return merged, torch.where(front, age, 0).to(torch.int32)


def _fwd(q, age, cfg, comm):
    """``forward_work`` with a uniform return: ``(new_q, total, age_out)``,
    ``age_out`` None in drop mode."""
    if cfg.overflow == "retain":
        return forward_work(q, cfg, age=age, comm=comm)
    new_q, total = forward_work(q, cfg, comm=comm)
    return new_q, total, None


def drive_start(
    q0: WorkQueue, aux0: Any, cfg: ForwardConfig, *, comm: StackedCollectives | None = None
) -> Dict[str, Any]:
    """The drive's initial forward: route the ray-gen output to its owners
    and build the carry (``q``, ``aux``, ``total``, ``rnd``, ``drops``, and
    ``age`` under retain)."""
    q1, total0, age1 = _fwd(q0, None, cfg, comm)
    carry = {"q": q1, "aux": aux0, "total": total0, "rnd": 0, "drops": q1.drops}
    if cfg.overflow == "retain":
        carry["age"] = age1
    return carry


def drive_segment(
    round_fn: Callable[..., Tuple[WorkQueue, Any]],
    carry: Dict[str, Any],
    cfg: ForwardConfig,
    *,
    seg_end: int,
    comm: StackedCollectives | None = None,
) -> Dict[str, Any]:
    """Run body rounds while ``total > 0`` and ``rnd < seg_end``.  A
    ``round_fn`` that declares a ``headroom`` keyword receives the room its
    emissions have: ``capacity``, or under retain ``(R,)`` ``capacity``
    minus each rank's retained rows."""
    try:
        wants_headroom = "headroom" in inspect.signature(round_fn).parameters
    except (TypeError, ValueError):  # builtins / exotic callables: no gate
        wants_headroom = False
    retain = cfg.overflow == "retain"
    c = dict(carry)
    # the one host sync per round: the loop condition reads the global count
    while c["rnd"] < seg_end and int(c["total"]) > 0:
        q = c["q"]
        # The cumulative drops ride the carry; round_fn sees a zero-drop view
        # so one that threads its input queue's drops cannot double-count.
        q = WorkQueue(items=q.items, dest=q.dest, count=q.count, drops=torch.zeros_like(q.drops))
        if retain:
            n_ret, view = _split_retained(q)
            kw = {"headroom": torch.clamp(cfg.capacity - n_ret, min=0)} if wants_headroom else {}
            out_q, c["aux"] = round_fn(view, c["aux"], c["rnd"], **kw)
            fwd_q, age_in = _merge_retained(q, n_ret, out_q, c["age"])
        else:
            kw = {"headroom": cfg.capacity} if wants_headroom else {}
            fwd_q, c["aux"] = round_fn(q, c["aux"], c["rnd"], **kw)
            age_in = None
        new_q, c["total"], age_out = _fwd(fwd_q, age_in, cfg, comm)
        c["drops"] = c["drops"] + new_q.drops
        c["q"] = new_q
        if retain:
            c["age"] = age_out
        c["rnd"] += 1
    return c


def drive_finalize(carry: Dict[str, Any], cfg: ForwardConfig):
    """Carry → ``(final_queue, final_aux, rounds_executed, done)`` with the
    cumulative drops folded into the final queue, plus the final per-lane
    ``age`` under retain."""
    q = carry["q"]
    q = WorkQueue(items=q.items, dest=q.dest, count=q.count, drops=carry["drops"])
    out = (q, carry["aux"], carry["rnd"], bool(int(carry["total"]) == 0))
    if cfg.overflow == "retain":
        out = out + (carry["age"],)
    return out


def run_until_done(
    round_fn: Callable[..., Tuple[WorkQueue, Any]],
    q0: WorkQueue,
    aux0: Any,
    cfg: ForwardConfig,
    *,
    max_rounds: int = 64,
    comm: StackedCollectives | None = None,
) -> Tuple:
    """Iterate ``round_fn`` + ``forward_work`` until global termination.

    ``round_fn(in_queue, aux, round_idx) -> (out_queue, aux)`` consumes the
    rank-stacked input queue and emits into a fresh output queue.  The
    driver owns the cumulative drop count: the input queue ``round_fn``
    receives always carries zero drops.  Returns ``(final_queue, final_aux,
    rounds_executed, done)``; ``done`` is True when the global in-flight
    count hit zero, False when ``max_rounds`` ran out with work in flight.
    Under ``overflow="retain"`` the final per-lane ``age (R, C)`` follows as
    a fifth output: on a truncated run, the live rounds-waiting counters of
    the rows still queued.
    """
    carry = drive_start(q0, aux0, cfg, comm=comm)
    carry = drive_segment(round_fn, carry, cfg, seg_end=max_rounds, comm=comm)
    return drive_finalize(carry, cfg)
