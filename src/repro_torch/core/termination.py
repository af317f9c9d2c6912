"""Distributed-termination drive loop (paper §4.2.3), drop mode, open flow.

The paper's applications loop: launch kernel → ``forwardRays()`` → check the
reduced global count → repeat.  The reference traces the whole loop into
one ``jax.lax.while_loop``; here it is a Python loop whose condition reads
the psum'd in-flight ``total`` once per round — ONE host synchronisation per
round, the only one the drive adds.  Every rank keeps iterating (possibly
with an empty queue) until the global count hits zero: a rank that received
nothing this round may still be sent work later.

Factored like the reference into ``drive_start`` (the initial routing
forward → carry), ``drive_segment`` (body rounds while ``rnd < seg_end``)
and ``drive_finalize`` (carry → results).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.collectives import StackedCollectives
from repro_torch.core.forwarding import ForwardConfig, forward_work
from repro_torch.core.queue import WorkQueue

__all__ = ["drive_finalize", "drive_segment", "drive_start", "run_until_done"]


def drive_start(
    q0: WorkQueue, aux0: Any, cfg: ForwardConfig, *, comm: StackedCollectives | None = None
) -> Dict[str, Any]:
    """The drive's initial forward: route the ray-gen output to its owners
    and build the carry (``q``, ``aux``, ``total``, ``rnd``, ``drops``)."""
    q1, total0 = forward_work(q0, cfg, comm=comm)
    return {"q": q1, "aux": aux0, "total": total0, "rnd": 0, "drops": q1.drops}


def drive_segment(
    round_fn: Callable[..., Tuple[WorkQueue, Any]],
    carry: Dict[str, Any],
    cfg: ForwardConfig,
    *,
    seg_end: int,
    comm: StackedCollectives | None = None,
) -> Dict[str, Any]:
    """Run body rounds while ``total > 0`` and ``rnd < seg_end``."""
    try:
        wants_headroom = "headroom" in inspect.signature(round_fn).parameters
    except (TypeError, ValueError):  # builtins / exotic callables: no gate
        wants_headroom = False
    kw = {"headroom": cfg.capacity} if wants_headroom else {}
    c = dict(carry)
    # the one host sync per round: the loop condition reads the global count
    while c["rnd"] < seg_end and int(c["total"]) > 0:
        q = c["q"]
        # The cumulative drops ride the carry; round_fn sees a zero-drop view
        # so one that threads its input queue's drops cannot double-count.
        view = WorkQueue(items=q.items, dest=q.dest, count=q.count,
                         drops=torch.zeros_like(q.drops))
        fwd_q, c["aux"] = round_fn(view, c["aux"], c["rnd"], **kw)
        new_q, c["total"] = forward_work(fwd_q, cfg, comm=comm)
        c["drops"] = c["drops"] + new_q.drops
        c["q"] = new_q
        c["rnd"] += 1
    return c


def drive_finalize(carry: Dict[str, Any], cfg: ForwardConfig):
    """Carry → ``(final_queue, final_aux, rounds_executed, done)`` with the
    cumulative drops folded into the final queue."""
    del cfg
    q = carry["q"]
    q = WorkQueue(items=q.items, dest=q.dest, count=q.count, drops=carry["drops"])
    return q, carry["aux"], carry["rnd"], bool(int(carry["total"]) == 0)


def run_until_done(
    round_fn: Callable[..., Tuple[WorkQueue, Any]],
    q0: WorkQueue,
    aux0: Any,
    cfg: ForwardConfig,
    *,
    max_rounds: int = 64,
    comm: StackedCollectives | None = None,
) -> Tuple[WorkQueue, Any, int, bool]:
    """Iterate ``round_fn`` + ``forward_work`` until global termination.

    ``round_fn(in_queue, aux, round_idx) -> (out_queue, aux)`` consumes the
    rank-stacked input queue and emits into a fresh output queue.  The
    driver owns the cumulative drop count: the input queue ``round_fn``
    receives always carries zero drops.  Returns ``(final_queue, final_aux,
    rounds_executed, done)``; ``done`` is True when the global in-flight
    count hit zero, False when ``max_rounds`` ran out with work in flight.
    """
    carry = drive_start(q0, aux0, cfg, comm=comm)
    carry = drive_segment(round_fn, carry, cfg, seg_end=max_rounds, comm=comm)
    return drive_finalize(carry, cfg)
