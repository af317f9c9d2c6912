"""Distributed-termination drive loop (paper §4.2.3).

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

Credit flow (``flow="credit"``): the carried ``credits (R, R)`` cold-start
at ZERO, so the first forward only advertises and risks no wire, and ride
the carry from forward to forward.  The emission gate keeps the rank's own
outstanding advert free: the merge cuts emissions past ``limit = capacity −
clip(credits[me, me], 0)`` (counted as ``emit_overflow``), and a
``round_fn`` that asks gets ``headroom = max(limit − n_ret, 0)``.  The cut
is a clamp, not a branch, so the gate adds no host sync.

``health=`` (a constant ``(R,) bool`` mask) re-addresses every forward's
destinations away from unhealthy ranks (``core.health``).

Over a ``DistributedCollectives`` world (``comm=``) the queue, the ages,
the credits (``(L, R)``: row = a local rank) and the ring are the
process's block of L ranks.  The loop condition reads the all-reduced
``total``, so every process leaves the loop in the same round and issues
the same collectives; the drive makes no host branch on a local value.

With ``telemetry=True`` a ``telemetry.StatsRing`` of the last
``telemetry_window`` rounds rides the carry: every forward is pushed,
including the initial routing round, with ``emit_overflow`` stamped by the
drive.  The push selects its slot on the device, so the ring adds no host
sync either.

Factored like the reference into ``drive_start`` (the initial routing
forward → carry), ``drive_segment`` (body rounds while ``rnd < seg_end``)
and ``drive_finalize`` (carry → results).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import types as T
from repro_torch.core.collectives import StackedCollectives, backend
from repro_torch.core.forwarding import ForwardConfig, forward_work
from repro_torch.core.queue import DISCARD, WorkQueue
from repro_torch.telemetry import stats as TS

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
    q: WorkQueue, n_ret: torch.Tensor, out_q: WorkQueue, age: torch.Tensor,
    limit: Optional[torch.Tensor] = None,
) -> Tuple[WorkQueue, torch.Tensor]:
    """Recombine the retained front of ``q`` with ``round_fn``'s output
    queue (retained FIRST).  Emissions that do not fit behind the backlog
    are cut and counted.  Under credit flow ``limit (R,)`` (capacity less
    the rank's outstanding advert) bounds the merged count too: emissions
    never eat room promised to in-flight arrivals; retained rows are never
    cut.  Returns ``(merged_queue, age_in)`` for ``forward_work``."""
    R, C = q.num_ranks, q.capacity
    lane = torch.arange(C, device=q.dest.device)[None, :]
    tail = torch.clamp(lane - n_ret[:, None], 0, C - 1)
    n_tot = n_ret + out_q.count
    count = torch.clamp(n_tot, max=C) if limit is None else torch.minimum(n_tot, torch.maximum(limit, n_ret))
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


def _fwd(q, age, cfg, comm, health=None, credits=None):
    """``forward_work`` with a uniform return: ``(new_q, total, age_out,
    credits_out, stats)``, each None where the config does not make it."""
    out = list(forward_work(q, cfg, age=age, health=health, credits=credits, comm=comm))
    if cfg.overflow != "retain":
        out.insert(2, None)
    if cfg.flow != "credit":
        out.insert(3, None)
    return tuple(out) if cfg.telemetry else tuple(out) + (None,)


def drive_start(
    q0: WorkQueue, aux0: Any, cfg: ForwardConfig, *, health: Optional[torch.Tensor] = None,
    comm: StackedCollectives | None = None, accounting: bool = False,
) -> Dict[str, Any]:
    """The drive's initial forward: route the ray-gen output to its owners
    and build the carry (``q``, ``aux``, ``total``, ``rnd``, ``drops``,
    ``age`` under retain, ``credits`` under credit — the forward ran at zero
    credit, so it shipped nothing and only advertised — and ``ring`` with
    telemetry, whose first push has the input queue's drops as
    ``emit_overflow``).  With ``accounting`` the carry also holds the
    per-rank ``emitted`` / ``delivered`` int32 counters the recovery
    watchdog closes at every boundary: ``emitted`` counts attempted
    emissions (accepted rows plus their enqueue clips), so ``emitted ==
    delivered + in-flight + drops`` holds exactly."""
    credits0 = None
    if cfg.flow == "credit":
        credits0 = torch.zeros(q0.num_ranks, cfg.num_ranks, dtype=torch.int32, device=q0.dest.device)
    q1, total0, age1, credits1, stats0 = _fwd(q0, None, cfg, comm, health, credits0)
    carry = {"q": q1, "aux": aux0, "total": total0, "rnd": 0, "drops": q1.drops}
    if cfg.overflow == "retain":
        carry["age"] = age1
    if cfg.flow == "credit":
        carry["credits"] = credits1
    if cfg.telemetry:
        ring = TS.make_ring(TS.num_tiers(cfg), window=cfg.telemetry_window, buckets=cfg.telemetry_buckets,
                            num_ranks=q0.num_ranks, device=q0.dest.device)
        carry["ring"] = TS.ring_push(ring, TS.attach_emit_overflow(stats0, q0.drops))
    if accounting:
        carry["emitted"] = (q0.count + q0.drops).to(torch.int32)
        carry["delivered"] = torch.zeros_like(carry["emitted"])
    return carry


def drive_segment(
    round_fn: Callable[..., Tuple[WorkQueue, Any]],
    carry: Dict[str, Any],
    cfg: ForwardConfig,
    *,
    seg_end: int,
    health: Optional[torch.Tensor] = None,
    comm: StackedCollectives | None = None,
) -> Dict[str, Any]:
    """Run body rounds while ``total > 0`` and ``rnd < seg_end``.  A
    ``round_fn`` that declares a ``headroom`` keyword receives the room its
    emissions have: ``capacity``; under retain ``(R,)`` ``capacity`` minus
    each rank's retained rows; under credit ``(R,)`` ``capacity`` minus the
    rank's outstanding advert and its retained rows.  The accounting
    counters advance iff they are in ``carry``."""
    try:
        wants_headroom = "headroom" in inspect.signature(round_fn).parameters
    except (TypeError, ValueError):  # builtins / exotic callables: no gate
        wants_headroom = False
    retain = cfg.overflow == "retain"
    credit = cfg.flow == "credit"
    track = "emitted" in carry
    # my own entry of the credits: column = my global rank
    me = backend(comm).ranks(cfg.num_ranks, carry["q"].dest.device)
    c = dict(carry)
    # the one host sync per round: the loop condition reads the global count
    while c["rnd"] < seg_end and int(c["total"]) > 0:
        q = c["q"]
        # The cumulative drops ride the carry; round_fn sees a zero-drop view
        # so one that threads its input queue's drops cannot double-count.
        q = WorkQueue(items=q.items, dest=q.dest, count=q.count, drops=torch.zeros_like(q.drops))
        if retain:
            n_ret, view = _split_retained(q)
            limit = None
            if credit:
                # my outstanding advert: my own entry (the count call hands
                # every rank its own fresh value back)
                own = torch.gather(c["credits"], 1, me[:, None])[:, 0]
                limit = (cfg.capacity - torch.clamp(own, min=0)).to(torch.int32)
                kw = {"headroom": torch.clamp(limit - n_ret, min=0)} if wants_headroom else {}
            else:
                kw = {"headroom": torch.clamp(cfg.capacity - n_ret, min=0)} if wants_headroom else {}
            out_q, c["aux"] = round_fn(view, c["aux"], c["rnd"], **kw)
            fwd_q, age_in = _merge_retained(q, n_ret, out_q, c["age"], limit)
            consumed, attempted = view.count, out_q.count + out_q.drops
        else:
            kw = {"headroom": cfg.capacity} if wants_headroom else {}
            fwd_q, c["aux"] = round_fn(q, c["aux"], c["rnd"], **kw)
            age_in = None
            consumed, attempted = q.count, fwd_q.count + fwd_q.drops
        new_q, c["total"], age_out, credits_out, stats = _fwd(fwd_q, age_in, cfg, comm, health, c.get("credits"))
        c["drops"] = c["drops"] + new_q.drops
        c["q"] = new_q
        if retain:
            c["age"] = age_out
        if credit:
            c["credits"] = credits_out
        if cfg.telemetry:
            # the round's local emission loss: round_fn's enqueue overflow
            # plus the merge's cut, rows lost before the wire
            c["ring"] = TS.ring_push(c["ring"], TS.attach_emit_overflow(stats, fwd_q.drops))
        if track:
            c["emitted"] = (c["emitted"] + attempted).to(torch.int32)
            c["delivered"] = (c["delivered"] + consumed).to(torch.int32)
        c["rnd"] += 1
    return c


def drive_finalize(carry: Dict[str, Any], cfg: ForwardConfig):
    """Carry → ``(final_queue, final_aux, rounds_executed, done)`` with the
    cumulative drops folded into the final queue, plus the final per-lane
    ``age`` under retain and the ``StatsRing`` with telemetry (last)."""
    q = carry["q"]
    q = WorkQueue(items=q.items, dest=q.dest, count=q.count, drops=carry["drops"])
    out = (q, carry["aux"], carry["rnd"], bool(int(carry["total"]) == 0))
    if cfg.overflow == "retain":
        out = out + (carry["age"],)
    if cfg.telemetry:
        out = out + (carry["ring"],)
    return out


def run_until_done(
    round_fn: Callable[..., Tuple[WorkQueue, Any]],
    q0: WorkQueue,
    aux0: Any,
    cfg: ForwardConfig,
    *,
    max_rounds: int = 64,
    health: Optional[torch.Tensor] = None,
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
    the rows still queued.  With ``cfg.telemetry`` the ``StatsRing`` of the
    last ``telemetry_window`` forwards is the last output (a drive of
    ``rounds`` body rounds records ``rounds + 1``).  ``health``, an
    optional constant ``(R,) bool`` mask, re-addresses every forward's
    traffic away from unhealthy ranks.  Under ``flow="credit"`` the credits
    cold-start at zero and the emission gate holds (module docstring).
    """
    carry = drive_start(q0, aux0, cfg, health=health, comm=comm)
    carry = drive_segment(round_fn, carry, cfg, seg_end=max_rounds, health=health, comm=comm)
    return drive_finalize(carry, cfg)
