"""Run a chaos scenario through the port's drive loop (the counterpart of
``repro.chaos.driver``).

The driver turns a :class:`repro_torch.chaos.scenarios.Scenario` into a
``RafiContext.run_until_done`` drive over rank-stacked queues: the seed
queue carries round 0's emissions, ``round_fn(…, rnd)`` emits schedule row
``rnd + 1`` (the drive's initial forward consumes row 0, so body round
``rnd`` is emission round ``rnd + 1``) and folds every arrival into
per-rank ``(count, Σuid, Σuid²)`` uint32 checksums — the identity law the
oracle computes from the schedule alone.  Items are never re-forwarded by
the app: one emission, one delivery, so conservation (``emitted ==
delivered + resident + drops + lost`` with ``lost == 0``) is checkable in
every overflow mode and the lossless law (``drops == 0`` too, under
retain) is an array compare.  Round functions work on every rank at once;
the checksums are computed in int64 and kept as uint32, the reference's
dtype, which is part of the checkpoint layout.

:func:`run_scenario_checkpointed` drives the same scenario through the
segmented ``repro_torch.core.recovery`` drive, with an optional simulated
preemption (``preempt_at``), resume on the same or another rank count
(``resume_ranks``, elastic restore) and a per-segment ``health`` mask.
Every checkpoint's manifest carries a SHA-256 per carry leaf, so two runs
can be proven bit-identical at every common boundary from their manifests
alone (:func:`boundary_digests`).

The port's signatures take the scenario's rank count (and ``level_sizes``
for a tiered route) and ``device=`` where the reference takes a mesh.
With ``comm=`` a ``DistributedCollectives`` every process drives its block
of the ranks (the seed queue cut with ``comm.shard_tree``, the rank
identity from ``comm.ranks``) and the result dict is summed from the whole
gathered state (``comm.gather_tree``), the same in every process;
the checkpointed drive writes from process 0 (``core.recovery``).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import ckpt
from repro_torch.chaos.scenarios import Scenario
from repro_torch.ckpt.checkpoint import to_host
from repro_torch.core import queue as Q
from repro_torch.core import recovery
from repro_torch.core.collectives import backend
from repro_torch.core.context import RafiContext
from repro_torch.core.types import work_item
from repro_torch.obs import trace as OT
from repro_torch.telemetry import stats as TS

__all__ = [
    "ChaosItem",
    "boundary_digests",
    "chaos_proto",
    "run_scenario",
    "run_scenario_checkpointed",
]

_M32 = 0xFFFFFFFF


@work_item
@dataclasses.dataclass
class ChaosItem:
    """A forwardable probe: identity for the checksums, a payload tail so
    the wire format moves more than the control word."""

    uid: torch.Tensor  # () i32 — the scenario's (round, rank, lane) identity
    val: torch.Tensor  # (2,) f32 — derived ballast, never checked


def chaos_proto() -> ChaosItem:
    return ChaosItem(uid=torch.zeros((), dtype=torch.int32), val=torch.zeros(2))


def _val_of(uid):
    """Deterministic ballast from the identity (numpy or torch)."""
    if isinstance(uid, np.ndarray):
        f = uid.astype(np.float32)
        return np.stack([f * 0.5, f % 7.0], axis=-1)
    f = uid.to(torch.float32)
    return torch.stack([f * 0.5, f % 7.0], dim=-1)


def _uids(sc: Scenario) -> np.ndarray:
    """``sc.uid(r, rank, e)`` for the whole schedule, ``(rounds, R, E)``."""
    R, E = sc.num_ranks, sc.emits_per_round
    return ((np.arange(sc.rounds)[:, None, None] * R + np.arange(R)[None, :, None]) * E
            + np.arange(E)[None, None, :]).astype(np.int32)


def _seed_queue(sc: Scenario, capacity: int, *, device=None) -> Q.WorkQueue:
    """Round 0's emissions as the rank-stacked queue, clipped at
    ``capacity`` with the clip counted (as a device ``enqueue`` would)."""
    R, C = sc.num_ranks, capacity
    uid0 = _uids(sc)[0]
    uid = np.zeros((R, C), np.int32)
    dest = np.full((R, C), Q.DISCARD, np.int32)
    count = np.zeros((R,), np.int32)
    drops = np.zeros((R,), np.int32)
    for rank in range(R):
        lanes = np.nonzero(sc.dests[0, rank] >= 0)[0]
        n = min(len(lanes), C)
        uid[rank, :n] = uid0[rank, lanes[:n]]
        dest[rank, :n] = sc.dests[0, rank, lanes[:n]]
        count[rank], drops[rank] = n, len(lanes) - n
    t = lambda a: torch.from_numpy(a).to(device)
    return Q.WorkQueue(items=ChaosItem(uid=t(uid), val=t(_val_of(uid))), dest=t(dest), count=t(count),
                       drops=t(drops))


def _make_ctx(
    num_ranks: int,
    *,
    capacity: int,
    overflow: str = "retain",
    exchange: str = "padded",
    marshal: str = "sort",
    sort_method: str = "pack",
    peer_capacity: int = 0,
    fast_size: int = 0,
    level_sizes=(),
    level_capacities=(),
    telemetry: bool = True,
    max_rounds: int = 64,
    pipeline_shards: int = 1,
    flow: str = "open",
    emit_reserve: int = -1,
    device=None,
    comm=None,
) -> RafiContext:
    """The scenario context: ``telemetry_window`` pinned to ``max_rounds+1``
    so the ring records every forward of the burst."""
    return RafiContext(
        num_ranks, chaos_proto(), capacity=capacity, peer_capacity=peer_capacity, exchange=exchange,
        marshal=marshal, sort_method=sort_method, fast_size=fast_size, level_sizes=level_sizes,
        level_capacities=level_capacities, telemetry=telemetry, telemetry_window=max_rounds + 1,
        overflow=overflow, pipeline_shards=pipeline_shards, flow=flow, emit_reserve=emit_reserve,
        device=device, comm=comm,
    )


def _fold_arrivals(q_in: Q.WorkQueue, cnt, s, s2, lane):
    """Add the round's arrivals to the (count, Σuid, Σuid²) checksums."""
    valid = lane < q_in.count[:, None]
    u = q_in.items.uid.to(torch.int64) & _M32
    z = torch.zeros_like(u)
    u32 = lambda acc, add: recovery.narrow(recovery.widen(acc) + add, torch.uint32)
    cnt = u32(cnt, valid.sum(1))
    s = u32(s, torch.where(valid, u, z).sum(1))
    s2 = u32(s2, torch.where(valid, (u * u) & _M32, z).sum(1))
    return cnt, s, s2


def _comm(ctx: RafiContext):
    """The context's backend (a stand-in context without one: stacked)."""
    return backend(getattr(ctx, "comm", None))


def _emit(ctx: RafiContext, uid, row, mask) -> Q.WorkQueue:
    out = Q.make_queue(chaos_proto(), ctx.cfg.capacity, num_ranks=row.shape[0], device=ctx.device)
    return Q.enqueue(out, ChaosItem(uid=uid, val=_val_of(uid)), torch.where(mask, row, Q.DISCARD), mask)


def _make_round_fn(ctx: RafiContext, sc: Scenario):
    """Consume arrivals into the checksums; emit schedule row ``rnd + 1``.
    The emission law is pinned to the scenario's rank count, so a
    drain-phase resume on fewer ranks (elastic restore) keeps the same uid
    identities; past the schedule the mask stops emission and the round is
    a pure consumer on any rank count."""
    R, E = sc.num_ranks, sc.emits_per_round
    dev = ctx.device
    dests = torch.from_numpy(np.asarray(sc.dests, np.int32)).to(dev)  # (rounds, R, E)
    me = _comm(ctx).ranks(ctx.num_ranks, dev)[:, None]
    src = torch.clamp(me, max=R - 1)
    lane = torch.arange(ctx.cfg.capacity, device=dev)[None, :]
    e_idx = torch.arange(E, device=dev)[None, :]

    def round_fn(q_in, aux, rnd):
        aux = _fold_arrivals(q_in, *aux, lane)
        # body round rnd emits schedule row rnd + 1 (row 0 seeded q0); ranks
        # beyond the schedule (elastic resume) emit nothing
        er = rnd + 1
        row = dests[min(max(er, 0), sc.rounds - 1)][src[:, 0]]  # (R', E)
        mask = (row >= 0) & (er < sc.rounds) & (me < R)
        uid = ((er * R + src) * E + e_idx).to(torch.int32)
        return _emit(ctx, uid, row, mask), aux

    return round_fn


def _flat_schedule(sc: Scenario):
    """The schedule flattened per rank in emission order — the layout the
    credit-gated emitter walks with a cursor.  Returns ``(dest (R, K) i32,
    uid (R, K) i32, prefix (R, rounds) i32)``: ``prefix[rank, r]`` counts
    the entries of rounds ``0..r``, ``K`` is the longest per-rank list
    (short ranks are zero-padded; the cursor never reaches the pad)."""
    R = sc.num_ranks
    d = np.asarray(sc.dests).transpose(1, 0, 2).reshape(R, -1)  # rank, then round, then lane
    uid = _uids(sc).transpose(1, 0, 2).reshape(R, -1)
    valid = d >= 0
    n = valid.sum(axis=1)
    K = max(1, int(n.max()))
    order = np.argsort(~valid, axis=1, kind="stable")[:, :K]  # valid entries first, in order
    keep = np.arange(K)[None, :] < n[:, None]
    dest = np.where(keep, np.take_along_axis(d, order, 1), 0).astype(np.int32)
    uids = np.where(keep, np.take_along_axis(uid, order, 1), 0).astype(np.int32)
    prefix = np.cumsum((np.asarray(sc.dests) >= 0).sum(axis=2), axis=0).T.astype(np.int32)
    return dest, uids, prefix


def _make_gated_round_fn(ctx: RafiContext, sc: Scenario):
    """The credit-flow emitter: the same consumption law as
    :func:`_make_round_fn`, but each rank walks its flattened schedule with
    a cursor and emits ``min(backlog, headroom)`` entries a round, the
    drive's ``headroom`` being its emission budget.  Deferred entries are
    emitted later with the same identities, so the delivered-checksum
    oracle applies unchanged while the emission timing follows receiver
    pressure."""
    R = sc.num_ranks
    dev = ctx.device
    dest_np, uid_np, prefix_np = _flat_schedule(sc)
    K = dest_np.shape[1]
    dest_dev, uid_dev, prefix_dev = (torch.from_numpy(a).to(dev) for a in (dest_np, uid_np, prefix_np))
    me = _comm(ctx).ranks(ctx.num_ranks, dev)
    src = torch.clamp(me, max=R - 1)
    lane = torch.arange(ctx.cfg.capacity, device=dev)[None, :]

    def round_fn(q_in, aux, rnd, headroom=None):
        cnt, s, s2, cursor = aux
        cnt, s, s2 = _fold_arrivals(q_in, cnt, s, s2, lane)
        # due: everything scheduled through row rnd + 1 (row 0 seeded q0);
        # emit the oldest un-emitted entries that fit the round's headroom
        er = min(max(rnd + 1, 0), sc.rounds - 1)
        want = torch.where(me < R, prefix_dev[src, er], 0)
        n = torch.clamp(want - cursor, min=0)
        if headroom is not None:
            n = torch.minimum(n, torch.as_tensor(headroom, device=dev))
        idx = torch.clamp(cursor[:, None] + lane, 0, K - 1)
        mask = lane < n[:, None]
        uid = uid_dev[src[:, None], idx]
        out = _emit(ctx, uid, dest_dev[src[:, None], idx], mask)
        return out, (cnt, s, s2, (cursor + n).to(torch.int32))

    return round_fn


def _aux0(num_ranks: int, device=None):
    return tuple(torch.zeros(num_ranks, dtype=torch.uint32).to(device) for _ in range(3))


def _cursor0(sc: Scenario) -> np.ndarray:
    """Initial per-rank schedule cursor: row 0 is consumed by the seed queue
    (its capacity clips are counted drops, still "emitted")."""
    return (np.asarray(sc.dests[0]) >= 0).sum(axis=1).astype(np.int32)


def _result_dict(sc: Scenario, q, aux, rounds, done, *, cfg=None, ring=None, comm=None) -> Dict:
    """The accounting dict, from the whole state: over a world the queue's
    counters, the aux and the ring are gathered first (off the recorder),
    so every process returns the same dict."""
    count, drops = q.count, q.drops
    if comm is not None:
        count, drops, aux, ring = comm.gather_tree((count, drops, aux, ring))
    cnt, s, s2 = aux[:3]
    delivered = np.stack([to_host(cnt), to_host(s), to_host(s2)], axis=-1).astype(np.uint32)
    # a cursor-gated run (credit flow) truncated by max_rounds may leave
    # entries never emitted: the cursor says how many rows were put in flight
    emitted = int(to_host(aux[3]).astype(np.int64).sum()) if len(aux) > 3 else sc.emitted
    res = {
        "scenario": sc.name,
        "delivered": delivered,
        "delivered_total": int(delivered[:, 0].sum()),
        "emitted": emitted,
        "resident": int(to_host(count).sum()),
        "drops": int(to_host(drops).sum()),
        "rounds": int(rounds),
        "done": bool(done),
    }
    res["lost"] = res["emitted"] - res["delivered_total"] - res["resident"] - res["drops"]
    if ring is not None:
        summary = TS.summarize(ring, tier_capacities=TS.tier_capacities(cfg))
        for k in ("retained_rows", "age_max", "goodput", "emit_overflow", "recv_drops"):
            res[k] = summary[k]
        trace = TS.ring_trace(ring)
        res["retained_trace"] = trace["retained_rows"]
        res["age_trace"] = trace["age_max"]
        res["recv_trace"] = trace["recv_total"]
        res["wire_rows"] = int(np.asarray(trace["recv_total"]).sum())
        res["wasted_wire_rows"] = int(np.asarray(trace["wasted_wire_rows"]).sum())
        res["wasted_trace"] = trace["wasted_wire_rows"]
        # with wasted_trace the complete drop chronology of a retain run:
        # every dropped row is an emission clip or a receiver wire cut
        res["emit_trace"] = trace["emit_overflow"]
    return res


def _check_ranks(ctx: RafiContext, sc: Scenario) -> None:
    if ctx.num_ranks != sc.num_ranks:
        raise ValueError(
            f"scenario is laid out for {sc.num_ranks} ranks but the context has {ctx.num_ranks}"
        )


def _drive_parts(ctx: RafiContext, sc: Scenario):
    """``(round_fn, aux0)`` of the scenario's drive on ``ctx`` (the aux of
    the process's ranks)."""
    comm = _comm(ctx)
    L = comm.local_ranks(ctx.num_ranks)
    if ctx.cfg.flow == "credit":
        cursor = comm.local(torch.from_numpy(_cursor0(sc)).to(ctx.device))
        return _make_gated_round_fn(ctx, sc), _aux0(L, ctx.device) + (cursor,)
    return _make_round_fn(ctx, sc), _aux0(L, ctx.device)


def _seed(ctx: RafiContext, sc: Scenario, capacity: int) -> Q.WorkQueue:
    """The seed queue of the process's ranks."""
    return _comm(ctx).shard_tree(_seed_queue(sc, capacity, device=ctx.device), sc.num_ranks)


def run_scenario(
    num_ranks: int,
    sc: Scenario,
    *,
    capacity: int,
    health=None,
    max_rounds: int = 64,
    device=None,
    comm=None,
    **cfg_kwargs,
) -> Dict:
    """Drive ``sc`` through the configured forwarding stack on ``num_ranks``
    ranks (the scenario's) and return the accounting dict (over a world
    ``comm``, the whole world's, in every process).

    Keys: ``delivered`` (R, 3) uint32 checksums, ``delivered_total``,
    ``emitted``, ``resident``, ``drops``, ``lost``, ``rounds``, ``done`` —
    plus, with telemetry (the default), the burst totals and per-round
    traces of the full-window ring.  ``health`` (optional ``(R,)`` bool
    mask, constant for the burst) re-addresses traffic away from unhealthy
    ranks."""
    ctx = _make_ctx(num_ranks, capacity=capacity, max_rounds=max_rounds, device=device, comm=comm, **cfg_kwargs)
    _check_ranks(ctx, sc)
    cfg = ctx.cfg
    with OT.span(
        "chaos.run_scenario", OT.CAT_CHAOS, scenario=sc.name, num_ranks=num_ranks, capacity=capacity,
        flow=cfg.flow, overflow=cfg.overflow, exchange=cfg.exchange, max_rounds=max_rounds,
    ) as sp:
        mask = None
        if health is not None:
            # fault-injection record: which ranks the burst routes around
            h = np.asarray(health).astype(bool)
            OT.event("chaos.health_mask", OT.CAT_CHAOS, scenario=sc.name,
                     unhealthy=[i for i, v in enumerate(h) if not v])
            mask = torch.from_numpy(h).to(ctx.device)
        rfn, aux0 = _drive_parts(ctx, sc)
        out = ctx.run_until_done(rfn, max_rounds=max_rounds)(_seed(ctx, sc, capacity), aux0, mask)
        q, aux, rounds, done = out[:4]
        ring = out[-1] if cfg.telemetry else None
        res = _result_dict(sc, q, aux, rounds, done, cfg=cfg, ring=ring, comm=ctx.comm)
        sp.set(rounds=res["rounds"], done=res["done"], drops=res["drops"],
               delivered_total=res["delivered_total"], goodput=res.get("goodput"))
    return res


def _steps(ckpt_dir) -> list:
    if ckpt_dir is None or not Path(ckpt_dir).exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in Path(ckpt_dir).iterdir()
                  if p.name.startswith("step_") and not p.name.endswith(".tmp"))


def run_scenario_checkpointed(
    num_ranks: int,
    sc: Scenario,
    *,
    capacity: int,
    ckpt_dir,
    checkpoint_every: int = 4,
    preempt_at: Optional[int] = None,
    resume_ranks: Optional[int] = None,
    resume_capacity: Optional[int] = None,
    health=None,
    keep: int = 64,
    max_rounds: int = 64,
    device=None,
    comm=None,
    **cfg_kwargs,
) -> Dict:
    """Drive ``sc`` through the checkpointed recovery drive (over a world
    ``comm``: every process its block, process 0 writing ``ckpt_dir``).

    * ``preempt_at=None`` — uninterrupted checkpointed run (boundaries land
      on disk every ``checkpoint_every`` rounds).
    * ``preempt_at=k`` — the drive halts at the last boundary not past
      round ``k`` (simulated preemption), then ``recovery.resume_run``
      continues it from disk — on ``resume_ranks`` / ``resume_capacity`` if
      given (the elastic R → R′ path; the scenario must be in its drain
      phase by the preempt boundary, since retired ranks cannot replay
      their scheduled emissions).
    * ``health`` — mask or host callable ``rnd → mask``, re-read at each
      segment boundary (rank brownout mid-burst).

    Returns the :func:`run_scenario` accounting dict plus ``steps`` (the
    published boundary rounds), ``preempted`` and ``ckpt_dir``.
    """
    ctx = _make_ctx(num_ranks, capacity=capacity, max_rounds=max_rounds, device=device, comm=comm, **cfg_kwargs)
    _check_ranks(ctx, sc)
    credit = ctx.cfg.flow == "credit"
    with OT.span(
        "chaos.run_scenario_checkpointed", OT.CAT_CHAOS, scenario=sc.name, num_ranks=ctx.num_ranks,
        capacity=capacity, checkpoint_every=checkpoint_every, max_rounds=max_rounds, flow=ctx.cfg.flow,
        overflow=ctx.cfg.overflow,
    ) as chaos_sp:
        if preempt_at is not None:
            OT.event("chaos.preempt_scheduled", OT.CAT_CHAOS, scenario=sc.name, preempt_at=preempt_at)
        rfn, aux0 = _drive_parts(ctx, sc)
        kw = dict(checkpoint_every=checkpoint_every, max_rounds=max_rounds, health=health, keep=keep)
        res = recovery.run_checkpointed(ctx, rfn, _seed(ctx, sc, capacity), aux0,
                                        ckpt_dir=ckpt_dir, halt_after_round=preempt_at, **kw)
        preempted = res is None
        if preempted:
            rranks = resume_ranks if resume_ranks is not None else num_ranks
            rcap = resume_capacity if resume_capacity is not None else capacity
            ctx = _make_ctx(rranks, capacity=rcap, max_rounds=max_rounds, device=device, comm=comm, **cfg_kwargs)
            OT.event("chaos.elastic_resume", OT.CAT_CHAOS, scenario=sc.name, resume_ranks=rranks,
                     resume_capacity=rcap, elastic=(rranks != sc.num_ranks or rcap != capacity))
            aux_like = tuple(np.zeros((rranks,), np.uint32) for _ in range(3))
            if credit:
                aux_like = aux_like + (np.zeros((rranks,), np.int32),)
            res = recovery.resume_run(ctx, _drive_parts(ctx, sc)[0], ckpt_dir, aux_like=aux_like, **kw)
        out = _result_dict(sc, res["q"], res["aux"], res["rounds"], res["done"], cfg=ctx.cfg, ring=res.get("ring"),
                           comm=ctx.comm)
        out["steps"] = _steps(ckpt_dir)
        out["preempted"] = preempted
        out["ckpt_dir"] = ckpt_dir
        chaos_sp.set(rounds=out["rounds"], done=out["done"], preempted=preempted, boundaries=len(out["steps"]))
    return out


def boundary_digests(ckpt_dir) -> Dict[int, tuple]:
    """``{boundary round: (sha256, …) of every carry leaf}`` for each
    published checkpoint — the bit-exactness witness: two drives whose
    digests agree at a boundary held identical forwarding state there."""
    return {step: tuple(e["sha256"] for e in ckpt.load_manifest(ckpt_dir, step)["leaves"])
            for step in _steps(ckpt_dir)}
