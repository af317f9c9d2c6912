"""Preemption-tolerant drive loop (the recovery law) over rank-stacked
tensors — the port's ``repro.core.recovery``.

* **Segmented drive** — :func:`run_checkpointed` runs the same rounds as
  ``run_until_done`` (``termination.drive_segment``) in segments of
  ``checkpoint_every`` rounds; at each boundary the carry — queue,
  cumulative drops, retained-row ages, credits, telemetry ring, round
  counter, app aux — is copied to the host (one copy per leaf) and written
  with ``repro_torch.ckpt``'s atomic, integrity-checked writer.
  Segmentation changes only where the host loop pauses, never what a round
  computes, so a resumed trajectory is the uninterrupted one bit for bit.
* **The reference's layout on disk** — the carry is saved leaf for leaf as
  ``repro.core.recovery`` saves its stacked carry: queue leaves ``(R·C,
  …)`` (the port's ``(R, C, …)`` reshaped), ``credits (R·R,)`` (the port's
  ``(R, R)`` row-major, row = holder), ``count``, ``drops``, ``emitted``,
  ``delivered`` and the aux leaves ``(R, …)``, ring leaves ``(R, window,
  …)``, ``rnd`` and ``total`` 0-d int32, the same dtypes and ``meta``.  A
  checkpoint either package writes is one the other restores.
* **Elastic restore** — :func:`resume_run` lands a burst saved on R ranks
  onto R′ ≠ R (or another capacity) by the reference's relayout law,
  computed on whole arrays (:func:`_elastic_restore`).
* **Watchdog** — every boundary checks ``Σ emitted == Σ delivered +
  in-flight + Σ drops`` (:func:`conservation_check`) before it saves.
* **Draining** — ``health`` may be a mask or a host callable ``rnd →
  mask``, re-read at every boundary.

The port has no compiled program and no ``shard_map``: a segment is the
host-looped ``drive_segment`` up to ``min(rnd + checkpoint_every,
max_rounds)``, and there are no ``aux_specs``.  Results stay on the
context's device.

Over a ``DistributedCollectives`` world (``ctx.comm``) the carry is the
process's block of ranks.  At a boundary the carry is gathered whole
(``comm.gather_tree``, off the call recorder) in every process: the
watchdog, a law over all ranks, reads the whole counters, and process 0
alone writes the whole carry in the stacked layout (and prunes), then
every process waits at a barrier, so a world's files equal the stacked
run's byte for byte.  A resume reads the whole tree in every process,
relayouts it if elastic, and cuts it to the process's block
(``comm.shard_tree``): a checkpoint any world wrote resumes in any
world whose size divides the rank count.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import ckpt
from repro_torch.ckpt import checkpoint as CK
from repro_torch.core import queue as Q
from repro_torch.core import termination as term
from repro_torch.core import types as T
from repro_torch.obs import trace as OT
from repro_torch.telemetry import stats as TS

__all__ = ["conservation_check", "resume_run", "run_checkpointed"]

_SCHEMA = "rafi-drive-carry-v1"
_M32 = 0xFFFFFFFF


def _map(fn: Callable, tree: Any) -> Any:
    leaves, treedef = ckpt.tree_flatten(tree)
    return ckpt.tree_unflatten(treedef, [fn(a) for a in leaves])


# ----------------------------------------------------------------- watchdog
def conservation_check(carry: Dict[str, Any], *, where: str = "") -> None:
    """Raise ``RuntimeError`` unless the stacked carry closes the books:
    ``Σ emitted == Σ delivered + in-flight + Σ drops`` (uint64 sums of the
    int32 per-rank counters)."""
    emitted = int(CK.to_host(carry["emitted"]).astype(np.uint64).sum())
    delivered = int(CK.to_host(carry["delivered"]).astype(np.uint64).sum())
    inflight = int(CK.to_host(carry["total"]))
    drops = int(CK.to_host(carry["drops"]).astype(np.uint64).sum())
    if emitted != delivered + inflight + drops:
        raise RuntimeError(
            f"conservation violated{' at ' + where if where else ''}: "
            f"emitted={emitted} != delivered={delivered} + "
            f"in-flight={inflight} + drops={drops} "
            f"(leak of {emitted - delivered - inflight - drops} rows) — "
            f"refusing to checkpoint corrupted forwarding state"
        )


# ------------------------------------------------------------ carry plumbing
def _to_disk(carry: Dict[str, Any], cfg) -> Dict[str, Any]:
    """The port's carry in the reference's stacked layout (views, no copy)."""
    R, C = cfg.num_ranks, cfg.capacity
    flat = lambda t: t.reshape((R * C,) + tuple(t.shape[2:]))
    q = carry["q"]
    out = {
        "q": Q.WorkQueue(items=T.tree_map(flat, q.items), dest=flat(q.dest), count=q.count, drops=q.drops),
        "aux": carry["aux"],
        "total": carry["total"],
        "rnd": np.asarray(carry["rnd"], np.int32),
        "drops": carry["drops"],
    }
    if "age" in carry:
        out["age"] = flat(carry["age"])
    if "credits" in carry:
        out["credits"] = carry["credits"].reshape(-1)
    for k in ("ring", "emitted", "delivered"):
        if k in carry:
            out[k] = carry[k]
    return out


def _from_disk(tree: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Inverse of :func:`_to_disk` over restored tensors; ``rnd`` becomes
    the Python int the port's drive counts with."""
    R, C = cfg.num_ranks, cfg.capacity
    split = lambda t: t.reshape((R, C) + tuple(t.shape[1:]))
    q = tree["q"]
    carry = dict(tree)
    carry["q"] = Q.WorkQueue(items=T.tree_map(split, q.items), dest=split(q.dest), count=q.count, drops=q.drops)
    carry["rnd"] = int(tree["rnd"])
    if "age" in tree:
        carry["age"] = split(tree["age"])
    if "credits" in tree:
        carry["credits"] = tree["credits"].reshape(R, R)
    return carry


def _host_carry(carry: Dict[str, Any], cfg) -> Dict[str, Any]:
    """The boundary's host copy: the carry in the reference's layout, one
    device-to-host copy per leaf."""
    return _map(CK.to_host, _to_disk(carry, cfg))


def _ring_zeros(cfg, R: int, device) -> TS.StatsRing:
    return TS.make_ring(TS.num_tiers(cfg), window=cfg.telemetry_window, buckets=cfg.telemetry_buckets,
                        num_ranks=R, device=device)


def _carry_like(ctx, aux_like: Any, *, accounting: bool = True) -> Dict[str, Any]:
    """Host zeros tree with the structure, shapes and dtypes of the carry
    on disk for ``ctx`` — the ``like`` target ``ckpt.restore_checkpoint``
    validates against."""
    cfg = ctx.cfg
    R, C = ctx.num_ranks, cfg.capacity
    i32 = lambda *s: np.zeros(s, np.int32)
    like: Dict[str, Any] = {
        "q": Q.WorkQueue(
            items=T.tree_map(lambda t: np.zeros((R * C,) + tuple(t.shape), CK.np_dtype(t)), ctx.proto),
            dest=i32(R * C), count=i32(R), drops=i32(R),
        ),
        "aux": _map(np.asarray, aux_like),
        "total": i32(),
        "rnd": i32(),
        "drops": i32(R),
    }
    if cfg.overflow == "retain":
        like["age"] = i32(R * C)
    if cfg.flow == "credit":
        like["credits"] = i32(R * R)
    if cfg.telemetry:
        like["ring"] = _map(lambda t: t.numpy(), _ring_zeros(cfg, R, "cpu"))
    if accounting:
        like["emitted"] = i32(R)
        like["delivered"] = i32(R)
    return like


def _meta_of(ctx, rnd: int) -> Dict[str, Any]:
    cfg = ctx.cfg
    return {
        "schema": _SCHEMA,
        "round": int(rnd),
        "num_ranks": int(ctx.num_ranks),
        "capacity": int(cfg.capacity),
        "overflow": cfg.overflow,
        "flow": cfg.flow,
        "telemetry": bool(cfg.telemetry),
        "telemetry_window": int(cfg.telemetry_window),
        "pipeline_shards": int(cfg.pipeline_shards),
    }


def _health_at(health, R: int, rnd: int) -> np.ndarray:
    """Resolve the drive's ``health`` at a segment boundary: ``None`` → all
    healthy; a mask → constant; a host callable ``rnd → mask`` → re-read."""
    if health is None:
        return np.ones((R,), bool)
    if callable(health):
        health = health(rnd)
    h = np.asarray(health).astype(bool)
    if h.shape != (R,):
        raise ValueError(f"health mask shape {h.shape} != ({R},)")
    return h


def _health_tensor(health, R: int, rnd: int, device) -> Optional[torch.Tensor]:
    """The mask a segment runs with; no health argument runs unmasked (the
    all-True mask's remap is the identity, bit for bit)."""
    return None if health is None else torch.from_numpy(_health_at(health, R, rnd)).to(device)


def _finalize(ctx, carry: Dict[str, Any], host: Dict[str, Any], *, step) -> Dict[str, Any]:
    """Carry → result dict (the segmented ``termination.drive_finalize``);
    tensors stay on the carry's device, the totals are the whole world's
    (``host``: the boundary's gathered counters)."""
    cfg = ctx.cfg
    q = carry["q"]
    res: Dict[str, Any] = {
        "q": Q.WorkQueue(items=q.items, dest=q.dest, count=q.count, drops=carry["drops"]),
        "aux": carry["aux"],
        "rounds": int(carry["rnd"]),
        "done": int(carry["total"]) == 0,
        "emitted": int(CK.to_host(host["emitted"]).astype(np.uint64).sum()),
        "delivered": int(CK.to_host(host["delivered"]).astype(np.uint64).sum()),
        "step": step,
        "preempted": False,
    }
    if cfg.overflow == "retain":
        res["age"] = carry["age"]
    if cfg.telemetry:
        res["ring"] = carry["ring"]
    return res


# ------------------------------------------------------------ the host loop
def _drive_loop(ctx, round_fn: Callable, carry, *, ckpt_dir, checkpoint_every: int, max_rounds: int, health,
                keep: int, halt_after_round: Optional[int]):
    """Boundary loop shared by fresh and resumed drives: watchdog → save →
    (maybe simulated preemption) → next segment.  Returns the result dict,
    or ``None`` if the drive halted at a boundary (state is on disk; call
    :func:`resume_run` to continue)."""
    cfg, R, comm = ctx.cfg, ctx.num_ranks, ctx.comm
    dev = carry["q"].dest.device
    last_step = None
    prev_health = None
    while True:
        rnd = carry["rnd"]
        total = int(carry["total"])  # replicated: every process takes the same branches below
        OT.event("recovery.boundary", OT.CAT_RECOVERY, round=rnd, total=total)
        if ckpt_dir is None:
            # nothing is saved: the watchdog's counters are all that leave the card
            host = _map(CK.to_host, comm.gather_tree({k: carry[k] for k in ("emitted", "delivered", "total", "drops")}))
        else:
            host = _host_carry(comm.gather_tree(carry), cfg)
        conservation_check(host, where=f"round {rnd}")
        if ckpt_dir is not None:
            if comm.index == 0:  # one writer; the others read after the barrier
                ckpt.save_checkpoint(ckpt_dir, rnd, host, keep=keep, meta=_meta_of(ctx, rnd))
            comm.barrier()
            last_step = rnd
            if OT.enabled():
                leaves = ckpt.load_manifest(ckpt_dir, rnd).get("leaves", [])
                OT.event(
                    "recovery.save", OT.CAT_RECOVERY, step=rnd, leaves=len(leaves),
                    bytes=sum(int(np.prod(e["shape"]) * np.dtype(e["dtype"]).itemsize) for e in leaves),
                    digest=leaves[0]["sha256"][:16] if leaves else "",
                )
        if total == 0 or rnd >= max_rounds:
            return _finalize(ctx, carry, host, step=last_step)
        seg_end = min(rnd + checkpoint_every, max_rounds)
        if halt_after_round is not None and seg_end > halt_after_round:
            OT.event("recovery.preempt", OT.CAT_RECOVERY, round=rnd, step=last_step)
            return None  # preempted: the boundary just saved is the restart point
        if OT.enabled():
            cur = _health_at(health, R, rnd).tolist()
            if prev_health is not None and cur != prev_health:
                OT.event("health.transition", OT.CAT_HEALTH, round=rnd, before=prev_health, after=cur)
            prev_health = cur
        carry = term.drive_segment(round_fn, carry, cfg, seg_end=seg_end,
                                   health=_health_tensor(health, R, rnd, dev), comm=ctx.comm)


def run_checkpointed(
    ctx,
    round_fn: Callable,
    q0_stacked: Q.WorkQueue,
    aux0,
    *,
    ckpt_dir,
    checkpoint_every: int = 8,
    max_rounds: int = 64,
    health=None,
    keep: int = 3,
    halt_after_round: Optional[int] = None,
) -> Optional[Dict[str, Any]]:
    """Drive ``round_fn`` to termination with a checkpoint every
    ``checkpoint_every`` rounds (each boundary also runs the conservation
    watchdog).  Same contract as ``RafiContext.run_until_done`` (over a
    world, ``q0_stacked`` and ``aux0`` are the process's block), plus:

      * ``ckpt_dir``: checkpoints land here (``None`` → the segmented drive
        with no saves, the baseline for overhead measurement);
      * ``health``: ``(R,) bool`` mask or host callable ``rnd → mask``,
        re-read at every segment boundary (draining / brownout);
      * ``halt_after_round``: simulated preemption — stop at the first
        boundary whose next segment would pass this round and return
        ``None``.

    Returns ``{"q", "aux", "rounds", "done"[, "age"][, "ring"], "emitted",
    "delivered", "step", "preempted"}`` or ``None`` when halted.
    """
    h0 = _health_tensor(health, ctx.num_ranks, 0, q0_stacked.dest.device)
    carry = term.drive_start(q0_stacked, aux0, ctx.cfg, health=h0, comm=ctx.comm, accounting=True)
    with OT.span(
        "recovery.run_checkpointed", OT.CAT_RECOVERY,
        checkpoint_every=checkpoint_every, max_rounds=max_rounds, num_ranks=ctx.num_ranks,
    ) as sp:
        res = _drive_loop(ctx, round_fn, carry, ckpt_dir=ckpt_dir, checkpoint_every=checkpoint_every,
                          max_rounds=max_rounds, health=health, keep=keep, halt_after_round=halt_after_round)
        sp.set(preempted=res is None, rounds=None if res is None else res["rounds"])
    return res


def resume_run(
    ctx,
    round_fn: Callable,
    ckpt_dir,
    *,
    aux_like,
    step: Optional[int] = None,
    checkpoint_every: int = 8,
    max_rounds: int = 64,
    health=None,
    keep: int = 3,
    halt_after_round: Optional[int] = None,
    aux_restore: Optional[Callable] = None,
) -> Optional[Dict[str, Any]]:
    """Continue a checkpointed drive from ``ckpt_dir`` (latest boundary, or
    an explicit ``step``) on ``ctx.device``.

    ``ctx`` is the resume-side context; it may span another rank count or
    capacity than the one that saved (elastic restore, :func:`_elastic_restore`).
    ``aux_like`` is a host zeros-tree of the whole aux in the new rank
    count's shape; on an elastic resume the aux leaves are refitted with
    ``aux_restore(old_aux, R_new)`` if given, else by the modular fold
    (new rank ``r`` sums old ranks ``o ≡ r (mod R′)``).  Over a world every
    process restores the whole carry and keeps its block.
    """
    if step is None:
        step = ckpt.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no published checkpoint under {ckpt_dir}")
    manifest = ckpt.load_manifest(ckpt_dir, step)
    meta = manifest.get("meta", {})
    if meta.get("schema") != _SCHEMA:
        raise ValueError(f"checkpoint at step {step} is not a drive carry (schema={meta.get('schema')!r})")
    cfg = ctx.cfg
    if meta.get("overflow") != cfg.overflow or bool(meta.get("telemetry")) != bool(cfg.telemetry):
        raise ValueError(
            f"resume context disagrees with checkpoint: overflow "
            f"{cfg.overflow!r} vs {meta.get('overflow')!r}, telemetry "
            f"{cfg.telemetry} vs {meta.get('telemetry')}"
        )
    # checkpoints written before the backpressure law have no "flow": open
    if meta.get("flow", "open") != cfg.flow:
        raise ValueError(
            f"resume context disagrees with checkpoint: flow "
            f"{cfg.flow!r} vs {meta.get('flow', 'open')!r}"
        )
    like_new = _carry_like(ctx, aux_like, accounting=True)
    R_old, C_old = int(meta["num_ranks"]), int(meta["capacity"])
    elastic = R_old != ctx.num_ranks or C_old != cfg.capacity
    if not elastic:
        disk = ckpt.restore_checkpoint(ckpt_dir, step, like_new, device=ctx.device)
    else:
        # same structure, other leaf shapes: the new carry's tree with the
        # saved shapes and dtypes from the manifest
        _, treedef = ckpt.tree_flatten(like_new)
        like_old = ckpt.tree_unflatten(
            treedef, [np.zeros(tuple(e["shape"]), np.dtype(e["dtype"])) for e in manifest["leaves"]]
        )
        old = ckpt.restore_checkpoint(ckpt_dir, step, like_old, device=ctx.device)
        disk = _elastic_restore(old, ctx, R_old=R_old, C_old=C_old, aux_restore=aux_restore)
    carry = ctx.comm.shard_tree(_from_disk(disk, cfg), ctx.num_ranks)
    with OT.span(
        "recovery.resume_run", OT.CAT_RECOVERY, step=step, elastic=elastic, num_ranks=ctx.num_ranks,
    ) as sp:
        res = _drive_loop(ctx, round_fn, carry, ckpt_dir=ckpt_dir, checkpoint_every=checkpoint_every,
                          max_rounds=max_rounds, health=health, keep=keep, halt_after_round=halt_after_round)
        sp.set(preempted=res is None, rounds=None if res is None else res["rounds"])
    return res


# ------------------------------------------------------------ elastic restore
def widen(a: torch.Tensor) -> torch.Tensor:
    """An integer tensor as int64; uint32 through its int32 bits (torch has
    few uint32 kernels)."""
    if a.dtype == torch.uint32:
        return a.view(torch.int32).to(torch.int64) & _M32
    return a.to(torch.int64)


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The low 32 bits of an int64 tensor (mod 2³²), cast to ``dtype``."""
    low = x & _M32
    if dtype in (torch.int32, torch.uint32):
        s = (((low + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)
        return s.view(torch.uint32) if dtype == torch.uint32 else s
    return low.to(dtype)


def _fold_rank_counter(a: torch.Tensor, R_new: int) -> torch.Tensor:
    """New rank ``r`` absorbs old ranks ``o ≡ r (mod R_new)`` — the modular
    fold for additive per-rank counters (mod 2³², cast back)."""
    out = torch.zeros((R_new,) + tuple(a.shape[1:]), dtype=torch.int64, device=a.device)
    out.index_add_(0, torch.arange(a.shape[0], device=a.device) % R_new, widen(a))
    return narrow(out, a.dtype)


def _default_aux_restore(aux, R_new: int):
    return _map(lambda a: _fold_rank_counter(a, R_new), aux)


def _deficit_fill(load: torch.Tensor, k: int) -> torch.Tensor:
    """The ranks that ``k`` successive picks of ``argmin(load)`` take, each
    pick adding one to its rank (ties to the lowest rank).  The picks are
    the ``k`` smallest pairs ``(level, rank)`` with ``level ≥ load[rank]``
    in lexicographic order, so they are computed without the loop: find the
    level ``T`` below which every pair is taken, then order the pairs."""
    R = load.numel()
    dev = load.device
    if k == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    base = [int(v) for v in load.tolist()]
    below = lambda t: sum(max(0, t - b) for b in base)  # pairs with level < t
    lo, hi = min(base), min(base) + k  # below(lo) == 0 <= k <= below(hi)
    while lo < hi:  # the largest T with below(T) <= k
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if below(mid) <= k else (lo, mid - 1)
    T, rest = lo, k - below(lo)
    per = [max(0, T - b) for b in base]
    for r in range(R):  # the remaining picks sit at level T, lowest ranks first
        if rest and base[r] <= T:
            per[r] += 1
            rest -= 1
    n = torch.tensor(per, dtype=torch.int64, device=dev)
    rank = torch.repeat_interleave(torch.arange(R, device=dev), n)
    start = torch.cumsum(n, 0) - n
    level = load.to(torch.int64)[rank] + torch.arange(k, device=dev) - start[rank]
    return rank[torch.argsort(level * R + rank)]


def _elastic_restore(old: Dict[str, Any], ctx, *, R_old: int, C_old: int, aux_restore) -> Dict[str, Any]:
    """Relayout a carry saved on ``R_old`` ranks (the on-disk layout, as
    tensors) onto ``ctx``'s rank count and capacity.

    The reference's relayout law, computed on whole arrays and equal to it
    placement for placement:

      * rows resident on a surviving rank (``o < R′``) stay put;
      * rows stranded on retired ranks are dealt, in old-rank / lane order,
        each to the survivor with the fewest rows (ties → lowest rank);
      * destinations addressed beyond R′ are re-pointed by the same
        deficit-fill rule over the pending per-destination load;
      * per rank, retained rows (``dest >= 0``) are packed first, keeping
        their order and ages, then residents with age 0 (a stable sort on
        ``(new_rank, dest < 0)``);
      * rows past the new capacity are counted into ``drops``;
      * the telemetry ring restarts empty, credits restart at zero;
      * ``emitted`` / ``delivered`` / ``drops`` fold modularly.
    """
    cfg = ctx.cfg
    R_new, C_new = ctx.num_ranks, cfg.capacity
    retain = cfg.overflow == "retain"
    q = old["q"]
    dev = q.dest.device
    counts = q.count.to(torch.int64)
    lane = torch.arange(C_old, device=dev)
    gl = torch.nonzero((lane[None, :] < counts[:, None]).reshape(-1)).squeeze(1)  # (old rank, lane) order
    o = gl // C_old
    d = q.dest[gl].to(torch.int64)
    ones = torch.ones_like(d)

    # re-destinate addresses beyond the new rank count by deficit fill over
    # the pending per-destination load
    inrange = (d >= 0) & (d < R_new)
    load = torch.zeros(R_new, dtype=torch.int64, device=dev).index_add_(0, d[inrange], ones[inrange])
    far = torch.nonzero(d >= R_new).squeeze(1)
    d[far] = _deficit_fill(load, far.numel())

    # deal stranded rows to survivors, emptiest first
    stay = o < R_new
    occ = torch.zeros(R_new, dtype=torch.int64, device=dev).index_add_(0, o[stay], ones[stay])
    nr = o.clone()
    strand = torch.nonzero(~stay).squeeze(1)
    nr[strand] = _deficit_fill(occ, strand.numel())

    # pack per new rank: retained first (stable), cut at capacity → drops
    order = torch.sort(nr * 2 + (d < 0).to(torch.int64), stable=True).indices
    nr_s = nr[order]
    per = torch.zeros(R_new, dtype=torch.int64, device=dev).index_add_(0, nr_s, torch.ones_like(nr_s))
    j = torch.arange(nr_s.numel(), device=dev) - (torch.cumsum(per, 0) - per)[nr_s]
    keep = j < C_new
    tl = nr_s[keep] * C_new + j[keep]
    src = gl[order][keep]
    new_count = torch.clamp(per, max=C_new)
    cut = per - new_count

    new_dest = torch.full((R_new * C_new,), Q.DISCARD, dtype=torch.int32, device=dev)
    new_dest[tl] = d[order][keep].to(torch.int32)

    def place(leaf):
        out = torch.zeros((R_new * C_new,) + tuple(leaf.shape[1:]), dtype=leaf.dtype, device=dev)
        out[tl] = leaf[src]
        return out

    new_drops = narrow(widen(_fold_rank_counter(old["drops"], R_new)) + cut, torch.int32)
    aux_fit = aux_restore if aux_restore is not None else _default_aux_restore
    carry: Dict[str, Any] = {
        "q": Q.WorkQueue(items=T.tree_map(place, q.items), dest=new_dest, count=new_count.to(torch.int32),
                         drops=new_drops),  # queue drops mirror the cumulative carry
        "aux": aux_fit(old["aux"], R_new),
        "total": new_count.sum().to(torch.int32),
        "rnd": old["rnd"].to(torch.int32),
        "drops": new_drops,
        "emitted": _fold_rank_counter(old["emitted"], R_new),
        "delivered": _fold_rank_counter(old["delivered"], R_new),
    }
    if retain:
        carry["age"] = place(old["age"])
    if cfg.flow == "credit":
        # cold restart at zero credit: the first resumed round only adverts
        carry["credits"] = torch.zeros(R_new * R_new, dtype=torch.int32, device=dev)
    if cfg.telemetry:
        carry["ring"] = _ring_zeros(cfg, R_new, dev)
    return carry
