"""The cases ``tests/test_torch_dist.py`` runs in every process of a gloo
world, and once on the stacked backend in the test's own process.

Each case is ``fn(comm, inputs) -> {key: numpy array}`` on ``R = 8`` ranks:
keys ``rank.*`` hold the process's block of ranks on their leading axis,
keys ``world.*`` what every process holds whole.  Queues are read on their
lanes below ``count`` only (:func:`queue_out` zeroes the rest), their words
as uint32.  :func:`run_cases` runs the cases in order, each after
``comm.reset()``, and writes each one's arrays, its call record and its
host reads to ``<out_dir>/<case>.p<process>.npz``.  This module imports
neither ``jax`` nor ``repro``: the reference's inputs arrive as numpy
arrays in ``inputs``.
"""
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import chaos as TC
from repro_torch.apps import nbody as NB
from repro_torch.apps import streamlines as SL
from repro_torch.chaos import driver as TD
from repro_torch.core import (
    DISCARD,
    ForwardConfig,
    WorkQueue,
    deliver_by_cycling,
    enqueue,
    forward_work,
    make_queue,
    rebalance,
    run_until_done,
    work_item,
)
from repro_torch.core import types as T
from repro_torch.kernels.rk4_advect import ops as rk4
from repro_torch.launch.dist import gather_tree, shard_tree
from repro_torch.telemetry import stats as TS

R, CAP = 8, 64
DRIVE = dict(ranks=8, rounds=8, emits=256, capacity=2048, slots={"drop": 256, "retain": 32})
STREAMLINES = dict(num_particles=32, max_steps=16, dt=0.1)
FIELDS = {"abc": rk4.ABC, "tornado": rk4.TORNADO, "taylor_green": rk4.TAYLOR_GREEN}
NBODY = dict(num_particles=256, steps=4, dt=5e-4, theta=0.3)


@work_item
@dataclasses.dataclass
class Item:
    val: torch.Tensor  # (2,) f32
    tag: torch.Tensor  # () i32


@work_item
@dataclasses.dataclass
class TItem:
    """The item of ``tests/test_torch_hierarchical.py`` (the reference's
    ``test_core_hierarchical``): a value and the sending rank."""

    val: torch.Tensor  # () f32
    src: torch.Tensor  # () i32


def global_queue(seed: int, *, kind: str = "random") -> WorkQueue:
    """A seeded ``(R, CAP)`` queue: random destinations with DISCARD and
    out-of-range lanes and random counts, or every lane to rank 0."""
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(R, CAP, 2)).astype(np.float32)
    tag = np.arange(R * CAP, dtype=np.int32).reshape(R, CAP)
    if kind == "hot":
        dest, count = np.zeros((R, CAP), np.int32), np.full(R, CAP, np.int32)
    else:
        dest = rng.integers(-1, R + 1, (R, CAP)).astype(np.int32)
        count = rng.integers(CAP // 2, CAP + 1, R).astype(np.int32)
    t = torch.from_numpy
    return WorkQueue(items=Item(val=t(val), tag=t(tag)), dest=t(dest), count=t(count),
                     drops=torch.zeros(R, dtype=torch.int32))


def queue_out(q: WorkQueue, key: str) -> dict:
    """A queue's count, drops, and its words and destinations on the lanes
    below count (zero and DISCARD past it)."""
    words, _ = T.pack_payload(q.items, batch_dims=2)
    live = torch.arange(q.capacity)[None, :] < q.count[:, None]
    words = torch.where(live[:, :, None], words, 0)
    return {f"rank.{key}.count": q.count.numpy(), f"rank.{key}.drops": q.drops.numpy(),
            f"rank.{key}.words": words.numpy().view(np.uint32),
            f"rank.{key}.dest": torch.where(live, q.dest, DISCARD).numpy()}


def stats_out(stats, key: str) -> dict:
    return {f"rank.{key}.{f.name}": getattr(stats, f.name).numpy() for f in dataclasses.fields(stats)}


def forward_out(res, cfg: ForwardConfig, key: str = "fwd") -> dict:
    """``forward_work``'s outputs: the queue, the world's total, the ages
    (on lanes below count), the credits and the stats rows."""
    res = list(res)
    q = res.pop(0)
    out = queue_out(q, key)
    out[f"world.{key}.total"] = np.asarray(int(res.pop(0)))
    if cfg.overflow == "retain":
        live = torch.arange(q.capacity)[None, :] < q.count[:, None]
        out[f"rank.{key}.age"] = torch.where(live, res.pop(0), 0).numpy()
    if cfg.flow == "credit":
        out[f"rank.{key}.credits"] = res.pop(0).numpy()
    if cfg.telemetry:
        out.update(stats_out(res.pop(0), key))
    assert not res
    return out


# ------------------------------------------------------------- the rounds
ROUNDS = {  # name -> (queue seed, queue kind, ForwardConfig keywords)
    "padded_sort": (0, "random", dict(peer_capacity=6)),
    "padded_scatter": (0, "random", dict(peer_capacity=6, marshal="scatter")),
    "padded_hot": (1, "hot", dict(peer_capacity=CAP)),
    "onehot_sort": (2, "random", dict(exchange="onehot")),
    "onehot_scatter": (2, "random", dict(exchange="onehot", marshal="scatter")),
    "hier_2x4_sort": (3, "random", dict(exchange="hierarchical", level_sizes=(2, 4), level_capacities=(20, 6))),
    "hier_2x4_scatter": (3, "random", dict(exchange="hierarchical", level_sizes=(2, 4), level_capacities=(20, 6),
                                           marshal="scatter")),
    "hier_2x2x2_sort": (4, "random", dict(exchange="hierarchical", level_sizes=(2, 2, 2),
                                          level_capacities=(24, 12, 8))),
    "hier_2x2x2_scatter": (4, "random", dict(exchange="hierarchical", level_sizes=(2, 2, 2),
                                             level_capacities=(24, 12, 8), marshal="scatter")),
    "ragged_sort": (5, "random", dict(exchange="ragged")),
    "ragged_scatter": (5, "random", dict(exchange="ragged", marshal="scatter")),
    "ragged_hot": (1, "hot", dict(exchange="ragged")),
    "credit_padded": (6, "random", dict(peer_capacity=8, overflow="retain", flow="credit")),
    "credit_ragged": (6, "random", dict(exchange="ragged", overflow="retain", flow="credit")),
    "credit_hier_2x2x2": (6, "random", dict(exchange="hierarchical", level_sizes=(2, 2, 2),
                                            level_capacities=(8, 8, 8), overflow="retain", flow="credit")),
    "shards2_padded": (7, "random", dict(peer_capacity=8, pipeline_shards=2)),
    "shards2_ragged": (7, "random", dict(exchange="ragged", pipeline_shards=2, overflow="retain")),
    "shards2_hier_2x2x2": (7, "random", dict(exchange="hierarchical", level_sizes=(2, 2, 2),
                                             level_capacities=(8, 8, 8), pipeline_shards=2)),
    "drop_padded": (8, "random", dict(peer_capacity=3)),
    "retain_padded_sort": (8, "random", dict(peer_capacity=3, overflow="retain")),
    "retain_padded_scatter": (8, "random", dict(peer_capacity=3, overflow="retain", marshal="scatter")),
    "retain_hier_2x4": (8, "random", dict(exchange="hierarchical", level_sizes=(2, 4), level_capacities=(6, 3),
                                          overflow="retain")),
    "telemetry_padded": (9, "random", dict(peer_capacity=6, telemetry=True)),
    "telemetry_ragged": (9, "random", dict(exchange="ragged", telemetry=True, overflow="retain")),
    "telemetry_hier_2x2x2": (9, "random", dict(exchange="hierarchical", level_sizes=(2, 2, 2),
                                               level_capacities=(8, 8, 8), telemetry=True, overflow="retain")),
    "health_padded_sort": (10, "random", dict(peer_capacity=8)),
    "health_padded_scatter": (10, "random", dict(peer_capacity=8, marshal="scatter", overflow="retain")),
    "health_hier_2x2x2": (10, "random", dict(exchange="hierarchical", level_sizes=(2, 2, 2))),
}
HEALTH = np.array([True, True, True, False, True, True, True, True])  # rank 3 down


def _round_case(name):
    seed, kind, kw = ROUNDS[name]
    cfg = ForwardConfig(R, CAP, **kw)

    def fn(comm, inputs):
        q = shard_tree(global_queue(seed, kind=kind), comm, R)
        extra = {}
        if cfg.flow == "credit":  # carried estimates, some exhausted, some negative
            rng = np.random.default_rng(seed + 100)
            extra["credits"] = comm.local(torch.from_numpy(rng.integers(-2, CAP, (R, R)).astype(np.int32)))
        if name.startswith("health"):
            extra["health"] = torch.from_numpy(HEALTH)
        return forward_out(forward_work(q, cfg, comm=comm, **extra), cfg)

    return fn


# ------------------------------------------------------------- the drives
def drive_scenario():
    d = DRIVE
    return TC.rotating_hotspot(d["ranks"], d["rounds"], d["emits"])


def _scenario_round_fn(comm, sc, capacity):
    """``chaos.driver``'s round function with the rank identity of the
    process's ranks: fold the arrivals into the per-rank checksums, emit
    schedule row ``rnd + 1``."""
    Rs, E = sc.num_ranks, sc.emits_per_round
    dests = torch.from_numpy(np.asarray(sc.dests, np.int32))
    me = comm.ranks(Rs)[:, None]
    lane = torch.arange(capacity)[None, :]
    e_idx = torch.arange(E)[None, :]

    def round_fn(q_in, aux, rnd):
        aux = TD._fold_arrivals(q_in, *aux, lane)
        er = rnd + 1
        row = dests[min(max(er, 0), sc.rounds - 1)][me[:, 0]]
        mask = (row >= 0) & (er < sc.rounds)
        uid = ((er * Rs + me) * E + e_idx).to(torch.int32)
        out = make_queue(TD.chaos_proto(), capacity, num_ranks=me.shape[0], device="cpu")
        return enqueue(out, TD.ChaosItem(uid=uid, val=TD._val_of(uid)), torch.where(mask, row, DISCARD), mask), aux

    return round_fn


def _drive_case(overflow):
    def fn(comm, inputs):
        sc, C = drive_scenario(), DRIVE["capacity"]
        cfg = ForwardConfig(R, C, peer_capacity=DRIVE["slots"][overflow], overflow=overflow, telemetry=True,
                            telemetry_window=65)
        q0 = shard_tree(TD._seed_queue(sc, C, device="cpu"), comm, R)
        res = run_until_done(_scenario_round_fn(comm, sc, C), q0, TD._aux0(comm.local_ranks(R), "cpu"), cfg,
                             max_rounds=64, comm=comm)
        q, aux, rounds, done = res[:4]
        trace = TS.ring_trace(gather_tree(res[-1], comm))
        out = queue_out(q, "drive")
        out.update({"rank.drive.delivered": torch.stack(list(aux), dim=1).numpy(),
                    "world.drive.rounds": np.asarray(rounds), "world.drive.done": np.asarray(done),
                    "world.drive.retained_trace": np.asarray(trace["retained_rows"]),
                    "world.drive.age_trace": np.asarray(trace["age_max"])})
        out.update(stats_out(res[-1].stats, "drive.ring"))
        return out

    return fn


# ---------------------------------------------------- cycling, rebalance
def _cycle_case(marshal, overflow):
    cfg = ForwardConfig(R, CAP, marshal=marshal, overflow=overflow, telemetry=True)

    def fn(comm, inputs):
        q = shard_tree(global_queue(11), comm, R)
        absorbed, total, ring = deliver_by_cycling(q, cfg, comm=comm)
        out = queue_out(absorbed, "absorbed")
        out["world.total"] = np.asarray(int(total))
        out.update(stats_out(ring.stats, "ring"))
        return out

    return fn


def _rebalance_queue(counts, pending):
    """Residents ``[0, counts[r])`` of each rank, the first ``pending``
    lanes addressed to the next rank (and the second, on a 2×4 layout, to
    the other node), the rest DISCARD."""
    me, k = np.arange(R)[:, None], np.arange(CAP)[None, :]
    count = np.asarray(counts, np.int32)
    dest = np.full((R, CAP), DISCARD, np.int32)
    if pending:
        dest = np.select([k == 0, k == 1], [(me // 4) * 4 + (me + 1) % 4, (me + 4) % R], DISCARD)
    dest = np.where(k < count[:, None], dest, DISCARD).astype(np.int32)
    val = np.stack([me * 100.0 + k, -k + 0.0 * me], axis=-1).astype(np.float32)
    t = torch.from_numpy
    return WorkQueue(items=Item(val=t(val), tag=t((me * CAP + k).astype(np.int32))), dest=t(dest), count=t(count),
                     drops=torch.zeros(R, dtype=torch.int32))


REBALANCE = {  # name -> (ForwardConfig keywords, scope, counts, pending, health)
    "flat_global": (dict(), "global", [40, 8, 0, 0, 0, 0, 0, 0], True, None),
    "flat_evacuate": (dict(), "global", [9, 9, 9, 30, 9, 9, 9, 9], False, HEALTH),
    "hier_2x4_global": (dict(exchange="hierarchical", level_sizes=(2, 4)), "global", [20, 0, 0, 0, 20, 0, 0, 0],
                        False, None),
    "hier_2x2x2_global": (dict(exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(256, 128, 64),
                               marshal="scatter"), "global", [41, 0, 0, 7, 0, 3, 0, 0], False, None),
    "hier_2x4_intra": (dict(exchange="hierarchical", level_sizes=(2, 4)), "intra", [4, 2, 2, 2, 4, 2, 2, 2], True,
                       None),
    "hier_2x2x2_intra_retain": (dict(exchange="hierarchical", level_sizes=(2, 2, 2), level_capacities=(64, 64, 3),
                                     overflow="retain", telemetry=True), "intra", [30, 3, 12, 0, 30, 3, 0, 1],
                                False, None),
}


def _rebalance_case(name):
    kw, scope, counts, pending, health = REBALANCE[name]
    cfg = ForwardConfig(R, CAP, **kw)

    def fn(comm, inputs):
        q = shard_tree(_rebalance_queue(counts, pending), comm, R)
        h = None if health is None else torch.from_numpy(health)
        res = list(rebalance(q, cfg, scope=scope, health=h, comm=comm))
        if scope == "intra":  # the intra round returns (q, total[, stats]) under any overflow
            out = queue_out(res[0], "fwd")
            out["world.fwd.total"] = np.asarray(int(res[1]))
            if cfg.telemetry:
                out.update(stats_out(res[2], "fwd"))
            return out
        return forward_out(res, cfg)

    return fn


# ------------------------------------------------------------------- apps
def _streamlines_case(field, seeded_by_reference=False):
    def fn(comm, inputs):
        cfg = SL.StreamlineConfig(field_id=FIELDS[field], **STREAMLINES)
        seeds = inputs.get("streamline_seeds") if seeded_by_reference else None
        traces, lengths, stats = SL.run(cfg, num_ranks=R, seeds=seeds, device="cpu", comm=comm)
        return {"world.traces": traces, "world.lengths": lengths, "world.rounds": np.asarray(stats["rounds"]),
                "world.drops": np.asarray(stats["drops"])}

    return fn


def _nbody_case(comm, inputs):
    pos, vel, stats = NB.run(NB.NBodyConfig(**NBODY), num_ranks=R, device="cpu", comm=comm)
    return {"world.pos": pos, "world.vel": vel, "world.totals": np.asarray(stats["totals"]),
            "world.drops": np.asarray(stats["drops"])}


# ----------------------------------------------- held against the reference
JAX_ROUNDS = {  # name -> ForwardConfig keywords, the reference's config on mesh8 / the 2x4 node mesh
    "jax_padded_sort": dict(peer_capacity=6),
    "jax_padded_scatter": dict(peer_capacity=6, marshal="scatter"),
    "jax_hier_2x4": dict(exchange="hierarchical", level_sizes=(2, 4), level_capacities=(16, 6)),
}


def _jax_round_case(name):
    cfg = ForwardConfig(R, CAP, **JAX_ROUNDS[name])

    def fn(comm, inputs):
        val, dest, counts = (torch.from_numpy(a) for a in inputs["jax_round"])
        src = torch.arange(R, dtype=torch.int32)[:, None].expand(R, CAP).contiguous()
        q = WorkQueue(items=TItem(val=val, src=src), dest=dest, count=counts, drops=torch.zeros(R, dtype=torch.int32))
        nq, total = forward_work(shard_tree(q, comm, R), cfg, comm=comm)
        return {"rank.val": nq.items.val.numpy(), "rank.src": nq.items.src.numpy(), "rank.count": nq.count.numpy(),
                "rank.drops": nq.drops.numpy(), "world.total": np.asarray(int(total))}

    return fn


CASES = {}
CASES.update({f"round_{k}": _round_case(k) for k in ROUNDS})
CASES.update({"drive_drop": _drive_case("drop"), "drive_retain": _drive_case("retain")})
CASES.update({f"cycle_{m}_{o}": _cycle_case(m, o) for m in ("sort", "scatter") for o in ("drop", "retain")})
CASES.update({f"rebalance_{k}": _rebalance_case(k) for k in REBALANCE})
CASES.update({f"streamlines_{f}": _streamlines_case(f) for f in FIELDS})
CASES.update({"streamlines_reference_seeds": _streamlines_case("abc", seeded_by_reference=True),
              "nbody": _nbody_case})
CASES.update({k: _jax_round_case(k) for k in JAX_ROUNDS})


def calls_of(comm) -> list:
    """The call record as sorted ``[kind, tier, shape, bytes, count]`` rows."""
    return sorted([c.kind, -1 if c.tier is None else c.tier, list(c.shape), c.nbytes, n]
                  for c, n in comm.calls.items())


def run_case(comm, name, inputs) -> dict:
    comm.reset()
    out = CASES[name](comm, inputs)
    out["calls"] = np.asarray(json.dumps(calls_of(comm)))
    out["host_reads"] = np.asarray(comm.host_reads)
    return out


def run_cases(comm, out_dir, names, inputs) -> None:
    """Every case in ``names``, written to ``<out_dir>/<case>.p<index>.npz``."""
    for name in names:
        np.savez(os.path.join(out_dir, f"{name}.p{comm.index}.npz"), **run_case(comm, name, inputs))


def bad_destination(comm) -> None:
    """Process 0 emits to a rank past the world's and raises in its
    ``enqueue`` check; the others go on to a round and wait in it."""
    L = comm.local_ranks(R)
    q = make_queue(TD.chaos_proto(), CAP, num_ranks=L, device="cpu")
    dest = torch.full((L, 4), R if comm.index == 0 else 0, dtype=torch.int32)
    items = TD.ChaosItem(uid=torch.zeros(L, 4, dtype=torch.int32), val=torch.zeros(L, 4, 2))
    q = enqueue(q, items, dest, torch.ones(L, 4, dtype=torch.bool), num_ranks=R)
    forward_work(q, ForwardConfig(R, CAP), comm=comm)


def hang(comm) -> None:
    """Process 1 never reaches the collective process 0 waits in."""
    if comm.index == 1:
        time.sleep(3600)
    comm.psum(torch.ones(comm.local_ranks(R)))
