"""Ground truth for the lossless law: what must arrive, and when (the
port's own copy of ``repro.chaos.oracle``, numpy only).

* :func:`expected_by_rank` reads ONLY the schedule — per-destination
  ``(count, sum(uid), sum(uid²))`` checksums mod 2³². Any lossless routing
  implementation must reproduce these exactly; it knows nothing about
  rounds, capacities or retention, so it cannot share a bug with the code
  under test.
* :func:`simulate_flat_retain` is an exact round-by-round numpy twin of the
  flat padded retain pipeline (the drive's split/merge, the sender clamp's
  FIFO spill, receiver admission, and the ``health`` remap), tracking
  per-forward retained counts and ages: the trajectory, not just the end
  state.
* :func:`simulate_flat_credit` is the same twin for the flat padded CREDIT
  pipeline driven by the cursor-gated emitter (zero-credit cold start,
  grant apportionment, fresh adverts, the emission gate).

Checksum arithmetic is uint32 with wraparound on both sides (Python ints
reduced mod 2³² at the end — homomorphic, so the results are
bit-comparable).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.chaos.scenarios import Scenario

__all__ = ["expected_by_rank", "simulate_flat_credit", "simulate_flat_retain"]

_M32 = 1 << 32


def expected_by_rank(sc: Scenario) -> np.ndarray:
    """``(R, 3) uint32``: per destination rank, the count / uid-sum /
    uid²-sum (mod 2³²) of every item the schedule addresses to it."""
    R = sc.num_ranks
    acc = [[0, 0, 0] for _ in range(R)]
    r_idx, rank_idx, e_idx = np.nonzero(np.asarray(sc.dests) >= 0)
    for r, rank, e in zip(r_idx, rank_idx, e_idx):
        d = int(sc.dests[r, rank, e])
        u = int(sc.uid(int(r), int(rank), int(e)))
        acc[d][0] += 1
        acc[d][1] += u
        acc[d][2] += (u * u) % _M32
    return np.asarray([[c % _M32 for c in row] for row in acc], np.uint32)


def _emit_rows(sc: Scenario, rnd: int) -> List[List[List[int]]]:
    """Round ``rnd``'s fresh emissions per rank as ``[uid, dest, age=0]``
    rows, in emit-lane order (= the stable ``enqueue`` order on device)."""
    rows: List[List[List[int]]] = [[] for _ in range(sc.num_ranks)]
    if not 0 <= rnd < sc.rounds:
        return rows
    for rank in range(sc.num_ranks):
        for e in range(sc.emits_per_round):
            d = int(sc.dests[rnd, rank, e])
            if d >= 0:
                rows[rank].append([int(sc.uid(rnd, rank, e)), d, 0])
    return rows


def _health_table_np(h: np.ndarray) -> np.ndarray:
    """Numpy mirror of ``repro_torch.core.health.health_table`` — ONE remap law,
    verified twice (any divergence here fails the brownout trajectory
    tests, not just an end-state checksum)."""
    h = np.asarray(h, bool)
    R = h.shape[0]
    table = np.arange(R)
    healthy = np.nonzero(h)[0]
    if healthy.size == 0:
        return table
    for d in range(R):
        if not h[d]:
            table[d] = healthy[d % healthy.size]
    return table


def simulate_flat_retain(
    sc: Scenario,
    *,
    peer_capacity: int,
    capacity: int,
    max_rounds: int = 64,
    health=None,
) -> Dict:
    """Exact numpy twin of ``run_until_done`` over a flat padded exchange
    with ``overflow="retain"`` — same event order the device executes:

      seed queue = round-0 emissions (clipped at ``capacity``, clip counted
      as drops) → forward → loop [deliver arrivals; append round ``rnd+1``
      emissions behind the retained front; forward] while the global
      in-flight count is positive and ``rnd < max_rounds``.

    A forward clamps each sender's per-destination traffic at
    ``peer_capacity`` rows in stable lane order (excess rows are retained
    with ``age + 1``), concatenates arrivals in source-rank order, and
    admits them behind the retained front up to ``capacity`` (excess is a
    counted receiver drop — sized away in the lossless gate).

    ``health`` mirrors the device's rank-draining remap: ``None``, a
    constant ``(R,) bool`` mask, or a callable ``forward_idx -> mask``
    (forward 0 is the seed routing; forward ``f >= 1`` is body round
    ``f - 1``'s).  At every forward the CURRENT mask's
    :func:`_health_table_np` rewrite is applied to each row's destination
    and sticks (retained rows carry the remapped dest onward — exactly what
    ``forward_work`` does to the queue's dest vector).

    Returns the final delivered checksums plus the per-forward
    ``retained_rows`` / ``age_max`` trajectories the device telemetry must
    reproduce."""
    R, C, S = sc.num_ranks, capacity, peer_capacity
    delivered = [[0, 0, 0] for _ in range(R)]
    drops = 0
    retained_trace: List[int] = []
    age_trace: List[int] = []
    fwd_idx = [0]

    def _mask_at(f: int):
        if health is None:
            return None
        return np.asarray(health(f) if callable(health) else health, bool)

    def forward(state):
        """state: per-rank [uid, dest, age] rows (retained front + fresh).
        Returns per-rank (retained_rows, arrival_uids) and the global
        in-flight total after the exchange."""
        nonlocal drops
        h = _mask_at(fwd_idx[0])
        fwd_idx[0] += 1
        if h is not None:
            table = _health_table_np(h)
            for rows in state:
                for row in rows:
                    row[1] = int(table[row[1]])
        shipped = [[[] for _ in range(R)] for _ in range(R)]  # [src][dst]
        retained = []
        for src in range(R):
            sent = [0] * R
            keep = []
            for uid, d, age in state[src]:
                if sent[d] < S:
                    sent[d] += 1
                    shipped[src][d].append(uid)
                else:
                    keep.append([uid, d, age + 1])
            retained.append(keep)
        out = []
        total = 0
        for dst in range(R):
            arrivals = [u for src in range(R) for u in shipped[src][dst]]
            keep = retained[dst]
            admit = min(len(arrivals), C - len(keep))
            drops += len(arrivals) - admit
            out.append((keep, arrivals[:admit]))
            total += len(keep) + admit
        retained_trace.append(sum(len(k) for k, _ in out))
        age_trace.append(max((r[2] for k, _ in out for r in k), default=0))
        return out, total

    # seed queue: round-0 emissions, clipped at capacity
    state = []
    for rank in range(R):
        rows = _emit_rows(sc, 0)[rank]
        drops += max(0, len(rows) - C)
        state.append(rows[:C])
    cur, total = forward(state)

    rnd = 0
    while total > 0 and rnd < max_rounds:
        emits = _emit_rows(sc, rnd + 1)
        state = []
        for rank in range(R):
            keep, arrivals = cur[rank]
            for u in arrivals:
                delivered[rank][0] += 1
                delivered[rank][1] += u
                delivered[rank][2] += (u * u) % _M32
            rows = keep + emits[rank]
            drops += max(0, len(rows) - C)
            state.append(rows[:C])
        cur, total = forward(state)
        rnd += 1

    return {
        "delivered": np.asarray(
            [[c % _M32 for c in row] for row in delivered], np.uint32
        ),
        "drops": drops,
        "rounds": rnd,
        "done": total == 0,
        "resident": total,
        "retained_trace": retained_trace,
        "age_trace": age_trace,
        "age_max": max(age_trace, default=0),
        "retained_rows": sum(retained_trace),
    }


def simulate_flat_credit(
    sc: Scenario,
    *,
    peer_capacity: int,
    capacity: int,
    emit_reserve: int = -1,
    max_rounds: int = 64,
) -> Dict:
    """Exact numpy twin of the flat padded CREDIT pipeline driven
    by the cursor-gated emitter — the same event order the device executes,
    round for round:

      * credits cold-start at ZERO (the first forward is advert-only);
      * each forward, sender ``src`` may ship at most
        ``min(peer_capacity, free[d]//R + (src < free[d]%R))`` rows to
        destination ``d`` (``free`` = the receivers' one-round-stale
        adverts), excess retained FIFO with ``age + 1``;
      * each receiver's fresh advert is
        ``max(clip(C - front - reserve, 0), min(C - front, R))`` — room
        behind the retained front, minus the local-emission reserve, floored
        at one credit PER SENDER whenever room exists (the liveness floor);
      * the app's emission is gated at ``max((C - own_advert) - n_ret, 0)``
        and walks the flattened schedule with a cursor (deferred rows keep
        their identities — the delivered checksums equal
        :func:`expected_by_rank` exactly on a completed run).

    The backpressure law this twin witnesses: receiver admission NEVER
    drops a row (``drops`` stays at the seed-clip count), occupancy stays
    bounded by construction, and every schedule entry is eventually
    delivered.  Returns the :func:`simulate_flat_retain` dict plus
    ``recv_trace`` / ``wire_rows`` / ``recv_drops`` (wire accounting) and
    ``advert_trace`` (per-forward fresh adverts, for the apportionment
    property tests)."""
    R, C, S = sc.num_ranks, capacity, peer_capacity
    E = sc.emits_per_round
    reserve = C // 2 if emit_reserve < 0 else emit_reserve
    delivered = [[0, 0, 0] for _ in range(R)]
    drops = 0
    retained_trace: List[int] = []
    age_trace: List[int] = []
    recv_trace: List[int] = []
    recv_drop_trace: List[int] = []
    advert_trace: List[Tuple[int, ...]] = []

    # flattened per-rank schedule + prefix counts (the gated emitter's law)
    flat: List[List[List[int]]] = [[] for _ in range(R)]
    prefix = np.zeros((R, sc.rounds), np.int64)
    for r in range(sc.rounds):
        for rank in range(R):
            for e in range(E):
                d = int(sc.dests[r, rank, e])
                if d >= 0:
                    flat[rank].append([int(sc.uid(r, rank, e)), d])
        prefix[:, r] = [len(flat[rank]) for rank in range(R)]

    def forward(state, credits):
        """One credit forward: grant → clamp/retain → ship → admit → fresh
        adverts.  Returns per-rank (retained, arrivals), total, adverts."""
        nonlocal drops
        free = np.maximum(credits, 0)
        shipped = [[[] for _ in range(R)] for _ in range(R)]  # [src][dst]
        retained = []
        for src in range(R):
            allow = [
                min(S, int(free[d]) // R + (1 if src < int(free[d]) % R else 0))
                for d in range(R)
            ]
            sent = [0] * R
            keep = []
            for uid, d, age in state[src]:
                if sent[d] < allow[d]:
                    sent[d] += 1
                    shipped[src][d].append(uid)
                else:
                    keep.append([uid, d, age + 1])
            retained.append(keep)
        out = []
        total = 0
        fresh = np.zeros((R,), np.int64)
        arrivals_total = 0
        rdrops = 0
        for dst in range(R):
            arrivals = [u for src in range(R) for u in shipped[src][dst]]
            keep = retained[dst]
            room = C - len(keep)
            fresh[dst] = max(max(room - reserve, 0), min(room, R))
            admit = min(len(arrivals), room)
            rdrops += len(arrivals) - admit
            arrivals_total += len(arrivals)
            out.append((keep, arrivals[:admit]))
            total += len(keep) + admit
        drops += rdrops
        retained_trace.append(sum(len(k) for k, _ in out))
        age_trace.append(max((r[2] for k, _ in out for r in k), default=0))
        recv_trace.append(arrivals_total)
        recv_drop_trace.append(rdrops)
        advert_trace.append(tuple(int(f) for f in fresh))
        return out, total, fresh

    # seed queue: round-0 emissions, clipped at capacity; first forward is
    # advert-only (zero credits)
    cursor = prefix[:, 0].copy()
    state = []
    for rank in range(R):
        rows = _emit_rows(sc, 0)[rank]
        drops += max(0, len(rows) - C)
        state.append(rows[:C])
    cur, total, credits = forward(state, np.zeros((R,), np.int64))

    rnd = 0
    while total > 0 and rnd < max_rounds:
        state = []
        for rank in range(R):
            keep, arrivals = cur[rank]
            for u in arrivals:
                delivered[rank][0] += 1
                delivered[rank][1] += u
                delivered[rank][2] += (u * u) % _M32
            # the drive's emission gate: own advert is already promised to
            # in-flight arrivals, so emissions fit in what remains
            headroom = max((C - max(int(credits[rank]), 0)) - len(keep), 0)
            due = int(prefix[rank, min(rnd + 1, sc.rounds - 1)])
            n = min(max(due - int(cursor[rank]), 0), headroom)
            fresh_rows = [
                [uid, d, 0]
                for uid, d in flat[rank][int(cursor[rank]): int(cursor[rank]) + n]
            ]
            cursor[rank] += n
            state.append(keep + fresh_rows)
        cur, total, credits = forward(state, credits)
        rnd += 1

    return {
        "delivered": np.asarray(
            [[c % _M32 for c in row] for row in delivered], np.uint32
        ),
        "drops": drops,
        "rounds": rnd,
        "done": total == 0,
        "resident": total,
        "emitted": int(cursor.sum()),
        "retained_trace": retained_trace,
        "age_trace": age_trace,
        "age_max": max(age_trace, default=0),
        "retained_rows": sum(retained_trace),
        "recv_trace": recv_trace,
        "recv_drops": sum(recv_drop_trace),
        "wire_rows": sum(recv_trace),
        "advert_trace": advert_trace,
    }
