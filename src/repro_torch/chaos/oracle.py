"""Ground truth for the lossless law: what must arrive, and when (the
port's own copy of ``repro.chaos.oracle``'s retain half, numpy only).

* :func:`expected_by_rank` reads ONLY the schedule — per-destination
  ``(count, sum(uid), sum(uid²))`` checksums mod 2³². Any lossless routing
  implementation must reproduce these exactly; it knows nothing about
  rounds, capacities or retention, so it cannot share a bug with the code
  under test.
* :func:`simulate_flat_retain` is an exact round-by-round numpy twin of the
  flat padded retain pipeline (the drive's split/merge, the sender clamp's
  FIFO spill, receiver admission), tracking per-forward retained counts and
  ages: the trajectory, not just the end state.

Checksum arithmetic is uint32 with wraparound on both sides (Python ints
reduced mod 2³² at the end — homomorphic, so the results are
bit-comparable).  The credit twin waits for the port's credit flow (ROADMAP
Queue 1 item 10), the ``health`` remap for item 11.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.chaos.scenarios import Scenario

__all__ = ["expected_by_rank", "simulate_flat_retain"]

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


def simulate_flat_retain(
    sc: Scenario,
    *,
    peer_capacity: int,
    capacity: int,
    max_rounds: int = 64,
) -> Dict:
    """Exact numpy twin of ``run_until_done`` over a flat padded exchange
    with ``overflow="retain"`` — the same event order the device executes:

      seed queue = round-0 emissions (clipped at ``capacity``, clip counted
      as drops) → forward → loop [deliver arrivals; append round ``rnd+1``
      emissions behind the retained front; forward] while the global
      in-flight count is positive and ``rnd < max_rounds``.

    A forward clamps each sender's per-destination traffic at
    ``peer_capacity`` rows in stable lane order (excess rows are retained
    with ``age + 1``), concatenates arrivals in source-rank order, and
    admits them behind the retained front up to ``capacity`` (excess is a
    counted receiver drop).

    Returns the final delivered checksums plus the per-forward
    ``retained_trace`` / ``age_trace`` trajectories a device drive must
    reproduce (retained rows across all ranks, and their largest age)."""
    R, C, S = sc.num_ranks, capacity, peer_capacity
    delivered = [[0, 0, 0] for _ in range(R)]
    drops = 0
    retained_trace: List[int] = []
    age_trace: List[int] = []

    def forward(state):
        """state: per-rank [uid, dest, age] rows (retained front + fresh).
        Returns per-rank (retained_rows, arrival_uids) and the global
        in-flight total after the exchange."""
        nonlocal drops
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
