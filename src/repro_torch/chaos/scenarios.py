"""Deterministic fault-injection traffic schedules (the port's own copy of
``repro.chaos.scenarios``, numpy only: same generators, same seeds, same
uid law, so a schedule here equals the reference's array for array).

A :class:`Scenario` is nothing but a numpy destination tensor: round ``r``,
rank ``me``, emit lane ``e`` either targets ``dests[r, me, e]`` or sits out
(``-1``).  Everything downstream — the device drive, the numpy oracle, the
expected checksums — derives from this one tensor, so the whole harness is
replayable from ``(name, seed)``.

Every generator guarantees at least one emission in EVERY round: the drive
loop terminates when the global in-flight count hits zero, so a globally
silent round with a drained pipeline would end the run before later rounds
got to emit (that would be a scenario bug, not a forwarding bug — guarded in
``__post_init__``).

The four shapes target distinct failure modes of the retain machinery:

* ``capacity_drought`` — uniform traffic run (by the harness) under a
  starved ``peer_capacity``: every rank spills every round, exercising the
  steady-state split/merge/age plumbing.
* ``rotating_hotspot`` — the clamp pressure MOVES each round; retained rows
  addressed to the old hot-spot must coexist with fresh rows flooding the
  new one (stale-dest handling, FIFO priority across destinations).
* ``burst_storm`` — quiet rounds punctuated by full-width bursts: the spill
  population collapses to (near) zero and rebuilds, exercising both
  boundary directions of the retained-count arithmetic.
* ``convergecast`` — every rank sends everything to rank 0: the worst-case
  single-destination backlog, the scenario where anti-starvation aging
  bites hardest.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Scenario",
    "capacity_drought",
    "rotating_hotspot",
    "burst_storm",
    "convergecast",
    "rank_brownout",
    "brownout_mask",
    "sustained_overload",
    "incast_collapse",
    "overload_scenarios",
    "all_scenarios",
]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """An emission schedule: who sends what where, each round.

    Attributes:
      name: stable identifier (test ids, benchmark JSON keys).
      num_ranks: mesh size R the schedule is laid out for.
      rounds: emitting rounds (the drive keeps running past them until the
        pipeline drains).
      emits_per_round: emit lanes E per rank per round.
      dests: ``(rounds, R, E) int32`` — destination rank, or ``-1`` for a
        lane that sits the round out.
    """

    name: str
    num_ranks: int
    rounds: int
    emits_per_round: int
    dests: np.ndarray

    def __post_init__(self):
        d = np.asarray(self.dests)
        if d.shape != (self.rounds, self.num_ranks, self.emits_per_round):
            raise ValueError(
                f"dests shape {d.shape} != (rounds, R, E) = "
                f"({self.rounds}, {self.num_ranks}, {self.emits_per_round})"
            )
        if d.max() >= self.num_ranks or d.min() < -1:
            raise ValueError("dests entries must be in [-1, num_ranks)")
        quiet = np.nonzero((d >= 0).reshape(self.rounds, -1).sum(axis=1) == 0)[0]
        if quiet.size:
            raise ValueError(
                f"round(s) {quiet.tolist()} emit nothing anywhere — the drive "
                "would terminate before reaching them (generators must plant "
                "a heartbeat emission)"
            )

    @property
    def emitted(self) -> int:
        """Total items the schedule puts in flight."""
        return int((np.asarray(self.dests) >= 0).sum())

    def uid(self, rnd: int, rank: int, lane: int):
        """The item identity law — shared verbatim by the device drive, the
        numpy oracle, and the checksums: unique, dense, deterministic."""
        return (rnd * self.num_ranks + rank) * self.emits_per_round + lane


def _heartbeat(dests: np.ndarray) -> np.ndarray:
    """Plant one self-addressed emission from rank 0 into any silent round."""
    for r in range(dests.shape[0]):
        if (dests[r] >= 0).sum() == 0:
            dests[r, 0, 0] = 0
    return dests


def capacity_drought(
    num_ranks: int = 8, rounds: int = 6, emits_per_round: int = 8, seed: int = 0
) -> Scenario:
    """Uniform random traffic, ~70% duty cycle — pressure comes from the
    harness starving ``peer_capacity``, not from the shape."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, num_ranks, size=(rounds, num_ranks, emits_per_round))
    mask = rng.random((rounds, num_ranks, emits_per_round)) < 0.7
    d = np.where(mask, d, -1).astype(np.int32)
    return Scenario(
        "capacity_drought", num_ranks, rounds, emits_per_round, _heartbeat(d)
    )


def rotating_hotspot(
    num_ranks: int = 8,
    rounds: int = 8,
    emits_per_round: int = 8,
    hot_frac: float = 0.75,
    seed: int = 1,
) -> Scenario:
    """Round ``r``'s traffic concentrates on rank ``r % R``; the backlog
    built against one hot-spot must drain while the next one floods."""
    rng = np.random.default_rng(seed)
    shape = (rounds, num_ranks, emits_per_round)
    uniform = rng.integers(0, num_ranks, size=shape)
    hot = (np.arange(rounds) % num_ranks)[:, None, None]
    d = np.where(rng.random(shape) < hot_frac, hot, uniform).astype(np.int32)
    return Scenario(
        "rotating_hotspot", num_ranks, rounds, emits_per_round, _heartbeat(d)
    )


def burst_storm(
    num_ranks: int = 8,
    rounds: int = 9,
    emits_per_round: int = 16,
    period: int = 3,
    seed: int = 2,
) -> Scenario:
    """Every ``period``-th round every rank fires ALL its lanes (uniform
    destinations); between bursts only a heartbeat trickle flows, so the
    spill population must fully rebuild each storm."""
    rng = np.random.default_rng(seed)
    shape = (rounds, num_ranks, emits_per_round)
    d = rng.integers(0, num_ranks, size=shape).astype(np.int32)
    storm = (np.arange(rounds) % period == 0)[:, None, None]
    trickle = np.zeros(shape, bool)
    trickle[:, 0, 0] = True  # rank 0 lane 0 keeps the drive alive
    d = np.where(storm | trickle, d, -1).astype(np.int32)
    return Scenario("burst_storm", num_ranks, rounds, emits_per_round, _heartbeat(d))


def convergecast(
    num_ranks: int = 8, rounds: int = 4, emits_per_round: int = 12, seed: int = 3
) -> Scenario:
    """All-to-one: every rank's every lane targets rank 0 — the maximal
    single-destination backlog (the aging bound's worst case)."""
    del seed  # fully deterministic; kept for a uniform generator signature
    d = np.zeros((rounds, num_ranks, emits_per_round), np.int32)
    return Scenario("convergecast", num_ranks, rounds, emits_per_round, d)


def rank_brownout(
    num_ranks: int = 8,
    rounds: int = 8,
    emits_per_round: int = 8,
    seed: int = 4,
) -> Scenario:
    """Uniform ~80% duty-cycle traffic that keeps addressing EVERY rank for
    the whole schedule — run it with a ``health`` mask that browns out ranks
    mid-burst (see :func:`brownout_mask`) and the pressure is entirely on
    the draining remap: emissions and retained backlog aimed at the
    dark ranks must be re-addressed without losing a row."""
    rng = np.random.default_rng(seed)
    shape = (rounds, num_ranks, emits_per_round)
    d = rng.integers(0, num_ranks, size=shape)
    mask = rng.random(shape) < 0.8
    d = np.where(mask, d, -1).astype(np.int32)
    return Scenario(
        "rank_brownout", num_ranks, rounds, emits_per_round, _heartbeat(d)
    )


def brownout_mask(num_ranks: int, down=(2, 5), down_from: int = 3):
    """Host health schedule for a brownout: every rank healthy until round
    ``down_from``, then the ``down`` ranks go dark for good.  Returns a
    callable ``rnd -> (R,) bool`` in the form ``run_checkpointed`` /
    ``resume_run`` re-evaluate at every segment boundary."""
    down = tuple(int(r) for r in down)
    for r in down:
        if not 0 <= r < num_ranks:
            raise ValueError(f"brownout rank {r} outside [0, {num_ranks})")
    if len(down) >= num_ranks:
        raise ValueError("a brownout must leave at least one healthy rank")

    def health(rnd: int) -> np.ndarray:
        h = np.ones((num_ranks,), bool)
        if rnd >= down_from:
            h[list(down)] = False
        return h

    return health


def sustained_overload(
    num_ranks: int = 8,
    rounds: int = 12,
    emits_per_round: int = 12,
    hot=(0, 1),
    hot_frac: float = 0.67,
    seed: int = 9,
) -> Scenario:
    """Every rank fires EVERY lane EVERY round, with most traffic pinned on
    a FIXED hot pair of ranks — unlike :func:`rotating_hotspot` the pressure
    never moves, so the hot receivers' offered load exceeds their drain
    capacity for the WHOLE schedule.  Open flow keeps shipping the full
    fan-in and sheds the excess at the hot receivers round after round
    (wasted wire); credit flow must hold the excess at the SOURCE and drain
    it losslessly after the schedule ends (graceful degradation).  Uniform sustained traffic would not do: consumption keeps up
    with symmetric arrivals, so receivers never overflow — overload that
    wastes wire needs concentration that PERSISTS."""
    rng = np.random.default_rng(seed)
    shape = (rounds, num_ranks, emits_per_round)
    uniform = rng.integers(0, num_ranks, size=shape)
    hot = np.asarray(hot, np.int32)
    hotdest = hot[rng.integers(0, hot.size, size=shape)]
    d = np.where(rng.random(shape) < hot_frac, hotdest, uniform).astype(np.int32)
    return Scenario("sustained_overload", num_ranks, rounds, emits_per_round, d)


def incast_collapse(
    num_ranks: int = 8, rounds: int = 10, emits_per_round: int = 8, seed: int = 10
) -> Scenario:
    """Sustained full-width convergecast: every rank's every lane targets
    rank 0 for ``rounds`` straight rounds — R·E rows per round against ONE
    queue of bounded capacity.  The classic TCP-incast collapse shape: open
    flow ships the full fan-in and throws most of it away at rank 0; credit
    flow apportions rank 0's real free space among the R senders and ships
    nothing it cannot admit."""
    del seed  # fully deterministic; kept for a uniform generator signature
    d = np.zeros((rounds, num_ranks, emits_per_round), np.int32)
    return Scenario("incast_collapse", num_ranks, rounds, emits_per_round, d)


def overload_scenarios(num_ranks: int = 8, seed: int = 0):
    """The backpressure gauntlet: sustained aggregate overload and
    single-destination incast — the two shapes where open flow livelocks on
    wasted wire and credit flow must degrade gracefully instead."""
    return [
        sustained_overload(num_ranks, seed=seed + 9),
        incast_collapse(num_ranks, seed=seed + 10),
    ]


def all_scenarios(num_ranks: int = 8, seed: int = 0):
    """The standard gauntlet, one of each shape."""
    return [
        capacity_drought(num_ranks, seed=seed),
        rotating_hotspot(num_ranks, seed=seed + 1),
        burst_storm(num_ranks, seed=seed + 2),
        convergecast(num_ranks, seed=seed + 3),
    ]
