"""The roofline's plain models (the port's copy of the numpy models of
``repro.roofline.analysis``, unchanged), the model FLOPs of a shape, and
the call recorder's reading of the wire.

Copied as they are: :func:`tier_bytes_model`, :func:`slow_axis_bytes_model`,
:func:`padded_wire_rows`, :func:`occupancy_waste_model`,
:func:`spill_drain_model`, :func:`goodput_model`, :func:`marshal_cost_model`,
:func:`overlap_efficiency_model` and :func:`model_flops` (6·N·D for a
train step, 2·N a token otherwise, N_active for MoE: arithmetic on the
parameter count, which ``launch.dryrun`` records beside the FLOPs it
counts).

The reference's HLO readers have no twin here: ``collective_ops``,
``per_axis_collective_bytes``, ``per_tier_collective_bytes``,
``collective_bytes``, ``analyze_lowered`` / ``RooflineTerms``, and the
modules ``roofline/inspect.py`` and ``roofline/report.py``.  They read a
lowered XLA program (its ``cost_analysis`` and the replica groups of its
collectives); the port lowers none.  Their role as budget guards is taken
by the collective layer's call recorder
(``core.collectives.StackedCollectives``, whose ``calls`` hold each call's
kind, bytes and tier), read here by :func:`recorded_wire_bytes`: the bytes
one rank puts on each tier, held in the tests against
:func:`padded_wire_rows` and :func:`tier_bytes_model`.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

__all__ = [
    "goodput_model",
    "marshal_cost_model",
    "model_flops",
    "occupancy_waste_model",
    "overlap_efficiency_model",
    "padded_wire_rows",
    "recorded_wire_bytes",
    "slow_axis_bytes_model",
    "spill_drain_model",
    "tier_bytes_model",
]


def tier_bytes_model(level_sizes, level_capacities, item_bytes: int) -> list:
    """Model: bulk payload bytes ONE rank pushes across each mesh tier per
    hierarchical forwarding round, slowest tier first.

    Stage ``l`` ships ``level_sizes[l]`` padded segments of
    ``level_capacities[l]`` rows over tier ``l``'s fabric; the
    ``level_sizes[l] - 1`` segments addressed off-group actually cross it
    (extent-1 tiers skip their stage: 0 bytes)."""
    return [
        float((a - 1) * s * item_bytes) if a > 1 else 0.0
        for a, s in zip(level_sizes, level_capacities)
    ]


def slow_axis_bytes_model(
    exchange: str,
    *,
    num_ranks: int,
    fast_size: int,
    item_bytes: int,
    peer_capacity: int = 0,
    node_capacity: int = 0,
    n_items: int = 0,
) -> float:
    """Model: bulk payload bytes ONE rank pushes across the slow (inter-node)
    fabric per forwarding round.

    * flat ``padded`` routed over the joint 2-D axis: R per-rank slots of
      ``peer_capacity`` rows; the ``R - fast_size`` slots addressed to remote
      nodes cross the slow fabric, each padded per RANK.
    * ``hierarchical``: only stage B crosses — ``num_nodes - 1`` per-NODE
      segments of ``node_capacity`` rows.  At equal burst tolerance K per
      destination (``peer_capacity == node_capacity == K``) the padded rows
      crossing the slow fabric shrink from (R - F)·K to (N - 1)·K — exactly
      R/N×, since R - F = F·(N - 1).
    * ``ragged``: data-dependent — exactly the useful bytes headed off-node
      (uniform-destination estimate from ``n_items``).
    """
    num_nodes = num_ranks // fast_size
    if exchange in ("padded", "flat"):
        return float((num_ranks - fast_size) * peer_capacity * item_bytes)
    if exchange == "hierarchical":
        return float((num_nodes - 1) * node_capacity * item_bytes)
    if exchange == "ragged":
        return float(n_items * item_bytes) * (num_ranks - fast_size) / num_ranks
    raise ValueError(f"no slow-axis model for exchange {exchange!r}")


def padded_wire_rows(level_sizes, level_capacities) -> list:
    """Padded send rows ONE rank puts on the wire per round, per tier: stage
    ``l`` always ships ``level_sizes[l]`` segments of ``level_capacities[l]``
    rows regardless of demand (that is the price of the padded format);
    extent-1 tiers skip their stage entirely.  A flat padded exchange is the
    1-tier instance ``(num_ranks,), (peer_capacity,)``."""
    return [
        a * s if a > 1 else 0
        for a, s in zip(tuple(level_sizes), tuple(level_capacities))
    ]


def occupancy_waste_model(
    level_sizes,
    level_capacities,
    item_bytes: int,
    *,
    useful_rows=None,
    rounds: int = 1,
    num_ranks: int = 1,
) -> Dict:
    """The telemetry subsystem's cost side: padded wire bytes vs useful bytes
    per tier, the quantity the capacity controller trades against drops.

    ``wire_B`` covers ``num_ranks`` senders over ``rounds`` rounds (each rank
    pays :func:`padded_wire_rows` per round regardless of demand).  MATCH THE
    POPULATIONS when passing ``useful_rows``: ``telemetry.summarize(...)
    ["sent_rows"]`` is summed over every rank and recorded round, so pass
    ``num_ranks=R`` and ``rounds=window_filled`` alongside it — the defaults
    (1, 1) are the single-rank single-round static view, and mixing a
    rank-summed ``useful_rows`` into them would inflate ``useful_B`` by R
    (waste_frac could even go negative).  Pass ``useful_rows=None`` for the
    pure static-wire view.  Returns per-tier ``wire_B`` (always paid),
    ``useful_B`` and ``waste_frac`` (padding fraction of the wire), plus
    totals — the "modeled padded bytes" gated by the autotune benchmark: a
    tuned config must never pay more wire than the static worst-case config
    it replaces.
    """
    rows = padded_wire_rows(level_sizes, level_capacities)
    wire = [float(r * rounds * num_ranks * item_bytes) for r in rows]
    out = {"tiers": []}
    for l, w in enumerate(wire):
        useful = (
            float(useful_rows[l]) * item_bytes if useful_rows is not None else None
        )
        out["tiers"].append(
            {
                "wire_B": w,
                "useful_B": useful,
                "waste_frac": (
                    1.0 - useful / w if useful is not None and w else None
                ),
            }
        )
    out["wire_B"] = sum(wire)
    if useful_rows is not None:
        total_useful = float(sum(useful_rows)) * item_bytes
        out["useful_B"] = total_useful
        out["waste_frac"] = (
            1.0 - total_useful / out["wire_B"] if out["wire_B"] else 0.0
        )
    return out


def spill_drain_model(backlog_rows: int, allowance_rows_per_round: int) -> Dict:
    """Model: bounded-delay drain of a spill-and-retry backlog (the lossless
    law's analytical half, gated by the chaos benchmark).

    Under ``overflow="retain"`` a clamp never loses a row — it re-queues it
    at the FRONT of the carry (FIFO oldest-first), so a backlog of
    ``backlog_rows`` rows contending for one destination drains at
    ``allowance_rows_per_round`` rows per round (the per-destination clamp
    budget — ``peer_capacity`` flat, the stage's segment capacity per tier
    hierarchically).  Every budget is ≥ 1 row, so the oldest row always
    ships within ``ceil(backlog / allowance)`` rounds:

        rounds = age_bound = ceil(backlog_rows / allowance_rows_per_round)

    The chaos harness asserts the measured ``age_max`` never exceeds this
    bound (+ the emission span, since the backlog builds over the scenario's
    emitting rounds rather than all at once)."""
    if allowance_rows_per_round < 1:
        raise ValueError(
            "allowance must be >= 1 row/round — every clamp budget admits at "
            f"least one row (got {allowance_rows_per_round})"
        )
    rounds = -(-int(backlog_rows) // int(allowance_rows_per_round))
    return {"rounds": rounds, "age_bound": rounds}


def goodput_model(
    offered_rows_per_round: int,
    drain_rows_per_round: int,
    *,
    rounds: int = 1,
    item_bytes: int = 1,
) -> Dict:
    """Model: wire goodput under sustained overload, open vs credit flow
    (the backpressure law's analytical half, gated by the chaos benchmark).

    ``offered_rows_per_round`` rows per round contend for a receiver that
    can consume (drain) ``drain_rows_per_round``.  With ``flow="open"`` the
    senders ship the full offered load every round; once the receiver's
    bounded queue saturates it admits only what it drains, so every other
    shipped row is wire spent on a row the receiver throws away:

        goodput_open  →  min(1, drain / offered)

    With ``flow="credit"`` senders ship only rows the receiver's advertised
    free space admits — a shipped row is an admitted row by construction:

        goodput_credit = 1.0

    at the price of the excess being HELD at the source through the retain
    spill path (``held_rows``), draining after the overload subsides.  The
    chaos gate asserts the measured goodputs respect this ordering on every
    overload scenario: credit ≥ open, with open below 0.7 where the
    scenario offers ≥ 1.43× the drain rate.

    Returns ``{"open": {wire_B, admitted_B, wasted_B, goodput},
    "credit": {wire_B, admitted_B, wasted_B, goodput, held_rows},
    "goodput_gain"}`` — totals over ``rounds`` rounds.
    """
    if drain_rows_per_round < 1:
        raise ValueError(
            "drain must be >= 1 row/round — every clamp/credit budget admits "
            f"at least one row (got {drain_rows_per_round})"
        )
    offered = float(offered_rows_per_round) * rounds
    admitted = float(min(offered_rows_per_round, drain_rows_per_round)) * rounds
    open_flow = {
        "wire_B": offered * item_bytes,
        "admitted_B": admitted * item_bytes,
        "wasted_B": (offered - admitted) * item_bytes,
        "goodput": admitted / offered if offered else 1.0,
    }
    credit_flow = {
        "wire_B": admitted * item_bytes,
        "admitted_B": admitted * item_bytes,
        "wasted_B": 0.0,
        "goodput": 1.0,
        "held_rows": offered - admitted,
    }
    return {
        "open": open_flow,
        "credit": credit_flow,
        "goodput_gain": credit_flow["goodput"] - open_flow["goodput"],
    }


def marshal_cost_model(
    marshal: str,
    *,
    capacity: int,
    item_bytes: int,
    send_rows: int,
    num_ranks: int = 0,
) -> Dict[str, float]:
    """Model: send-side marshal work ONE rank does per forwarding round —
    the §6.1 "all of [sort/marshal] are trivially cheap" claim, made
    checkable next to the collective byte models.

    Both modes obey the marshal law — exactly ONE pass over the PACKED
    PAYLOAD pre-collective (read C rows, write ``send_rows`` padded rows);
    what ``marshal="scatter"`` deletes is everything the sort did to the KEY
    vector first:

    * ``sort``: key pack (read C dest words, write C keys) + the
      compare-exchange sort — modeled as ``ceil(log2 C)`` read+write passes
      over the C-word key vector (XLA's bitonic/merge family) — then the one
      composed payload gather.
    * ``scatter``: the counting-sort plan (read C dest words, write C ranks +
      C sanitized dests, accumulate the (R+1)-word histogram) — a single
      O(C) pass, no keys — then the one payload scatter.

    Returns ``{"payload_passes", "payload_bytes", "plan_bytes",
    "total_bytes"}`` (bytes are on-chip traffic, not wire bytes; compare
    against the exchange's collective bytes to see marshal overhead shrink
    from O(C log C) + 2-passes-equivalent to the single-pass floor).
    """
    payload_bytes = float((capacity + send_rows) * item_bytes)
    word = 4.0
    if marshal == "sort":
        log2c = max(1, int(np.ceil(np.log2(max(capacity, 2)))))
        plan = capacity * word * 2  # key pack: read dest, write keys
        plan += log2c * 2 * capacity * word  # sort passes over the keys
    elif marshal == "scatter":
        plan = capacity * word  # read dest
        plan += 2 * capacity * word  # write d_clean + in-bucket rank
        plan += (num_ranks + 1) * word  # histogram accumulator
    else:
        raise ValueError(f"no marshal model for {marshal!r}")
    return {
        "payload_passes": 1.0,  # the marshal law, either mode
        "payload_bytes": payload_bytes,
        "plan_bytes": float(plan),
        "total_bytes": payload_bytes + float(plan),
    }


def overlap_efficiency_model(
    phase_us: Dict[str, float],
    shards: int,
    *,
    wire_phases=("count_collective", "payload_collective"),
    async_fraction: float = 1.0,
) -> Dict[str, float]:
    """Model: the overlap law's walltime — software-pipelining one forwarding
    round into ``shards`` micro-shards (``ForwardConfig.pipeline_shards``).

    Input is the measured per-phase breakdown of ONE bulk round (the
    ``fwd_profile_*`` rows: marshal, count_collective, payload_collective,
    unmarshal).  Phases in ``wire_phases`` are collective time ``w``; the
    rest is send/receive compute ``c``.  With S shards each phase splits into
    S chunks of 1/S the work, and a fabric that can ship one chunk while the
    VPU marshals the next hides ``async_fraction`` of the wire time behind
    compute.  The classic fill/drain pipeline bound:

        T(S, a) = (1 - a)·w  +  (c + a·w)/S  +  (S - 1)/S · max(c, a·w)

    * ``a = 1`` (DMA/NIC fabric — TPU ICI, the paper's target): steady state
      overlaps perfectly, T → max(c, w) as S grows; speedup caps at
      ``(c + w)/max(c, w)``.
    * ``a = 0`` (synchronous fabric — XLA:CPU's memcpy collectives): T equals
      the bulk round — the model predicts NO overlap win, so any measured
      gain there is the locality corollary (each 1/S chunk is marshalled,
      shipped and compacted while still cache-resident) and any loss is the
      S× launch overhead.  The gate brackets measurements with both bounds.

    Returns ``{"bulk_us", "pipelined_us", "speedup", "efficiency",
    "compute_us", "wire_us"}`` — ``efficiency`` is the achieved fraction of
    the perfect-overlap bound ``max(c, w)``.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if not 0.0 <= async_fraction <= 1.0:
        raise ValueError(f"async_fraction must be in [0, 1], got {async_fraction}")
    w = float(sum(us for ph, us in phase_us.items() if ph in wire_phases))
    c = float(sum(us for ph, us in phase_us.items() if ph not in wire_phases))
    bulk = c + w
    a = float(async_fraction)
    hidden = a * w
    pipelined = (
        (1.0 - a) * w
        + (c + hidden) / shards
        + (shards - 1) / shards * max(c, hidden)
    )
    return {
        "bulk_us": bulk,
        "pipelined_us": pipelined,
        "speedup": bulk / pipelined if pipelined > 0 else float("inf"),
        "efficiency": max(c, w) / pipelined if pipelined > 0 else 1.0,
        "compute_us": c,
        "wire_us": w,
    }


def recorded_wire_bytes(calls, level_sizes: Sequence[int], *, min_bytes: int = 0) -> list:
    """Bytes ONE rank put into the ``all_to_all`` and ``ragged_all_to_all``
    calls of each tier, slowest tier first, read from a call recorder's
    ``calls`` (``{Call: n}``).

    A call's ``nbytes`` holds every rank's contribution, so one rank's share
    is ``nbytes / shape[0]``; a tier call counts on its ``tier``, a flat call
    (no tier) on the one tier of a flat layout ``(R,)``.  A ragged call
    counts its static result bytes, ``(capacity, W)`` words a rank, as the
    reference's HLO reader counts the op, not the live rows it moves; the
    ragged round's count ``all_gather`` is not counted.  ``min_bytes``
    skips calls whose one-rank share is smaller — the count calls beside
    the payload, as ``per_tier_collective_bytes``'s filter does in the
    reference.  For the padded payload calls of a round this is
    :func:`padded_wire_rows` times the wire row's bytes: the whole padded
    buffer, a rank's own segment included (:func:`tier_bytes_model` counts
    the ``A - 1`` segments that cross)."""
    level_sizes = tuple(int(a) for a in level_sizes)
    out = [0] * len(level_sizes)
    for call, n in calls.items():
        if call.kind not in ("all_to_all", "ragged_all_to_all"):
            continue
        if call.tier is None and len(level_sizes) != 1:
            raise ValueError(f"a flat {call.kind} call on the {len(level_sizes)}-tier layout {level_sizes}")
        share = call.nbytes // call.shape[0]
        if share >= min_bytes:
            out[0 if call.tier is None else call.tier] += share * n
    return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE), D = processed tokens.

    For prefill/decode the factor is 2·N per token (forward only).  N is
    every parameter, the embedding table included, and no attention
    product is counted: ``chip_smoke._attn_model_flops`` (no embedding,
    plus attention) is another measure."""
    from repro_torch.models.api import build_model

    model = build_model(cfg)
    n_params = model.param_count()
    if cfg.kind == "moe":
        # active params: replace expert count by top_k in the FFN share
        e, k = cfg.num_experts, cfg.top_k
        ffn = 3 * cfg.d_model * cfg.d_ff * e * cfg.num_layers
        active_ffn = ffn * k / e
        n_active = n_params - ffn + active_ffn
    else:
        n_active = n_params
    tokens = shape.global_batch * (shape.seq_len if shape.step != "decode" else 1)
    factor = 6.0 if shape.step == "train" else 2.0
    return factor * n_active * tokens
