"""The roofline's plain models (the port's copy of the numpy models of
``repro.roofline.analysis``, unchanged), the model FLOPs of a shape, the
call recorder's reading of the wire, and the three roofline terms of a
step counted in one pass on the meta device.

Copied as they are: :func:`tier_bytes_model`, :func:`slow_axis_bytes_model`,
:func:`padded_wire_rows`, :func:`occupancy_waste_model`,
:func:`spill_drain_model`, :func:`goodput_model`, :func:`marshal_cost_model`,
:func:`overlap_efficiency_model` and :func:`model_flops` (6·N·D for a
train step, 2·N a token otherwise, N_active for MoE: arithmetic on the
parameter count, which ``launch.dryrun`` records beside the FLOPs it
counts).  :class:`RooflineTerms` has the reference's fields, properties
and ``as_dict`` keys, over the card's figures (:data:`HW`, an NVIDIA H100
80GB HBM3 SXM at 700 W; no TPU figure carries over).

The reference reads its terms from a compiled XLA program
(``analyze_lowered``: ``cost_analysis``'s FLOPs and bytes accessed, and
the collectives of the HLO text).  The port runs its steps eagerly, so
:func:`count_step` counts the same things over one run of the step
(on meta: nothing allocated): the FLOPs as
``torch.utils.flop_counter.FlopCounterMode`` counts them, and, in a
dispatch mode of its own nested inside it (:class:`StepCounter`), the
bytes each aten op reads and writes, the peak of the bytes alive, and the
ops' signatures.  The collectives come from the collective layer's call
recorder (``core.collectives.StackedCollectives``, whose ``calls`` hold
each call's kind, bytes and tier): :func:`collective_bytes` and
:func:`collective_inventory` name them as the reference's HLO names them
and count a device's result bytes, as the reference's reader counts a
per-partition result shape.  :func:`recorded_wire_bytes` reads the same
recorder for the bytes one rank puts on each tier, held in the tests
against :func:`padded_wire_rows` and :func:`tier_bytes_model`.

No twin: the reference's HLO readers (``collective_ops``,
``per_axis_collective_bytes``, ``per_tier_collective_bytes``, the HLO
``collective_bytes``) and ``analyze_lowered`` itself: they read a lowered
XLA program, and the port lowers none.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import weakref
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "HW",
    "RooflineTerms",
    "StepCount",
    "StepCounter",
    "collective_bytes",
    "collective_inventory",
    "count_step",
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

# The card's figures: NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, as
# ``nvidia-smi --query-gpu=name,power.limit`` reads it on the card.
HW = {
    "peak_flops": 989e12,  # bf16 dense FLOP/s (NVIDIA H100 SXM data sheet: 989.4 TFLOPS without sparsity)
    "hbm_bw": 3.35e12,  # B/s, HBM3 (data sheet: 3.35 TB/s)
    "link_bw": 450e9,  # B/s one way, NVLink 4 (data sheet: 900 GB/s both ways together)
    "dcn_bw": 50e9,  # B/s per GPU across nodes: one 400 Gb/s InfiniBand NDR port
}


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


# ------------------------------------------------------------ roofline terms
@dataclasses.dataclass
class RooflineTerms:
    """The reference's three terms, over :data:`HW`: whole-job FLOPs,
    bytes accessed and collective bytes over ``chips`` cards."""

    flops: float
    bytes_accessed: float
    coll_bytes: float
    chips: int
    coll_breakdown: Dict[str, int]
    bytes_per_chip: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * HW["peak_flops"])

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / (self.chips * HW["hbm_bw"])

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * HW["link_bw"])

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self):
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "coll_bytes": self.coll_bytes,
            "chips": self.chips,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "dominant": self.dominant,
            "coll_breakdown": self.coll_breakdown,
            "bytes_per_chip": self.bytes_per_chip,
        }


# ------------------------------------------------------------- collectives
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute", "ragged-all-to-all")
# the recorder's kinds as the reference's HLO names them
HLO_NAMES = {"all_to_all": "all-to-all", "ragged_all_to_all": "ragged-all-to-all", "all_gather": "all-gather",
             "psum": "all-reduce", "pmin": "all-reduce", "grad_all_reduce": "all-reduce",
             "ppermute": "collective-permute"}


def _device_result(call, level_sizes: Optional[Sequence[int]]) -> Tuple[int, Tuple[int, ...]]:
    """``(bytes, shape)`` of one device's result of a recorded call.  A
    stacked call's input holds every rank's contribution on its leading
    axis: a device's result is its row (``all_to_all``, ``psum``,
    ``pmin``, ``ppermute``, ``ragged_all_to_all``), every row of a flat
    ``all_gather``, or its tier group's rows of a tier ``all_gather``
    (``level_sizes`` needed).  A ``grad_all_reduce`` call is one process's
    bucket, whole."""
    if call.kind == "grad_all_reduce":
        return call.nbytes, tuple(call.shape)
    r, row = call.shape[0], tuple(call.shape[1:])
    if call.kind == "all_gather":
        if call.tier is None:
            return call.nbytes, tuple(call.shape)
        if level_sizes is None:
            raise ValueError("a tier all_gather needs the layout's level_sizes")
        a = int(level_sizes[call.tier])
        return call.nbytes // r * a, (a,) + row
    return call.nbytes // r, row


def collective_inventory(calls, level_sizes: Optional[Sequence[int]] = None) -> list:
    """``[(kind, shape, bytes, count)]``: the recorder's calls (``{Call:
    n}``) by HLO kind and one device's result shape, ``bytes`` one
    device's result bytes over the ``count`` calls, largest first."""
    agg: Dict[Tuple[str, Tuple[int, ...]], list] = {}
    for call, n in calls.items():
        nbytes, shape = _device_result(call, level_sizes)
        cell = agg.setdefault((HLO_NAMES[call.kind], shape), [0, 0])
        cell[0] += nbytes * n
        cell[1] += n
    return sorted(((k, s, b, n) for (k, s), (b, n) in agg.items()), key=lambda t: (-t[2], t[0], t[1]))


def collective_bytes(calls, level_sizes: Optional[Sequence[int]] = None) -> Dict[str, int]:
    """One device's result bytes per HLO kind (every kind present, as the
    reference's ``collective_bytes`` gives them)."""
    out = {k: 0 for k in COLLECTIVES}
    for kind, _shape, nbytes, _n in collective_inventory(calls, level_sizes):
        out[kind] += nbytes
    return out


# ---------------------------------------------------------- the step count
_aten = torch.ops.aten
# ops that alias their input (a view the schema does not declare) or move
# no data (an allocation without a write)
_NO_TRAFFIC = {_aten._unsafe_view.default, _aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default}
# in-place ops that write the argument they mutate without reading it
_WRITE_ONLY = {_aten.copy_.default, _aten.fill_.Scalar, _aten.zero_.default}
# in-place ops that write only the indexed part of the argument they
# mutate: as many bytes as their source operand holds
_PARTIAL_WRITE = {_aten.index_put_.default, _aten.index_copy_.default, _aten.index_add_.default,
                  _aten.scatter_.src, _aten.scatter_add_.default}
# gathers: their first operand is read only where indexed, as many bytes as
# the result holds
_GATHER = {_aten.index.Tensor, _aten.embedding.default, _aten.gather.default, _aten.index_select.default}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes an op touches to read or write all of ``t``: its distinct
    elements (an expanded dimension, stride 0, holds one) times their size."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride()))
    return min(t.numel(), span) * t.element_size()


def storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage while it is alive."""
    return t.untyped_storage()._cdata


def _tensors(x, out=None) -> list:
    """The tensors in ``x`` (nested tuples, lists and dicts), in order."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


@functools.lru_cache(maxsize=None)
def _mutated(func) -> tuple:
    """``(position, name)`` of each argument ``func`` writes."""
    return tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                 if a.alias_info is not None and a.alias_info.is_write)


def op_bytes(func, args, kwargs, out, operands=None) -> int:
    """Bytes one aten op reads and writes: each distinct tensor operand
    read once, each result written once; a view or an alias 0.  An
    argument the op mutates is written (and read, unless the op only
    writes it, as ``copy_``); an indexed write (``index_put_``,
    ``scatter_``, …) writes as many bytes as its largest other operand, and
    a gather (``index``, ``embedding``, ``gather``, ``index_select``)
    reads as many of its source's bytes as it returns.  ``operands``: the
    tensors of ``(args, kwargs)``, if found already."""
    if func.is_view or func in _NO_TRAFFIC:
        return 0
    mutated = set()
    for i, name in _mutated(func):
        mutated.update(id(t) for t in _tensors(args[i] if i < len(args) else kwargs.get(name)))
    seen, total = set(), 0
    operands = _tensors((args, kwargs)) if operands is None else operands
    other = [tensor_bytes(t) for t in operands if id(t) not in mutated]
    results = _tensors(out)
    gathered = operands[0] if func in _GATHER else None
    for t in operands:
        if id(t) in seen:
            continue
        seen.add(id(t))
        if t is gathered:
            total += min(tensor_bytes(t), sum(map(tensor_bytes, results)))
        elif id(t) not in mutated:
            total += tensor_bytes(t)
        elif func in _PARTIAL_WRITE:
            total += max(other, default=0)
        else:
            total += tensor_bytes(t) * (1 if func in _WRITE_ONLY else 2)
    for t in results:
        if id(t) not in seen and id(t) not in mutated:
            seen.add(id(t))
            total += tensor_bytes(t)
    return total


class StepCounter(TorchDispatchMode):
    """Counts, over the aten ops run inside it: the bytes they read and
    write (:func:`op_bytes`), the storages they read (``read``, by
    :func:`storage_key`), the peak of the bytes alive, and, with
    ``signatures``, how often each (op, operand shapes and dtypes) ran.

    Bytes alive are storages: those handed to :meth:`hold` before the run
    (the step's inputs), plus each op's new storages, less those freed.
    A storage's end is seen through a weak reference to it (meta tensors
    are freed by reference count like any others).  Two peaks are kept:
    ``peak_bytes``, every storage whole, and ``peak_weighted``, each
    storage times a weight (:meth:`hold` and :meth:`weigh` set one;
    ``default_weight`` otherwise), as ``launch.dryrun`` splits a step over
    a layout's devices."""

    def __init__(self, *, default_weight: float = 1.0, signatures: bool = False):
        super().__init__()
        self.bytes_accessed = 0
        self.ops = 0
        self.live = self.peak_bytes = 0
        self.live_weighted = self.peak_weighted = 0.0
        self.default_weight = float(default_weight)
        self.signatures = collections.Counter() if signatures else None
        self.read = set()  # the storages an op with traffic took as an operand
        self._alive: Dict[int, list] = {}  # storage key -> [bytes, weight]

    def _track(self, t: torch.Tensor, weight: Optional[float] = None) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._alive:
            if weight is not None:
                self._reweigh(key, weight)
            return
        n = st.nbytes()
        w = self.default_weight if weight is None else float(weight)
        self._alive[key] = [n, w]
        self.live += n
        self.live_weighted += n * w
        weakref.finalize(st, self._free, key)

    def _reweigh(self, key, weight: float) -> None:
        n, w = self._alive[key]
        self.live_weighted += n * (weight - w)
        self._alive[key][1] = weight

    def _free(self, key) -> None:
        n, w = self._alive.pop(key)
        self.live -= n
        self.live_weighted -= n * w

    def _mark(self) -> None:
        self.peak_bytes = max(self.peak_bytes, self.live)
        self.peak_weighted = max(self.peak_weighted, self.live_weighted)

    def hold(self, tensors: Iterable[torch.Tensor], weight: Optional[float] = None) -> None:
        """Count ``tensors``' storages alive from now, at ``weight``."""
        for t in tensors:
            self._track(t, weight)
        self._mark()

    def weigh(self, t: torch.Tensor, weight: float) -> None:
        """Give ``t``'s storage a weight (a gradient: its parameter's)."""
        self._track(t, weight)
        self._mark()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        operands = _tensors((args, kwargs))
        moved = op_bytes(func, args, kwargs, out, operands)
        if moved:
            self.bytes_accessed += moved
            self.read.update(storage_key(t) for t in operands)
        for t in _tensors(out):
            self._track(t)
        self._mark()
        if self.signatures is not None:
            sig = tuple((tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in operands)
            self.signatures[(str(func), sig)] += 1
        return out


@dataclasses.dataclass
class StepCount:
    """One step counted: :func:`count_step`'s result."""

    flops: int
    bytes_accessed: int
    peak_bytes: int
    peak_weighted: float
    ops: int
    read: set
    signatures: Optional[collections.Counter] = None
    out: object = None


def count_step(fn: Callable[[], object], *, held: Sequence[Tuple[Iterable[torch.Tensor], Optional[float]]] = (),
               grads: Sequence[Tuple[torch.Tensor, float]] = (), default_weight: float = 1.0,
               signatures: bool = False) -> StepCount:
    """Run ``fn()`` once under ``FlopCounterMode`` with a
    :class:`StepCounter` nested inside it: the FLOPs (as
    ``FlopCounterMode`` counts them), the bytes accessed, the peaks of
    the bytes alive and the op signatures, in one pass.  ``held`` are the
    step's inputs as ``(tensors, weight)``, alive from the start;
    ``grads`` ``(parameter, weight)``: the gradient accumulated into each
    parameter takes that weight (a hook after accumulation)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = StepCounter(default_weight=default_weight, signatures=signatures)
    for tensors, weight in held:
        counter.hold(tensors, weight)
    hooks = []
    for p, weight in grads:
        p.requires_grad_(True)
        hooks.append(p.register_post_accumulate_grad_hook(lambda p, w=weight: counter.weigh(p.grad, w)))
    collecting = gc.isenabled()
    gc.disable()  # a storage's end may not wait for the cycle collector's timing
    try:
        with FlopCounterMode(display=False) as fc, counter:
            out = fn()
    finally:
        if collecting:
            gc.enable()
        for h in hooks:
            h.remove()
    return StepCount(flops=int(fc.get_total_flops()), bytes_accessed=counter.bytes_accessed,
                     peak_bytes=counter.peak_bytes, peak_weighted=counter.peak_weighted, ops=counter.ops,
                     read=counter.read, signatures=counter.signatures, out=out)
