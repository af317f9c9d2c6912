"""Collectives over the rank axis of rank-stacked tensors.

One H100 is one device, so the port runs R logical ranks in one process on
tensors whose leading axis is the rank.  Every collective the reference
issues inside ``shard_map`` becomes a tensor operation on that axis:

  all_to_all(x)   x (R_src, R_dst, ...) → out[dst, src] = x[src, dst]
                  (``jax.lax.all_to_all``, ``stages.a2a``)
  all_to_all(x, digits=, tier=l)
                  the same over ONE tier of a multi-tier rank layout:
                  x (R, A_l, ...), block j of rank r goes to the peer whose
                  digit l is j and whose other digits are r's
                  (``stages.a2a`` over mesh axis l)
  all_gather(x)   x (R, ...) → (R, R, ...): every rank sees every row
                  (a broadcast view, no copy)
  all_gather(x, digits=, tier=l)
                  the same within ONE tier's group: x (R, ...) → (R, A_l,
                  ...), rank r sees the A_l ranks that share every digit
                  of r but digit l, in digit-l order
  ragged_all_to_all(x, output, input_offsets=, send_sizes=,
                  output_offsets=, recv_sizes=)
                  x (R, C, W) → (R, capacity, W): sender s's rows
                  [input_offsets[s, d], + send_sizes[s, d]) land on
                  receiver d at [output_offsets[s, d], …)
                  (``jax.lax.ragged_all_to_all``, the MPI_Alltoallv of the
                  ragged exchange), each size table (R, R), row = rank
  ppermute(x)     x (R, ...) → out[(i + 1) % R] = x[i]: the node-major
                  ring hop of ``repro.core.cycling`` (``jax.lax.ppermute``)
  psum(x)         x (R, ...) → the sum over ranks; the replicated result is
                  held once, without the rank axis
  psum(x, digits=, tier=l)
                  the sum within each tier-l group, held per rank: (R, ...)
  pmin(x)         x (R, ...) → the minimum over ranks, held once
                  (``jax.lax.pmin``)

:class:`StackedCollectives` counts its calls in ``calls``, a Counter keyed
by :class:`Call` (kind, bytes, shape): a long drive adds counts, not
entries.  The port has no lowered HLO to audit, so the recorder is how the
collective budget is guarded: on ``exchange="padded"`` a round issues
exactly one payload ``all_to_all`` and one count ``all_to_all``, on
``exchange="hierarchical"`` one of each per non-trivial tier (a call's
``tier`` names it), on ``exchange="ragged"`` one ``ragged_all_to_all`` and
one count ``all_gather``.  A ``ragged_all_to_all`` call records its static
result bytes, ``(capacity, W)`` words a rank, as the reference's HLO reader
counts the op; the live rows it moves are data and are not read here (that
would cost a host sync a round).  A ``torch.distributed`` backend will sit behind the
same methods.

Tier layouts.  A multi-tier rank axis is a tuple of digit sizes, slowest
first; rank ``r``'s digits are lexicographic, slowest-major (``r = (d_0·A_1
+ d_1)·A_2 + …``, the ``jax.lax.axis_index`` of the reference's flattened
mesh axes).  :func:`node_layout`, :func:`pod_layout` and
:func:`joint_tiers` give the reference's test meshes (``launch/mesh.py``'s
``make_node_mesh``, ``make_pod_mesh``, and a tier that groups several mesh
axes) as such layouts.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Counter, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.marshal import ops as marshal_ops

__all__ = [
    "Call", "StackedCollectives", "joint_tiers", "node_layout", "pod_layout", "tier_digit",
]


@dataclasses.dataclass(frozen=True)
class Call:
    kind: str  # "all_to_all" | "ragged_all_to_all" | "all_gather" | "ppermute" | "psum" | "pmin"
    nbytes: int  # bytes of the stacked input (every rank's contribution)
    shape: Tuple[int, ...]
    tier: Optional[int] = None  # the tier of a one-tier call


def node_layout(nodes: int = 2, devices_per_node: int = 4) -> Tuple[int, int]:
    """The (node, device) layout of ``make_node_mesh``: node-major ranks."""
    return (nodes, devices_per_node)


def pod_layout(pods: int = 2, nodes: int = 2, devices_per_node: int = 2) -> Tuple[int, int, int]:
    """The (pod, node, device) layout of ``make_pod_mesh``."""
    return (pods, nodes, devices_per_node)


def joint_tiers(layout: Sequence[int], groups: Sequence[Sequence[int]]) -> Tuple[int, ...]:
    """Tier sizes of a layout whose consecutive axes are grouped into joint
    tiers: ``joint_tiers((2, 2, 2), ((0, 1), (2,))) == (4, 2)``, the
    reference's ``axis_name=(("pod", "node"), "device")``.  Grouping
    consecutive slowest-major digits keeps every rank's index."""
    flat = [a for g in groups for a in g]
    if flat != list(range(len(layout))):
        raise ValueError(f"groups {groups} must cover the axes 0..{len(layout) - 1} in order")
    return tuple(math.prod(layout[a] for a in g) for g in groups)


def tier_digit(level_sizes: Sequence[int], tier: int, device=None) -> torch.Tensor:
    """Every rank's digit on ``tier`` (``(R,)`` int64): the stacked form of
    ``jax.lax.axis_index(axis_name[tier])``."""
    stride = math.prod(level_sizes[tier + 1:])
    r = torch.arange(math.prod(level_sizes), device=device)
    return (r // stride) % level_sizes[tier]


def _group_members(level_sizes: Sequence[int], tier: int, device=None) -> torch.Tensor:
    """``(R, A_l)`` int64: the ranks of every rank's tier-``tier`` group,
    in digit order (rank r's digit l replaced by 0 … A_l − 1)."""
    stride = math.prod(level_sizes[tier + 1:])
    r = torch.arange(math.prod(level_sizes), device=device)
    base = r - tier_digit(level_sizes, tier, device=device) * stride
    return base[:, None] + torch.arange(level_sizes[tier], device=device)[None, :] * stride


@dataclasses.dataclass
class StackedCollectives:
    """Rank-stacked collectives with a call recorder."""

    calls: Counter[Call] = dataclasses.field(default_factory=collections.Counter)

    def _record(self, kind: str, x: torch.Tensor, tier: Optional[int] = None) -> None:
        self.calls[Call(kind, x.numel() * x.element_size(), tuple(x.shape), tier)] += 1

    def all_to_all(
        self, x: torch.Tensor, *, digits: Optional[Sequence[int]] = None, tier: Optional[int] = None
    ) -> torch.Tensor:
        """Flat: ``x (R_src, R_dst, ...)``.  With ``digits`` (the tier
        layout) and ``tier`` l: ``x (R, A_l, ...)``, the swap along digit
        l — in the digit view ``(A_0, …, A_{L-1}, A_l, ...)`` axes l and L
        trade places."""
        if digits is None:
            if x.dim() < 2 or x.shape[0] != x.shape[1]:
                raise ValueError(f"all_to_all takes (R_src, R_dst, ...), got {tuple(x.shape)}")
            self._record("all_to_all", x)
            return x.transpose(0, 1).contiguous()
        digits = tuple(digits)
        if x.dim() < 2 or x.shape[0] != math.prod(digits) or x.shape[1] != digits[tier]:
            raise ValueError(
                f"a tier-{tier} all_to_all over {digits} takes (R, A_l, ...), got {tuple(x.shape)}"
            )
        self._record("all_to_all", x, tier)
        rest = tuple(x.shape[2:])
        view = x.reshape(digits + (digits[tier],) + rest)
        return view.transpose(tier, len(digits)).reshape(x.shape).contiguous()

    def ragged_all_to_all(
        self,
        x: torch.Tensor,  # (R, C, W) every sender's rows, segments in destination order
        output: Optional[torch.Tensor],  # (R, capacity, W), or None
        *,
        input_offsets: torch.Tensor,  # (R_src, R_dst)
        send_sizes: torch.Tensor,  # (R_src, R_dst)
        output_offsets: torch.Tensor,  # (R_src, R_dst): where s's block lands on d
        recv_sizes: torch.Tensor,  # (R_dst, R_src)
        capacity: Optional[int] = None,
    ) -> torch.Tensor:
        """The stacked ``ragged_all_to_all``: receiver ``d``'s rows
        ``[output_offsets[s, d], + recv_sizes[d, s])`` become sender ``s``'s
        rows from ``input_offsets[s, d]``; every other row is ``output``'s
        (with ``output=None``, of shape ``(R, capacity, W)``, those rows
        carry no contract).  ``send_sizes[s, d]`` must equal ``recv_sizes[d,
        s]`` and each receiver's landing intervals must be disjoint and in
        source order, as the replicated control plane gives them; nothing
        is checked on the device.

        One output-driven gather over the flattened ``(R·C, W)`` rows, no
        host sync and no data-dependent shape: receiver ``d``'s lane ``j``
        finds its source ``s`` by a search over column ``d``'s landing
        starts and reads row ``s·C + input_offsets[s, d] + j −
        output_offsets[s, d]`` (K1 ``gather_rows``).  The index math is
        int32, so ``R·C + capacity`` must stay below 2^31."""
        del send_sizes  # the receiver's view (recv_sizes) drives the gather
        R, C, W = x.shape
        cap = output.shape[1] if output is not None else capacity
        if cap is None:
            raise ValueError("ragged_all_to_all needs output or capacity")
        if R * C + cap >= 2**31:
            raise ValueError(f"ragged_all_to_all: {R} x {C} rows and {cap} lanes overflow its int32 row index")
        for name, t in (("input_offsets", input_offsets), ("output_offsets", output_offsets),
                        ("recv_sizes", recv_sizes)):
            if tuple(t.shape) != (R, R):
                raise ValueError(f"ragged_all_to_all: {name} must be ({R}, {R}), got {tuple(t.shape)}")
        if output is not None and tuple(output.shape) != (R, cap, W):
            raise ValueError(f"ragged_all_to_all: output must be ({R}, {cap}, {W}), got {tuple(output.shape)}")
        self.calls[Call("ragged_all_to_all", R * cap * W * x.element_size(), (R, cap, W))] += 1
        i32 = lambda t: t.to(torch.int32)
        starts = i32(output_offsets).transpose(0, 1).contiguous()  # (R_dst, R_src)
        lane = torch.arange(cap, dtype=torch.int32, device=x.device).expand(R, cap).contiguous()
        s = (torch.searchsorted(starts, lane, right=True) - 1).clamp_(min=0)  # the lane's source rank
        # the flat row that lane 0 of each landing interval would read
        base = torch.arange(R, dtype=torch.int32, device=x.device)[None, :] * C + i32(input_offsets).T - starts
        src = torch.gather(base, 1, s) + lane
        out = marshal_ops.gather_rows(x.reshape(1, R * C, W), src.reshape(1, R * cap)).view(R, cap, W)
        if output is None:
            return out
        landed = (lane >= torch.gather(starts, 1, s)) & (lane < torch.gather(starts + i32(recv_sizes), 1, s))
        return torch.where(landed[:, :, None], out, output)

    def all_gather(
        self, x: torch.Tensor, *, digits: Optional[Sequence[int]] = None, tier: Optional[int] = None
    ) -> torch.Tensor:
        """Flat: ``(R, ...) → (R, R, ...)``.  With ``digits`` and ``tier``
        l: ``(R, ...) → (R, A_l, ...)``, each rank's tier-l group."""
        if digits is None:
            self._record("all_gather", x)
            return x.unsqueeze(0).expand((x.shape[0],) + tuple(x.shape))
        self._record("all_gather", x, tier)
        return x[_group_members(digits, tier, x.device)]

    def ppermute(self, x: torch.Tensor) -> torch.Tensor:
        """The ring hop: rank i's ``x[i]`` lands on rank ``(i + 1) % R``."""
        self._record("ppermute", x)
        return torch.roll(x, 1, dims=0)

    def psum(
        self, x: torch.Tensor, *, digits: Optional[Sequence[int]] = None, tier: Optional[int] = None
    ) -> torch.Tensor:
        """Flat: the sum over ranks, held once.  With ``digits`` and
        ``tier``: each rank's tier-group sum, held per rank."""
        if digits is None:
            self._record("psum", x)
            return x.sum(dim=0, dtype=x.dtype)
        self._record("psum", x, tier)
        return x[_group_members(digits, tier, x.device)].sum(dim=1, dtype=x.dtype)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        self._record("pmin", x)
        return x.amin(dim=0)

    def count(self, kind: str, *, tier: Optional[int] = None) -> int:
        """Calls of ``kind``; with ``tier``, only that tier's."""
        return sum(n for c, n in self.calls.items()
                   if c.kind == kind and (tier is None or c.tier == tier))

    def reset(self) -> None:
        self.calls.clear()
