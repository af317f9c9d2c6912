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
``tier`` names it).  A ``torch.distributed`` backend will sit behind the
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

__all__ = [
    "Call", "StackedCollectives", "joint_tiers", "node_layout", "pod_layout", "tier_digit",
]


@dataclasses.dataclass(frozen=True)
class Call:
    kind: str  # "all_to_all" | "all_gather" | "ppermute" | "psum" | "pmin"
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
