"""Collectives over the rank axis of rank-stacked tensors.

One H100 is one device, so the port runs R logical ranks in one process on
tensors whose leading axis is the rank.  Every collective the reference
issues inside ``shard_map`` becomes a tensor operation on that axis:

  all_to_all(x)   x (R_src, R_dst, ...) → out[dst, src] = x[src, dst]
                  (``jax.lax.all_to_all``, ``stages.a2a``)
  all_gather(x)   x (R, ...) → (R, R, ...): every rank sees every row
                  (a broadcast view, no copy)
  psum(x)         x (R, ...) → the sum over ranks; the replicated result is
                  held once, without the rank axis
  pmin(x)         x (R, ...) → the minimum over ranks, held once
                  (``jax.lax.pmin``)

:class:`StackedCollectives` counts its calls in ``calls``, a Counter keyed
by :class:`Call` (kind, bytes, shape): a long drive adds counts, not
entries.  The port has no lowered HLO to audit, so the recorder is how the
collective budget is guarded: on ``exchange="padded"`` a round issues
exactly one payload ``all_to_all`` and one count ``all_to_all``.  A
``torch.distributed`` backend will sit behind the same four methods.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Counter, Tuple

import torch

__all__ = ["Call", "StackedCollectives"]


@dataclasses.dataclass(frozen=True)
class Call:
    kind: str  # "all_to_all" | "all_gather" | "psum" | "pmin"
    nbytes: int  # bytes of the stacked input (every rank's contribution)
    shape: Tuple[int, ...]


@dataclasses.dataclass
class StackedCollectives:
    """Rank-stacked collectives with a call recorder."""

    calls: Counter[Call] = dataclasses.field(default_factory=collections.Counter)

    def _record(self, kind: str, x: torch.Tensor) -> None:
        self.calls[Call(kind, x.numel() * x.element_size(), tuple(x.shape))] += 1

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() < 2 or x.shape[0] != x.shape[1]:
            raise ValueError(f"all_to_all takes (R_src, R_dst, ...), got {tuple(x.shape)}")
        self._record("all_to_all", x)
        return x.transpose(0, 1).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._record("all_gather", x)
        return x.unsqueeze(0).expand((x.shape[0],) + tuple(x.shape))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        self._record("psum", x)
        return x.sum(dim=0, dtype=x.dtype)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        self._record("pmin", x)
        return x.amin(dim=0)

    def count(self, kind: str) -> int:
        return sum(n for c, n in self.calls.items() if c.kind == kind)

    def reset(self) -> None:
        self.calls.clear()
