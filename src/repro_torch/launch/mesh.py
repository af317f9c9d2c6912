"""The ``(data, model)`` rank layout (counterpart of
``repro.launch.mesh.make_test_mesh``).

The reference builds a device mesh; the port runs its ranks rank-stacked on
one device, so a layout says how many there are on each axis and where a
rank sits.  Rank ``g·model + m`` is data group g, model rank m
(:meth:`Layout.coords`): the row-major order of the reference's ``(data,
model)`` mesh, so the rank at position ``[g, m]`` of its ``mesh.devices``
is rank ``g·model + m`` here.  As a tier layout of the collectives
(``core.collectives``) it is :attr:`Layout.digits`, ``(data, model)``:
tier :data:`DATA_TIER` groups the ranks of one model rank across the data
groups, tier :data:`MODEL_TIER` the model ranks of one data group.  Two
planes run on it: the ``rafi_ep`` MoE dispatch, and the placed train and
serve state of the families (``launch.placement``: tensor or expert
parallelism over ``model``, FSDP over ``data``; under ``dp_over_model``
the batch rows over both).

A layout may carry the collective backend its ranks run on (``comm``, a
``core.collectives.DistributedCollectives``; None: the stacked backend), so
that every layer below the step functions finds it without an argument of
its own; comparisons and hashes ignore it.  Over a world of W processes
process p holds ranks ``[p·L, (p+1)·L)``, ``L = data·model / W``, and the
batch rows of the data groups those ranks belong to
(:meth:`Layout.data_block`): ``L / model`` whole groups when ``L ≥
model``, else one group's rows, replicated over that group's ``model /
L`` processes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core.collectives import backend

__all__ = ["DATA_TIER", "Layout", "MODEL_TIER", "make_test_layout"]

DATA_TIER, MODEL_TIER = 0, 1


@dataclasses.dataclass(frozen=True)
class Layout:
    data: int = 2
    model: int = 4
    comm: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"a layout needs at least one rank on each axis, got {self}")

    @property
    def num_ranks(self) -> int:
        return self.data * self.model

    @property
    def digits(self) -> Tuple[int, int]:
        """The layout as the collectives' tier digits, slowest first."""
        return self.data, self.model

    def coords(self, ranks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(data group, model rank)`` of each global rank id in ``ranks``."""
        return ranks // self.model, ranks % self.model

    def local_ranks(self, device=None) -> torch.Tensor:
        """``(L,)`` int64: the global ids of the ranks this process holds."""
        return backend(self.comm).ranks(self.num_ranks, device)

    def groups(self) -> Tuple[int, int, int]:
        """``(first group, groups held, model ranks held per group)`` of
        this process's block of ranks."""
        comm, R, tp = backend(self.comm), self.num_ranks, self.model
        L = comm.local_ranks(R)
        if L % tp and tp % L:
            raise ValueError(f"a process's {L} ranks neither hold whole data groups of {tp} model ranks "
                             "nor split one")
        return comm.rank_offset(R) // tp, max(L // tp, 1), min(L, tp)

    def data_block(self, batch: int) -> Tuple[int, int]:
        """Rows ``[lo, hi)`` of a global batch of ``batch`` rows that this
        process holds: its data groups' (module docstring)."""
        if batch % self.data:
            raise ValueError(f"the batch ({batch}) must divide over the data groups ({self.data})")
        g0, held, _ = self.groups()
        rows = batch // self.data
        return g0 * rows, (g0 + held) * rows

    def replicas(self) -> int:
        """Processes that hold the same batch rows (1 when a process holds
        whole groups)."""
        return self.model // self.groups()[2]


def make_test_layout(data: int = 2, model: int = 4, *, comm=None) -> Layout:
    """The layout of the reference's ``make_test_mesh`` (default 2 × 4),
    on the backend ``comm`` (None: stacked)."""
    return Layout(data, model, comm=comm)
