"""The ``(data, model)`` rank layout (counterpart of
``repro.launch.mesh.make_test_mesh``).

The reference builds a device mesh; the port runs its ranks rank-stacked on
one device, so a layout only says how many there are on each axis.  Rank
``g·model + m`` is data group g, model rank m: the row-major order of the
reference's ``(data, model)`` mesh.

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

from repro_torch.core.collectives import backend

__all__ = ["Layout", "make_test_layout"]


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
