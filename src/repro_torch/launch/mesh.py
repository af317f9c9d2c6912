"""The ``(data, model)`` rank layout (counterpart of
``repro.launch.mesh.make_test_mesh``).

The reference builds a device mesh; the port runs its ranks rank-stacked on
one device, so a layout only says how many there are on each axis.  Rank
``g·model + m`` is data group g, model rank m: the row-major order of the
reference's ``(data, model)`` mesh.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Layout", "make_test_layout"]


@dataclasses.dataclass(frozen=True)
class Layout:
    data: int = 2
    model: int = 4

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"a layout needs at least one rank on each axis, got {self}")

    @property
    def num_ranks(self) -> int:
        return self.data * self.model


def make_test_layout(data: int = 2, model: int = 4) -> Layout:
    """The layout of the reference's ``make_test_mesh`` (default 2 × 4)."""
    return Layout(data, model)
