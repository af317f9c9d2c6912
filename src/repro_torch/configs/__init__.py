"""Architecture configs (copies of ``repro.configs``), registered by name,
and the shape suite of the dry run."""
from repro_torch.configs.registry import (
    ARCHS, SUB_QUADRATIC, Cell, get_config, get_smoke_config, input_specs, shape_suite,
)
from repro_torch.configs.shapes import SHAPES, ShapeSpec

__all__ = [
    "ARCHS", "SHAPES", "SUB_QUADRATIC", "Cell", "ShapeSpec", "get_config", "get_smoke_config", "input_specs",
    "shape_suite",
]
