"""Architecture registry over the reference's ten configs, and the
per-(arch × shape) input specs of the dry run (counterpart of
``repro.configs.registry``, in its order).  Each config module is a copy of
the reference's, ``CONFIG`` (the published widths) and ``SMOKE`` (the
reduced one).

``input_specs(arch, shape_name)`` gives a :class:`Cell`: which step the
shape runs (train / prefill / decode) and a batch of tensors on
``torch.device("meta")`` (shapes and dtypes only, nothing allocated) where
the reference gives ``jax.ShapeDtypeStruct`` objects, or the skip reason.  The
reference's ``batch_shardings`` has no twin: the port does not shard.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.models.common import ModelConfig

__all__ = ["ARCHS", "Cell", "SUB_QUADRATIC", "get_config", "get_smoke_config", "input_specs", "shape_suite"]

_MODULES = {
    "qwen2-7b": "qwen2_7b",
    "qwen2.5-14b": "qwen2_5_14b",
    "glm4-9b": "glm4_9b",
    "gemma3-1b": "gemma3_1b",
    "llama4-scout-17b-16e": "llama4_scout_17b_16e",
    "dbrx-132b": "dbrx_132b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "rwkv6-3b": "rwkv6_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCHS = tuple(_MODULES)

# archs that can run 524k-token decode (sub-quadratic sequence mixing)
SUB_QUADRATIC = ("rwkv6-3b", "recurrentgemma-2b")


def _module(arch: str):
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def shape_suite(arch: str):
    """(shape_name -> ShapeSpec | skip reason) for one architecture."""
    out: Dict[str, Any] = {}
    for name, spec in SHAPES.items():
        if name == "long_500k" and arch not in SUB_QUADRATIC:
            out[name] = (
                "SKIP: full-range attention layers are quadratic at 524k "
                "context (DESIGN.md §Arch-applicability)"
            )
        else:
            out[name] = spec
    return out


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: ShapeSpec
    step: str                 # train | prefill | decode
    batch: Dict[str, Any]     # meta tensors for the step's inputs
    skip: Optional[str] = None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str, cfg: Optional[ModelConfig] = None) -> Cell:
    """Meta-tensor stand-ins for every input of the (arch × shape) cell;
    tokens are int32, as the port's steps take them."""
    cfg = cfg or get_config(arch)
    entry = shape_suite(arch)[shape_name]
    if isinstance(entry, str):
        return Cell(arch, SHAPES[shape_name], "skip", {}, skip=entry)
    spec: ShapeSpec = entry
    b, s = spec.global_batch, spec.seq_len
    i32 = torch.int32

    if spec.step in ("train", "prefill"):
        if cfg.kind == "encdec":
            batch = {"frames": _meta((b, s // 8, cfg.d_model), cfg.jdtype), "tokens": _meta((b, s // 8), i32)}
        elif cfg.frontend == "vision":
            batch = {"tokens": _meta((b, s), i32), "embeds": _meta((b, s, cfg.d_model), cfg.jdtype)}
            if spec.step == "train":
                batch["labels"] = _meta((b, s - 1), i32)
        else:
            batch = {"tokens": _meta((b, s), i32)}
        return Cell(arch, spec, spec.step, batch)

    # decode: one new token against a seq_len-deep cache
    batch = {"token": _meta((b, 1), i32)}
    if cfg.kind == "encdec":
        batch["memory"] = _meta((b, 1024, cfg.d_model), cfg.jdtype)
    return Cell(arch, spec, "decode", batch)
