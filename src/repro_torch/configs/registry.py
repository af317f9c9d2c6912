"""Architecture registry over the reference's ten configs (counterpart of
``repro.configs.registry``'s ``ARCHS``, ``get_config`` and
``get_smoke_config``, in its order).  Each config module is a copy of
the reference's, ``CONFIG`` (the published widths) and ``SMOKE`` (the
reduced one).
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

__all__ = ["ARCHS", "get_config", "get_smoke_config"]

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


def _module(arch: str):
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
