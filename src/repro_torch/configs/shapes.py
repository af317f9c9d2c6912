"""The assigned input-shape suite, shared by all 10 LM architectures (a
copy of ``repro.configs.shapes``).

  train_4k      seq 4,096  × global batch 256   → the train step
  prefill_32k   seq 32,768 × global batch 32    → prefill
  decode_32k    KV ctx 32,768 × global batch 128 → one decode step
  long_500k     KV ctx 524,288 × global batch 1  → one decode step;
                SUB-QUADRATIC archs only (rwkv6, recurrentgemma): see
                ``configs.registry.shape_suite`` for the skip.
"""
from __future__ import annotations

import dataclasses

__all__ = ["SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
