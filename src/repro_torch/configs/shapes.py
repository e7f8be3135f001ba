"""Assigned input shapes — every (arch × shape) dry-run cell is defined here.

  train_4k      seq 4,096    global_batch 256   -> train_step
  prefill_32k   seq 32,768   global_batch 32    -> prefill (forward logits)
  decode_32k    seq 32,768   global_batch 128   -> serve_step (1 new token,
                                                   KV cache of seq_len)
  long_500k     seq 524,288  global_batch 1     -> serve_step; requires
                                                   sub-quadratic attention
"""
from __future__ import annotations

import dataclasses

__all__ = ["Shape", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # "train" | "prefill" | "decode"
    needs_subquadratic: bool = False


SHAPES = {
    "train_4k":    Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k":   Shape("long_500k", 524_288, 1, "decode",
                         needs_subquadratic=True),
}
