"""Assigned input shapes (one set, shared by all 10 LM-family archs).

- train_4k / prefill_32k lower full-sequence steps (train_step / prefill).
- decode_32k / long_500k lower ``serve_step``: ONE new token against a KV
  cache of seq_len.
- long_500k requires a sub-quadratic path: runs only for ssm/hybrid
  (mamba2-130m, hymba-1.5b); skipped for pure full-attention archs
  (the dry run records them as skipped).
"""
from __future__ import annotations

import dataclasses

__all__ = ["Shape", "SHAPES", "runnable", "cells"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str      # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

# families with a sub-quadratic long-context path
_LONG_OK_FAMILIES = ("ssm", "hybrid")


def runnable(arch_family: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_family in _LONG_OK_FAMILIES
    return True


def cells(arch_names_families: dict) -> list:
    """All (arch, shape) cells incl. skip markers."""
    out = []
    for arch, fam in arch_names_families.items():
        for s in SHAPES:
            out.append((arch, s, runnable(fam, s)))
    return out
