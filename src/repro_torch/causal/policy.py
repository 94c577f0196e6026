"""CausalPolicy: the one source of truth for causality decisions.

A frozen dataclass threaded through ``ClockRuntime``, ``ClockRegistry``
and gossip, and consumed by ``CausalEngine``.  The port has no autotune
table yet, so block shapes not set here resolve to built-in defaults
(one-vs-many bn=8, bm=512; all-pairs 64 x 64 pairs a CUDA block, bm=512)
and the all-pairs engine to what the reference picks when its table is
silent.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["CausalPolicy"]

_ENGINES = (None, "tri", "full", "mxu", "i32")


@dataclasses.dataclass(frozen=True)
class CausalPolicy:
    """Dispatch + confidence policy for all causality comparisons.

    fp_threshold   Eq. 3 confidence gate every admit/merge decision uses.
    engine         all-pairs engine: None = auto; "tri" / "full" / "mxu"
                   ask for a packed engine, "i32" for the int32 kernel.
    pack           pack int32 all-pairs inputs on the fly when their value
                   span fits a byte (False pins the int32 kernel).
    bi / bj        all-pairs CUDA tile, pairs per block along rows / cols
                   (32, 64 or 128; None = 64).  They change no result
                   and are kept for API parity with the reference.
    bm / bn        m-tile width and one-vs-many warps per CUDA block
                   (None = bm 512, bn 8).  bm fixes the float32 sum
                   order of the int32 kernels, so their sums are
                   bit-identical only at equal bm.
    observer       ``repro_torch.obs.Observer`` riding the policy (None =
                   null sinks).  Observers hash by identity, so the
                   policy stays hashable.
    """

    fp_threshold: float = 1e-4
    engine: Optional[str] = None
    pack: bool = True
    bi: Optional[int] = None
    bj: Optional[int] = None
    bm: Optional[int] = None
    bn: Optional[int] = None
    observer: Any = None

    def __post_init__(self):
        if self.engine not in _ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r}; pick one of {_ENGINES}")
