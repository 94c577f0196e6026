"""CausalPolicy: the one source of truth for causality decisions.

A frozen dataclass threaded through ``ClockRuntime``, ``ClockRegistry``
and gossip, and consumed by ``CausalEngine``.  The port has one
classify engine per slab layout and no autotune table yet, so block
shapes not set here resolve to the reference's built-in defaults
(bn=8, bm=512).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["CausalPolicy"]


@dataclasses.dataclass(frozen=True)
class CausalPolicy:
    """Dispatch + confidence policy for all causality comparisons.

    fp_threshold   Eq. 3 confidence gate every admit/merge decision uses.
    bm / bn        one-vs-many m-tile width and rows per CUDA block
                   (None = bm 512, bn 8).  bm fixes the float32 sum
                   order, so results are bit-identical only at equal bm.
    observer       ``repro_torch.obs.Observer`` riding the policy (None =
                   null sinks).  Observers hash by identity, so the
                   policy stays hashable.
    """

    fp_threshold: float = 1e-4
    bm: Optional[int] = None
    bn: Optional[int] = None
    observer: Any = None
