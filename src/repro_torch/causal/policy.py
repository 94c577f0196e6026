"""CausalPolicy: the one source of truth for causality decisions.

A frozen dataclass threaded through ``ClockRuntime``, ``ClockRegistry``
and gossip, and consumed by ``CausalEngine``.  Block shapes and the
all-pairs engine not set here resolve, as in the reference, through the
measured table of ``kernels.autotune`` (unless ``autotune`` is False),
else to built-in defaults (one-vs-many bn=8, bm=512; all-pairs 64 x 64
pairs a CUDA block, bm=512; the engine the reference picks when its
table is silent).  A ``mesh`` (``launch.mesh.FleetMesh``) shards slab
comparisons over its devices, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.sharding import FLEET_AXIS

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
    mesh / axis    a ``launch.mesh.FleetMesh`` and its axis: slab
                   comparisons run per row shard (one-vs-many once a
                   shard) or on a gathered replica (all-pairs), with
                   results bit-identical to one device at every shard
                   count.
    bi / bj        all-pairs CUDA tile, pairs per block along rows / cols
                   (32, 64 or 128; None = the table's, else 64).  They
                   change no result.
    bm / bn        m-tile width and one-vs-many warps per CUDA block
                   (None = the table's, else bm 512, bn 8).  bm fixes
                   the float32 sum order of the one-vs-many and int32
                   kernels, so their sums are bit-identical only at
                   equal bm.
    autotune       consult the measured engine/block table
                   (``kernels.autotune``); False = built-in defaults.
    interpret      the reference's Pallas interpret mode, kept for its
                   callers and without effect: a tensor's device picks
                   the CUDA kernel or its plain version.
    observer       ``repro_torch.obs.Observer`` riding the policy (None =
                   null sinks).  Observers hash by identity, so the
                   policy stays hashable.
    """

    fp_threshold: float = 1e-4
    engine: Optional[str] = None
    pack: bool = True
    mesh: Any = None
    axis: str = FLEET_AXIS
    bi: Optional[int] = None
    bj: Optional[int] = None
    bm: Optional[int] = None
    bn: Optional[int] = None
    autotune: bool = True
    interpret: Optional[bool] = None
    observer: Any = None

    def __post_init__(self):
        if self.engine not in _ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r}; pick one of {_ENGINES}")

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def shards(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[self.axis]

    def merged(self, **overrides) -> "CausalPolicy":
        """Policy with the non-None overrides applied (per-call knobs)."""
        kept = {k: v for k, v in overrides.items() if v is not None}
        return dataclasses.replace(self, **kept) if kept else self

    def label(self) -> str:
        """Compact human/JSON descriptor (bench records, dashboards)."""
        parts = [f"fp<={self.fp_threshold:g}",
                 f"engine={self.engine or 'auto'}"]
        if not self.pack:
            parts.append("pack=off")
        if not self.autotune:
            parts.append("autotune=off")
        if self.mesh is not None:
            parts.append(f"shards={self.shards}:{self.axis}")
        blocks = {k: v for k, v in
                  (("bi", self.bi), ("bj", self.bj),
                   ("bm", self.bm), ("bn", self.bn)) if v is not None}
        if blocks:
            parts.append(",".join(f"{k}{v}" for k, v in blocks.items()))
        return " ".join(parts)
