"""CausalEngine: the dispatch front-door over the compare engines.

    engine = CausalEngine(CausalPolicy(...))
    engine.classify(query, peers)   # one-vs-many -> ClassifyResult
    causal.compare(a, b)            # pairwise    -> Comparison

``classify`` takes a ``PackedSlab`` (the registry's u8 residual + int32
base layout; promoted rows are overlaid through the exact int32 kernel)
or an ``[N, m]`` int32 slab / batched ``BloomClock`` (int32 kernel).
The all-pairs verb, the hybrid hot-set branch and the sharded branch of
the reference are not ported yet.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch

from repro_torch.causal.policy import CausalPolicy
from repro_torch.causal.results import ClassifyResult, Comparison
from repro_torch.core import clock as bc
from repro_torch.kernels import ops
from repro_torch.obs.observer import resolve

__all__ = ["CausalEngine", "PackedSlab", "compare"]


def compare(a: bc.BloomClock, b: bc.BloomClock) -> Comparison:
    """Pairwise (broadcast/batched) typed comparison of two clocks."""
    o = bc.ordering(a, b)
    return Comparison(a_le_b=o.a_le_b, b_le_a=o.b_le_a,
                      fp_ab=o.fp_a_before_b, fp_ba=o.fp_b_before_a,
                      sum_a=bc.clock_sum(a), sum_b=bc.clock_sum(b))


@dataclasses.dataclass
class PackedSlab:
    """Packed peer-clock slab view handed to the front-door.

    u8 window residuals plus a per-slot int32 base.  ``wide`` maps a
    promoted slot (span beyond a byte, or a near-wrap base) to its host
    int32 logical row; those rows are re-classified exactly.
    """

    cells_u8: torch.Tensor                    # [N, m] uint8 residuals
    base: torch.Tensor                        # [N] int32 offsets
    wide: dict = dataclasses.field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.cells_u8.shape[0]


def _dispatch_label(fallback: str) -> tuple[str, tuple | None]:
    """(engine, blocks) metadata from the most recent ops dispatch."""
    d = ops.LAST_DISPATCH
    if not d:
        return fallback, None
    blocks = tuple((k, v) for k, v in sorted(d.items())
                   if k not in ("op", "engine"))
    return d.get("engine", fallback), blocks


def _as_cells(clocks, device=None) -> torch.Tensor:
    """int32 logical cells from a BloomClock (any batch shape) or array."""
    if isinstance(clocks, bc.BloomClock):
        return clocks.logical_cells().to(torch.int32)
    return torch.as_tensor(clocks, dtype=torch.int32, device=device)


class CausalEngine:
    """The causality front-door (see module docstring)."""

    def __init__(self, policy: CausalPolicy | None = None):
        self.policy = policy or CausalPolicy()
        self.obs = resolve(self.policy.observer)

    def classify(self, query, peers, *, bn: int | None = None,
                 bm: int | None = None) -> ClassifyResult:
        """Classify one query clock against N peers in one kernel call
        (plus one for promoted rows).  The query moves to the peers'
        device."""
        obs = self.obs
        if not obs:
            return self._classify(query, peers, bn=bn, bm=bm)
        packed = isinstance(peers, PackedSlab)
        with obs.trace.span("causal.classify",
                            pack="slab" if packed else "i32") as sp:
            res = self._classify(query, peers, bn=bn, bm=bm)
            n = peers.capacity if packed else int(res.sum_p.shape[-1])
            sp.set(engine=res.engine, n=n,
                   blocks=dict(res.blocks) if res.blocks else None)
            obs.metrics.counter("engine_dispatch", verb="classify",
                                engine=res.engine).inc()
        return res

    def _classify(self, query, peers, *, bn, bm) -> ClassifyResult:
        pol = self.policy
        bn = bn if bn is not None else pol.bn
        bm = bm if bm is not None else pol.bm
        ops.LAST_DISPATCH.clear()
        if isinstance(peers, PackedSlab):
            q = _as_cells(query).to(peers.cells_u8.device).contiguous()
            out = ops._classify_vs_many_packed(
                q, peers.cells_u8, peers.base, bn=bn, bm=bm)
            engine, blocks = _dispatch_label("packed")
            if peers.wide:
                widx = sorted(peers.wide)
                rows = torch.as_tensor(np.stack([peers.wide[s] for s in widx]),
                                       device=q.device)
                out = ops._overlay_wide_classify(out, q, widx, rows)
                engine += "+wide_overlay"
            return ClassifyResult.from_dict(out, engine=engine, blocks=blocks)
        cells = _as_cells(peers).contiguous()
        q = _as_cells(query).to(cells.device).contiguous()
        kw = {k: v for k, v in (("bn", bn), ("bm", bm)) if v is not None}
        out = ops._classify_vs_many(q, cells, **kw)
        return ClassifyResult.from_dict(out, engine="i32")
