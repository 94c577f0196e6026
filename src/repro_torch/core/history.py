"""Timestamp history window (paper §3).

A ``History`` is a fixed-capacity ring of past clocks: the "moving
window in which the partial order of events can be inferred with high
confidence".  ``best_predecessor_fp`` compares against the closest
dominating stored timestamp instead of the newest one.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import clock as bc

__all__ = ["History", "init", "push", "best_predecessor_fp"]


@dataclasses.dataclass(frozen=True)
class History:
    """cells: int32[W, m] logical cells of the last W timestamps.
    sums:  float32[W] their increment counts.
    count: int32 number of valid entries (<= W).
    """

    cells: torch.Tensor
    sums: torch.Tensor
    count: torch.Tensor
    k: int = 4

    @property
    def window(self) -> int:
        return self.cells.shape[0]

    @property
    def m(self) -> int:
        return self.cells.shape[-1]


def init(window: int, m: int, k: int = 4, device=None) -> History:
    return History(
        cells=torch.zeros((window, m), dtype=torch.int32, device=device),
        sums=torch.zeros((window,), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        k=k,
    )


def push(h: History, c: bc.BloomClock) -> History:
    """Append a timestamp, evicting the oldest when full (ring shift)."""
    cells = torch.cat([h.cells[1:], c.logical_cells().reshape(1, -1)])
    sums = torch.cat([h.sums[1:], bc.clock_sum(c).reshape(1)])
    count = torch.clamp(h.count + 1, max=h.window)
    return History(cells=cells, sums=sums, count=count, k=h.k)


def best_predecessor_fp(h: History, other: bc.BloomClock):
    """Smallest Eq. 3 fp of "other -> stored t" over the stored
    timestamps t that dominate ``other`` (direct compare); returns
    (fp, index) with fp = +inf when none dominates."""
    lo = other.logical_cells()
    so = bc.clock_sum(other)
    dominates = (h.cells >= lo[None, :]).all(-1)
    valid = torch.arange(h.window, device=h.cells.device) >= (h.window - h.count)
    fps = bc.fp_rate(so, h.sums, h.m)
    fps = torch.where(dominates & valid, fps, torch.full_like(fps, float("inf")))
    idx = torch.argmin(fps)
    return fps[idx], idx
