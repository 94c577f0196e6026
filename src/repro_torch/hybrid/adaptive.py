"""AdaptivePolicy: fp-budget-driven (m, k) for the hybrid tail.

Host-side numpy, as in ``repro.hybrid.adaptive``, which this module
mirrors without importing it.

Operators declare an ``fp_budget``; nobody hand-picks (m, k).  The
policy watches the claimed-fp histogram the engine streams per classify
window and, when the budget has slack, re-derives the smallest tail
geometry that still meets it — then migrates at a quiesce point via the
EXACT power-of-two fold (``fold_pow2``), with per-row audit records so
the whole migration replays bit-for-bit (``replay_resize``).

The derivation inverts paper Eq. 3 at the binding operating point: the
claimed fp of a strict verdict is ``(1 - (1 - 1/m)^Σq)^Σp``, largest
for the peer with the SMALLEST total sum Σp — in a hybrid population
that peer lives in the tail, because the tiny-history sessions that
would otherwise pin m to a huge value are served exactly by the hot
set.  That is why the hybrid engine can run a smaller m at an equal
budget.

Shrink-only by design: growth would need re-minting from event history
(the engine CAN re-mint — it keeps exact descriptors — but a grown
geometry changes no verdict that was already within budget, so the
controller never pays for it).  The companion k recommendation
(``k ≈ ln2 · m / n̂`` clamped to [1, 8]) is reported in the audit
detail for the next minting epoch; the fold itself preserves k so
bit-identity holds across the resize.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

import numpy as np

from repro_torch.core import wire
from repro_torch.obs.audit import ReplayReport

__all__ = ["AdaptiveConfig", "AdaptivePolicy", "derive_mk", "fold_pow2",
           "replay_resize"]


def fold_pow2(cells, new_m: int) -> np.ndarray:
    """Exact geometry fold of counting-bloom cells to a pow2 divisor.

    Probes are ``(h1 + i·h2) mod m``; with ``new_m | m`` (both pow2),
    ``(x mod m) mod new_m == x mod new_m``, so summing the aliased
    cell groups is bit-identical to having minted at ``new_m``:
    ``cell'[j] = Σ_i cells[j + i·new_m]``.  Total sum is preserved."""
    cells = np.asarray(cells)
    m = cells.shape[-1]
    if m % new_m or (new_m & (new_m - 1)) or new_m <= 0:
        raise ValueError(f"new_m={new_m} must be a pow2 divisor of m={m}")
    shape = cells.shape[:-1] + (m // new_m, new_m)
    return cells.reshape(shape).sum(axis=-2)


def derive_mk(fp_budget: float, sum_q: float, sum_p_min: float, *,
              m_max: int, k: int, m_min: int = 128) -> tuple[int, int]:
    """Smallest pow2 ``m`` (a divisor of ``m_max``, ≥ ``m_min``) whose
    claimed Eq. 3 fp at the binding operating point (local sum Σq vs
    the smallest peer sum Σp) stays within budget, plus the textbook
    ``k`` for that geometry.

    Eq. 3: fp = (1 - (1 - 1/m)^Σq)^Σp ≤ B  ⟺
           (1 - 1/m)^Σq ≥ 1 - B^(1/Σp); evaluated with the same
    log1p/expm1 stabilization the kernels use."""
    if not (0.0 < fp_budget <= 1.0):
        raise ValueError(f"fp_budget={fp_budget} out of (0, 1]")
    if sum_p_min <= 0 or sum_q <= 0:
        return m_max, k

    def claimed(m: int) -> float:
        inner = -math.expm1(sum_q * math.log1p(-1.0 / m))
        return math.exp(sum_p_min * math.log(max(inner, 1e-300)))

    best = m_max
    m = m_max
    while m // 2 >= m_min and claimed(m // 2) <= fp_budget:
        m //= 2
        best = m
    n_hat = max(1.0, (sum_q + sum_p_min) / (2.0 * k))
    k_new = max(1, min(8, round(math.log(2.0) * best / n_hat)))
    return best, k_new


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Controller knobs — the only required one is the budget."""

    fp_budget: float = 1e-4
    window: int = 64          # classifies between re-derivations
    m_min: int = 128          # lane-aligned floor for the tail geometry
    headroom: float = 1.0     # budget scale the derivation aims at


class AdaptivePolicy:
    """Watches the per-window claimed-fp signal and resizes the tail.

    Attached by ``HybridEngine`` when its config declares ``fp_budget``;
    ``observe`` is called with every ``HybridView``.  The policy keeps
    the worst claimed fp and the smallest live tail sum seen in the
    window; at the window boundary it re-derives (m, k) and — when the
    geometry can shrink while honoring the budget — triggers the
    audited quiesce-point fold."""

    def __init__(self, engine, cfg: AdaptiveConfig = AdaptiveConfig()):
        self.engine = engine
        self.cfg = cfg
        self._seen = 0
        self._worst_fp = 0.0
        self._min_sum_p: Optional[float] = None
        self.last_recommendation: Optional[tuple[int, int]] = None

    def observe(self, view) -> None:
        tail = ~view.hot
        if tail.any():
            strict = (view.q_le_p ^ view.p_le_q) & tail
            if strict.any():
                fps = np.where(view.q_le_p, view.fp_q_before_p,
                               view.fp_p_before_q)[strict]
                self._worst_fp = max(self._worst_fp, float(fps.max()))
            sums = view.sum_p[tail]
            sums = sums[sums > 0]
            if sums.size:
                mn = float(sums.min())
                self._min_sum_p = (mn if self._min_sum_p is None
                                   else min(self._min_sum_p, mn))
        self._seen += 1
        if self._seen >= self.cfg.window:
            self.rederive(sum_q=view.sum_q)
            self._seen = 0
            self._worst_fp = 0.0
            self._min_sum_p = None

    def rederive(self, *, sum_q: float) -> tuple[int, int]:
        """One control step: invert Eq. 3 against the window's binding
        operating point and fold the tail if the budget allows."""
        eng = self.engine
        if self._min_sum_p is None:
            return eng.m, eng.k
        m_new, k_new = derive_mk(
            self.cfg.fp_budget * self.cfg.headroom, sum_q,
            self._min_sum_p, m_max=eng.m, k=eng.k, m_min=self.cfg.m_min)
        self.last_recommendation = (m_new, k_new)
        if m_new < eng.m:
            eng.resize_tail(m_new, detail=json.dumps({
                "fp_budget": self.cfg.fp_budget,
                "worst_claimed_fp": self._worst_fp,
                "min_sum_p": self._min_sum_p,
                "k_next_epoch": k_new}, sort_keys=True))
        return m_new, k_new


def replay_resize(trail) -> ReplayReport:
    """Re-verify a resize migration bit-for-bit from the audit trail.

    Every ``resize_row`` record carries the row's pre-fold wire frame
    and the CRC of the folded logical row the engine produced; replay
    decodes the frame, re-folds, and compares CRCs — exact regardless
    of what happened to the engine since.  Requires the trail to have
    been recorded with ``store_frames=True``."""
    rep = ReplayReport()
    for rec in trail.records:
        if rec.kind != "resize_row":
            continue
        if rec.local_frame is None:
            rep.skipped += 1
            continue
        rep.checked += 1
        snap = wire.decode_clock(rec.local_frame)
        new_m = int(json.loads(rec.detail)["new_m"])
        logical = (np.asarray(snap["cells"], np.int64)
                   + int(snap["base"]))
        folded = fold_pow2(logical & 0xFFFFFFFF, new_m)
        crc = wire.cells_crc(
            (folded & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
        if crc == rec.peer_crc:
            rep.matched += 1
        else:
            rep.mismatches.append({
                "seq": rec.seq, "peer_id": rec.peer_id,
                "recorded": rec.peer_crc, "replayed": crc})
    return rep
