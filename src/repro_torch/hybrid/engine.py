"""HybridEngine: exact clocks for the hot set over a packed bloom tail.

The serving population is Zipf-skewed: a small hot set absorbs most
classifies while the long tail sits cold.  Every session here is
described EXACTLY by a cheap host-side catalog entry — a prefix length
``v`` into the local event chain plus a handful of private event ids —
and the engine chooses a *representation* per session:

  hot   the catalog entry itself, shipped to the device as an
        ``[H, 2] (v, n_private)`` row.  Verdicts against the local
        chain at version ``V`` are exact set containment —
        ``query ≼ peer  ⟺  V ≤ v`` and ``peer ≼ query  ⟺  v ≤ V and
        n_private == 0`` — so the claimed AND measured fp is zero,
        and no O(m) cells are read at all;
  tail  the packed bloom row (u8 residuals + i32 base, int32 wide rows
        on the side dict) minted deterministically from the same
        catalog entry, compared by the usual Eq. 3 bloom math.

One ``classify()`` fuses both paths through the hybrid CUDA kernel
(``kernels.ops.hybrid``): hot row blocks and tail row blocks share one
grid.  Tail verdicts are bit-identical to a flat packed slab at the same
blocks; hot verdicts come back with fp ≡ 0.0.

Because minting is deterministic (double-hash probes mod m) and probe
indices fold exactly across power-of-two geometry changes
(``(x mod m) mod m' == x mod m'`` when ``m' | m``), demotion re-mints
bit-identically and ``resize_tail`` folds every live row — plus the
local chain — to a smaller ``m`` with per-row audit records that
replay bit-for-bit (``hybrid.adaptive.replay_resize``).

Promotion/demotion is access-count driven with hysteresis: a freshly
promoted row is demotion-immune for ``min_residency`` windows and at
most ``max_migrations_per_window`` representation changes happen per
window, so adversarial alternating access at the hot-set boundary
cannot thrash.

The catalog, the chain probes and the tail arrays are host-authoritative
numpy, as in ``repro.hybrid.engine``; the tail's device mirror is a pair
of tensors on the engine's device (``HybridEngine(device=None)`` means
the card).  Private events are hashed once, in batches, and their probes
kept per event id at the current geometry (folded on resize, exactly as
the chain's are); minting counts probes with ``np.bincount``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from repro_torch.causal.engine import CausalEngine, PackedSlab
from repro_torch.causal.policy import CausalPolicy
from repro_torch.causal.results import ClassifyResult
from repro_torch.core import clock as bc
from repro_torch.core import wire
from repro_torch.core.hashing import bloom_indices, stable_event_id
from repro_torch.device import resolve_device
from repro_torch.hybrid.adaptive import (AdaptiveConfig, AdaptivePolicy,
                                         fold_pow2)
from repro_torch.obs.audit import NULL_AUDIT
from repro_torch.obs.observer import resolve

__all__ = ["HybridConfig", "HybridEngine", "HybridSlab", "HybridView"]


@dataclasses.dataclass
class HybridSlab(PackedSlab):
    """A ``PackedSlab`` carrying an exact hot set alongside the tail.

    ``cells_u8``/``base``/``wide`` describe the TAIL rows only; the hot
    rows ride as ``(v, n_private)`` metadata plus their (geometry-
    independent) shadow total sums, as host numpy arrays.
    ``local_version`` must be the chain prefix length of the query clock
    this slab will be classified against — the exact verdicts are
    containment tests against it.  Result rows come back hot-first:
    ``[0, H)`` hot, ``[H, H+T)`` tail.
    """

    hot_meta: Optional[np.ndarray] = None   # [H, 2] int32 (v, n_private)
    hot_sums: Optional[np.ndarray] = None   # [H, 1] float32 shadow sums
    local_version: int = 0

    @property
    def hot_count(self) -> int:
        return 0 if self.hot_meta is None else int(self.hot_meta.shape[0])

    @property
    def rows(self) -> int:
        return self.hot_count + self.capacity


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Geometry and movement policy of a ``HybridEngine``."""

    m: int = 512                  # tail bloom cells (pow2; fold target)
    k: int = 4                    # hash probes per event
    hot_capacity: int = 64        # exact rows kept on device
    tail_capacity: int = 4096     # packed tail slots
    promote_after: int = 3        # window accesses that earn promotion
    min_residency: int = 2        # windows a hot row is demotion-immune
    max_migrations_per_window: int = 8
    window: int = 256             # touches per migration window
    fp_budget: Optional[float] = None  # attach an AdaptivePolicy when set
    interpret: Optional[bool] = None   # the reference's; without effect


@dataclasses.dataclass
class HybridView:
    """One fused classify over the whole population (host-side)."""

    sids: list
    hot: np.ndarray               # bool per row: served by the exact path
    q_le_p: np.ndarray
    p_le_q: np.ndarray
    fp_q_before_p: np.ndarray
    fp_p_before_q: np.ndarray
    sum_p: np.ndarray
    sum_q: float
    engine: str = ""

    def _i(self, sid) -> int:
        return self.sids.index(sid)

    def verdict_of(self, sid) -> str:
        i = self._i(sid)
        le, ge = bool(self.q_le_p[i]), bool(self.p_le_q[i])
        if le and ge:
            return "equal"
        if le:
            return "descendant"     # peer is ahead of the query
        if ge:
            return "ancestor"       # peer is in the query's past
        return "concurrent"

    def fp_of(self, sid) -> float:
        """Claimed fp of the strict verdict's direction (0 when none)."""
        i = self._i(sid)
        if bool(self.q_le_p[i]) and not bool(self.p_le_q[i]):
            return float(self.fp_q_before_p[i])
        if bool(self.p_le_q[i]) and not bool(self.q_le_p[i]):
            return float(self.fp_p_before_q[i])
        return 0.0


@dataclasses.dataclass
class _Session:
    """Catalog entry: the exact description every representation of the
    session is derived from."""

    v: int                        # local-chain prefix length
    events: tuple                 # ((hi, lo), ...) private event ids
    access: int = 0
    hot: bool = False
    slot: Optional[int] = None    # tail slot when not hot
    promoted_window: int = -(1 << 30)

    @property
    def n_private(self) -> int:
        return len(self.events)


class HybridEngine:
    """The hybrid front door (see module docstring)."""

    def __init__(self, cfg: HybridConfig = HybridConfig(), *,
                 policy: CausalPolicy | None = None, observer=None,
                 audit=None, device=None):
        self.cfg = cfg
        self.m = cfg.m
        self.k = cfg.k
        self.device = resolve_device(device)
        self.engine = CausalEngine(policy or CausalPolicy(
            interpret=cfg.interpret))
        self.obs = resolve(observer)
        self.audit = audit if audit is not None else NULL_AUDIT
        # local event chain: probe indices per event (k per row).  Probes
        # are stored mod the CURRENT m and fold exactly on resize.
        self._probes = np.zeros((0, cfg.k), np.int64)
        self._local_cells = np.zeros(cfg.m, np.int64)
        # private event id -> its [k] probes at the current m
        self._ev_probes: dict = {}
        self.sessions: dict = {}
        # hot set: insertion-ordered sid -> _Session (values alias
        # ``sessions``; the dict itself is the device row order)
        self._hot: dict = {}
        # tail arrays: the packed layout, host-authoritative with a
        # device mirror rebuilt lazily (``_dirty``)
        T = cfg.tail_capacity
        self._t_u8 = np.zeros((T, cfg.m), np.uint8)
        self._t_base = np.zeros(T, np.int64)
        self._t_sums = np.zeros(T, np.float32)
        self._t_alive = np.zeros(T, bool)
        self._t_wide: dict[int, np.ndarray] = {}
        self._t_free: list[int] = list(range(T - 1, -1, -1))
        self._t_order: list = []        # alive sids in slot-scan order
        self._dirty = True
        self._dev = None                # (cells_u8, base, wide, sids)
        # migration window bookkeeping
        self._window_idx = 0
        self._window_touches = 0
        self._window_migrations = 0
        self.promotions = 0
        self.demotions = 0
        self.resizes = 0
        self.adaptive = None
        if cfg.fp_budget is not None:
            self.adaptive = AdaptivePolicy(
                self, AdaptiveConfig(fp_budget=cfg.fp_budget))

    # ------------------------------------------------------------------
    # local chain
    # ------------------------------------------------------------------
    @property
    def local_version(self) -> int:
        return int(self._probes.shape[0])

    def append_local(self, event_hi: int, event_lo: int) -> None:
        """Record one local event: extends the chain every hot verdict
        is a containment test against, and ticks the local clock."""
        self._append_probes(self._hash([(event_hi, event_lo)]))

    def advance_local(self, count: int = 1) -> None:
        """Append ``count`` fresh deterministic local events."""
        v0 = self.local_version
        ids = [stable_event_id(b"hybrid/local", v0 + i) for i in range(count)]
        if ids:
            self._append_probes(self._hash(ids))

    def _append_probes(self, probes: np.ndarray) -> None:
        self._probes = np.concatenate([self._probes, probes])
        self._local_cells += np.bincount(probes.ravel(), minlength=self.m)

    def local_clock(self) -> bc.BloomClock:
        return bc.BloomClock(
            cells=torch.as_tensor(_fold_i32(self._local_cells),
                                  device=self.device),
            base=torch.zeros((), dtype=torch.int32, device=self.device),
            k=self.k)

    def _hash(self, events) -> np.ndarray:
        """[n, k] probe indices at the current m of n (hi, lo) event ids,
        in one hashing call."""
        ev = np.asarray(events, np.int64).reshape(-1, 2)
        return bloom_indices(ev[:, 0], ev[:, 1], self.k, self.m).numpy()

    def _cache_probes(self, events) -> None:
        """Hash the event ids not seen yet, all in one call."""
        missing = [e for e in dict.fromkeys(events) if e not in self._ev_probes]
        if missing:
            self._ev_probes.update(zip(missing, self._hash(missing)))

    def _event_probes(self, events) -> np.ndarray:
        """[len(events), k] probe indices of private event ids."""
        self._cache_probes(events)
        return np.stack([self._ev_probes[e] for e in events])

    # ------------------------------------------------------------------
    # admission / representation moves
    # ------------------------------------------------------------------
    def admit(self, sid, v: int, events=()) -> None:
        """Register a session from its exact description: a ``v``-long
        prefix of the local chain plus private event ids.  Lands in the
        tail representation; access counters promote it later."""
        self.admit_many([(sid, v, events)])

    def admit_many(self, items) -> None:
        """``admit`` of each ``(sid, v, events)`` in order, with the
        private events of all of them hashed in one batch."""
        items = [(sid, int(v), tuple((int(h), int(l)) for h, l in events))
                 for sid, v, events in items]
        self._cache_probes([e for _, _, events in items for e in events])
        for sid, v, events in items:
            if v > self.local_version:
                raise ValueError(
                    f"session prefix v={v} exceeds local chain "
                    f"length {self.local_version}")
            if sid in self.sessions:
                self.release(sid)
            s = _Session(v=v, events=events)
            self.sessions[sid] = s
            self._mint_into_tail(sid, s)

    def release(self, sid) -> None:
        s = self.sessions.pop(sid, None)
        if s is None:
            return
        if s.hot:
            self._hot.pop(sid, None)
        elif s.slot is not None:
            self._free_slot(s)

    def _mint_cells(self, s: _Session) -> np.ndarray:
        """Deterministic logical cells of a session's bloom shadow at
        the CURRENT geometry — a fold of any previous mint."""
        idx = self._probes[:s.v].ravel()
        if s.events:
            idx = np.concatenate([idx, self._event_probes(s.events).ravel()])
        return np.bincount(idx, minlength=self.m).astype(np.int64)

    def _mint_into_tail(self, sid, s: _Session) -> None:
        if not self._t_free:
            raise RuntimeError("tail slab full; grow tail_capacity")
        slot = self._t_free.pop()
        cells = self._mint_cells(s)
        base = int(cells.min()) if cells.size else 0
        resid = cells - base
        if resid.max(initial=0) <= 255:
            self._t_u8[slot] = resid.astype(np.uint8)
            self._t_base[slot] = base
            self._t_wide.pop(slot, None)
        else:
            self._t_u8[slot] = 0
            self._t_base[slot] = 0
            self._t_wide[slot] = _fold_i32(cells)
        self._t_sums[slot] = np.float32(cells.sum())
        self._t_alive[slot] = True
        s.slot = slot
        s.hot = False
        self._dirty = True

    def _free_slot(self, s: _Session) -> None:
        slot = s.slot
        self._t_alive[slot] = False
        self._t_wide.pop(slot, None)
        self._t_free.append(slot)
        s.slot = None
        self._dirty = True

    def promote(self, sid) -> None:
        """Switch a session to the exact representation."""
        s = self.sessions[sid]
        if s.hot:
            return
        if len(self._hot) >= self.cfg.hot_capacity:
            raise RuntimeError("hot set full; demote first")
        self._free_slot(s)
        s.hot = True
        s.promoted_window = self._window_idx
        self._hot[sid] = s
        self.promotions += 1
        self._window_migrations += 1
        if self.obs:
            self.obs.metrics.counter("hybrid_migrations",
                                     kind="promote").inc()

    def demote(self, sid) -> None:
        """Re-mint a hot session back into the packed tail (bit-identical
        to having always been a tail row: minting is deterministic)."""
        s = self.sessions[sid]
        if not s.hot:
            return
        self._hot.pop(sid)
        self._mint_into_tail(sid, s)
        self.demotions += 1
        self._window_migrations += 1
        if self.obs:
            self.obs.metrics.counter("hybrid_migrations",
                                     kind="demote").inc()

    # ---- access-driven movement with hysteresis ----
    def touch(self, sid) -> None:
        self._window_touches += 1
        if self._window_touches >= self.cfg.window:
            self._roll_window()
        s = self.sessions[sid]
        s.access += 1
        if s.hot or s.access < self.cfg.promote_after:
            return
        # each promotion is 1 migration; promotion-by-swap costs 2
        budget = (self.cfg.max_migrations_per_window
                  - self._window_migrations)
        if len(self._hot) < self.cfg.hot_capacity:
            if budget >= 1:
                self.promote(sid)
            return
        if budget < 2:
            return
        victim = self._demotion_victim(floor=s.access)
        if victim is not None:
            self.demote(victim)
            self.promote(sid)

    def _demotion_victim(self, floor: int) -> Optional[str]:
        """Least-touched residency-expired hot session strictly colder
        than ``floor``, or None — fresh promotions are immune, so an
        adversarial alternating pattern at the boundary cannot thrash."""
        expired = [
            (s.access, sid) for sid, s in self._hot.items()
            if self._window_idx - s.promoted_window >= self.cfg.min_residency
        ]
        if not expired:
            return None
        access, sid = min(expired)
        return sid if access < floor else None

    def _roll_window(self) -> None:
        self._window_idx += 1
        self._window_touches = 0
        self._window_migrations = 0
        for s in self.sessions.values():
            s.access = 0

    # ------------------------------------------------------------------
    # the fused classify front door
    # ------------------------------------------------------------------
    def _device_tail(self):
        """Alive-compacted device mirror of the tail (lazily rebuilt)."""
        if not self._dirty and self._dev is not None:
            return self._dev
        order = [sid for sid, s in self.sessions.items() if not s.hot]
        slots = np.asarray([self.sessions[sid].slot for sid in order],
                           np.int64)
        u8 = self._t_u8[slots]
        base = _fold_i32(self._t_base[slots])
        wide = {int(i): self._t_wide[int(slots[i])]
                for i in np.flatnonzero(np.isin(slots, list(self._t_wide)))}
        self._dev = (torch.as_tensor(u8, device=self.device),
                     torch.as_tensor(base, device=self.device), wide, order)
        self._t_order = order
        self._dirty = False
        return self._dev

    def slab(self) -> HybridSlab:
        """The population as one hot-carrying slab (hot rows first)."""
        u8, base, wide, order = self._device_tail()
        hot = list(self._hot.values())
        meta = np.asarray([[s.v, s.n_private] for s in hot],
                          np.int32).reshape(len(hot), 2)
        sums = np.asarray([[self.k * (s.v + s.n_private)] for s in hot],
                          np.float32).reshape(len(hot), 1)
        return HybridSlab(
            cells_u8=u8, base=base, wide=wide,
            hot_meta=meta, hot_sums=sums,
            local_version=self.local_version)

    def classify(self, *, bn: int | None = None,
                 bm: int | None = None) -> HybridView:
        """Classify the local clock against every session in ONE fused
        device sweep: exact verdicts (fp ≡ 0) for the hot set, packed
        bloom verdicts (bit-identical to a flat slab) for the tail."""
        slab = self.slab()
        hot_sids = list(self._hot)
        tail_sids = self._t_order
        H, T = len(hot_sids), len(tail_sids)
        query = self.local_clock()
        if H and T:
            res = self.engine.classify(query, slab, bn=bn, bm=bm)
        elif T:
            res = self.engine.classify(
                query, PackedSlab(slab.cells_u8, slab.base, wide=slab.wide),
                bn=bn, bm=bm)
        elif H:
            res = self._hot_only_result(slab)
        else:
            return HybridView(sids=[], hot=np.zeros(0, bool),
                              q_le_p=np.zeros(0, bool),
                              p_le_q=np.zeros(0, bool),
                              fp_q_before_p=np.zeros(0, np.float32),
                              fp_p_before_q=np.zeros(0, np.float32),
                              sum_p=np.zeros(0, np.float32),
                              sum_q=float(self._local_cells.sum()),
                              engine="empty")
        res = res.to_host()
        view = HybridView(
            sids=hot_sids + tail_sids,
            hot=np.arange(H + T) < H,
            q_le_p=np.asarray(res.q_le_p, bool),
            p_le_q=np.asarray(res.p_le_q, bool),
            fp_q_before_p=np.asarray(res.fp_q_before_p, np.float32),
            fp_p_before_q=np.asarray(res.fp_p_before_q, np.float32),
            sum_p=np.asarray(res.sum_p, np.float32),
            sum_q=float(np.asarray(res.sum_q)),
            engine=res.engine or "")
        if self.obs:
            self.obs.metrics.counter("hybrid_classified", path="hot").inc(H)
            self.obs.metrics.counter("hybrid_classified", path="tail").inc(T)
            self.obs.metrics.gauge("hybrid_hot_occupancy").set(H)
            self.obs.metrics.gauge("hybrid_tail_m").set(self.m)
            strict = view.q_le_p[H:] ^ view.p_le_q[H:]
            fps = np.where(view.q_le_p[H:], view.fp_q_before_p[H:],
                           view.fp_p_before_q[H:])[strict]
            if fps.size:
                self.obs.metrics.histogram("hybrid_tail_fp").observe_many(
                    np.clip(fps, 1e-30, 1.0))
        if self.adaptive is not None:
            self.adaptive.observe(view)
        return view

    def _hot_only_result(self, slab: HybridSlab) -> ClassifyResult:
        """Host containment math for the degenerate no-tail population —
        same verdict semantics as the kernel's hot rows (numpy leaves)."""
        V = slab.local_version
        v = slab.hot_meta[:, 0]
        npriv = slab.hot_meta[:, 1]
        z = np.zeros(v.shape[0], np.float32)
        return ClassifyResult(
            q_le_p=V <= v, p_le_q=(v <= V) & (npriv == 0),
            sum_q=np.float32(self._local_cells.sum()),
            sum_p=slab.hot_sums[:, 0].copy(),
            fp_q_before_p=z, fp_p_before_q=z.copy(), engine="hot_exact")

    def hot_hit_rate(self) -> float:
        """Fraction of classified rows served by the exact path."""
        if not self.obs:
            return 0.0
        hot = self.obs.metrics.counter("hybrid_classified", path="hot").value
        tail = self.obs.metrics.counter("hybrid_classified",
                                        path="tail").value
        total = hot + tail
        return hot / total if total else 0.0

    # ------------------------------------------------------------------
    # all-pairs
    # ------------------------------------------------------------------
    def pairs(self, *, bi=None, bj=None, bm=None):
        """All-pairs over the population: the packed sweep over every
        row's bloom shadow (bit-identical to a flat slab), with the
        hot-hot block patched to exact containment verdicts (fp ≡ 0).
        Returns (``ComparisonMatrix`` on the engine's device, sid order)."""
        hot_sids = list(self._hot)
        _, _, _, tail_sids = self._device_tail()
        order = hot_sids + tail_sids
        N, H = len(order), len(hot_sids)
        if N == 0:
            raise ValueError("empty population")
        logical = np.empty((N, self.m), np.int64)
        for i, sid in enumerate(hot_sids):
            logical[i] = self._mint_cells(self._hot[sid])
        if tail_sids:
            slots = np.asarray([self.sessions[sid].slot for sid in tail_sids],
                               np.int64)
            logical[H:] = self._t_u8[slots] + self._t_base[slots][:, None]
            for i in np.flatnonzero(np.isin(slots, list(self._t_wide))):
                logical[H + i] = self._tail_logical(int(slots[i]))
        # re-pack every row as the reference does: a row whose span
        # exceeds a byte goes to the int32 side dict
        b = logical.min(axis=1)
        resid = logical - b[:, None]
        fits = resid.max(axis=1) <= 255
        u8 = np.where(fits[:, None], resid, 0).astype(np.uint8)
        base = np.where(fits, b, 0)
        wide = {int(i): _fold_i32(logical[i]) for i in np.flatnonzero(~fits)}
        slab = PackedSlab(torch.as_tensor(u8, device=self.device),
                          torch.as_tensor(_fold_i32(base), device=self.device),
                          base_host=base, wide=wide)
        res = self.engine.pairs(slab, bi=bi, bj=bj, bm=bm)
        if H:
            blk = torch.as_tensor(
                _containment([self._hot[sid] for sid in hot_sids]),
                device=res.le.device)
            # in place: the matrices are this call's own, and a copy of
            # each [N, N] matrix would double the device memory
            res.le[:H, :H] = blk
            res.ge[:H, :H] = blk.T
            res.conc[:H, :H] = ~(blk | blk.T)
            res.fp[:H, :H] = 0.0
            res = dataclasses.replace(
                res, engine=(res.engine or "") + "+hot_exact")
        return res, order

    def _tail_logical(self, slot: int) -> np.ndarray:
        if slot in self._t_wide:
            return (np.asarray(self._t_wide[slot], np.int64)
                    & 0xFFFFFFFF)
        return self._t_u8[slot].astype(np.int64) + int(self._t_base[slot])

    # ------------------------------------------------------------------
    # geometry resize (quiesce-point fold)
    # ------------------------------------------------------------------
    def resize_tail(self, new_m: int, *, detail: str = "") -> None:
        """Fold the tail geometry to ``new_m`` (a power-of-two divisor
        of the current ``m``) at a quiesce point.

        The fold is EXACT: probe indices are ``mod m``, so
        ``cell'[j] = Σ_i cells[j + i·new_m]`` equals minting at
        ``new_m`` outright, and total sums are geometry-independent.
        Every live row gets an audit record carrying its pre-fold wire
        frame and the folded row's CRC, so ``replay_resize`` re-checks
        the whole migration bit-for-bit (a null audit skips building
        the frames)."""
        old_m = self.m
        if new_m == old_m:
            return
        if new_m <= 0 or old_m % new_m or (new_m & (new_m - 1)):
            raise ValueError(f"new_m={new_m} must be a pow2 divisor "
                             f"of m={old_m}")
        live = [(sid, s) for sid, s in self.sessions.items() if not s.hot]
        self.audit.record(
            "resize", "hybrid/tail",
            detail=json.dumps({"old_m": old_m, "new_m": new_m,
                               "rows": len(live),
                               "policy": detail}, sort_keys=True))
        if self.audit:
            for sid, s in live:
                cells = self._tail_logical(s.slot)
                snap = {"cells": _fold_i32(cells), "base": 0, "k": self.k}
                folded = fold_pow2(cells, new_m)
                self.audit.record(
                    "resize_row", sid,
                    local_frame=wire.encode_clock(snap),
                    peer_crc=wire.cells_crc(_fold_i32(folded)),
                    detail=json.dumps({"new_m": new_m}))
        # fold the chain and event probes + local clock, then re-slot
        # every row
        self.m = new_m
        self._probes = self._probes % new_m
        self._ev_probes = {e: p % new_m for e, p in self._ev_probes.items()}
        self._local_cells = fold_pow2(self._local_cells, new_m)
        self._t_u8 = np.zeros((self.cfg.tail_capacity, new_m), np.uint8)
        self._t_base[:] = 0
        self._t_sums[:] = 0.0
        self._t_alive[:] = False
        self._t_wide.clear()
        self._t_free = list(range(self.cfg.tail_capacity - 1, -1, -1))
        for sid, s in live:
            s.slot = None
            self._mint_into_tail(sid, s)
        self.resizes += 1
        self._dirty = True
        if self.obs:
            self.obs.metrics.counter("hybrid_resizes").inc()
            self.obs.metrics.gauge("hybrid_tail_m").set(new_m)


def _containment(sessions) -> np.ndarray:
    """[H, H] bool: session a's events are inside session b's — chain
    prefix ``v_a <= v_b`` and a's private event set inside b's (counted
    through a 0/1 incidence product, exact in float32)."""
    v = np.asarray([s.v for s in sessions], np.int64)
    keys: dict = {}
    rows, cols = [], []
    for a, s in enumerate(sessions):
        for e in set(s.events):
            rows.append(a)
            cols.append(keys.setdefault(e, len(keys)))
    inc = np.zeros((len(sessions), len(keys)), np.float32)
    inc[rows, cols] = 1.0
    inside = (inc @ inc.T) == inc.sum(axis=1)[:, None]
    return (v[:, None] <= v[None, :]) & inside


def _fold_i32(cells) -> np.ndarray:
    """Fold int64 logical values onto the int32 mod-2^32 circle."""
    return (np.asarray(cells, np.int64)
            & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
