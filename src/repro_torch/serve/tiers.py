"""Tiered session-clock registry: hot card slab → warm host tier → cold disk.

One flat ``ClockRegistry`` slab caps the session population at whatever
fits the card.  Serving populations are heavy-tailed (a small hot
working set over a long cold tail), so the store is split by access
frequency:

  hot   the card's ``ClockRegistry`` slab: every hot session classifies
        in one packed one-vs-many kernel call;
  warm  the same §4 packed layout (u8 residuals + base, see
        ``kernels.pack``) in host arrays, pinned when the registry
        lives on the card, so a classify copies the slab over without
        blocking; promoted int32 rows ride a side dict as in the slab;
  cold  §4 wire frames (``core.wire.encode_clock``) in one append-only
        spill file with a host offset index: bounded only by disk.

Movement is access-count driven: ``touch``/``get``/``classify`` bump a
session's count; crossing ``promote_after`` promotes it one tier toward
the card.  Demotion happens under pressure: a full hot slab evicts its
least-touched rows (captured through the registry's ``on_evict`` hook:
the packed row moves, never a re-encode) into warm, and a full warm
tier spills its least-touched rows to disk.

``classify(query)`` is the one front door.  Each tier is classified
through the same ``CausalEngine`` the flat slab uses, over the same
packed layout, with the SAME kernel blocks, pinned once, because the
float32 sum order (and so the Eq. 3 fp bits) depends on the m-tile.
They resolve as the reference's do, once, at the flat-equivalent
capacity hot + warm: the policy's ``bn``/``bm``, else the autotune
table's entry for that shape (under ``policy.autotune``), else the
built-in bn = 8, bm = 512.  The result is bit-identical per session to
one flat ``ClockRegistry`` holding the whole population under the same
(pinned) policy.

Host writes into the warm arrays wait first for the last non-blocking
copy out of them (``_warm_fence``).
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.causal import CausalEngine, CausalPolicy, PackedSlab
from repro_torch.core import clock as bc
from repro_torch.core import wire
from repro_torch.fleet.registry import (ClockRegistry, FleetView, STATUS_NAMES,
                                        _near_wrap, view_from_classify)
from repro_torch.device import resolve_device
from repro_torch.kernels import autotune, ops
from repro_torch.obs.observer import resolve

__all__ = ["TierConfig", "TieredRegistry", "TieredView"]

TIERS = ("hot", "warm", "cold")


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """Capacity and movement policy of a ``TieredRegistry``."""

    hot_capacity: int = 256       # card ClockRegistry slab rows
    warm_capacity: int = 4096     # host packed rows
    promote_after: int = 3        # accesses that pull a row one tier up
    demote_batch: int = 32        # hot rows demoted per overflow
    spill_batch: int = 256        # warm rows spilled per overflow
    cold_batch: int = 16384       # cold rows decoded per classify chunk
    spill_dir: Optional[str] = None   # cold file location (None: a
                                      # temporary one, removed on close)
    # hysteresis: without these, two rows straddling a full hot slab
    # can thrash — promote() resets the access count, making the fresh
    # arrival the next eviction's first victim
    min_residency: int = 16       # admissions a promoted row is
                                  # eviction-immune for
    max_migrations_per_window: int = 64   # promotions allowed per window
    window: int = 1024            # touches per hysteresis window


@dataclasses.dataclass
class TieredView:
    """Per-session classification across every tier (host-side).

    Row order follows ``sids``; values are bit-identical to what one
    flat ``ClockRegistry.classify_all`` over the same population
    reports for each session.
    """

    sids: list
    status: np.ndarray        # int8 status code per session
    fp: np.ndarray            # float32 claimed-direction Eq. 3 fp
    sums: np.ndarray          # float32 cached clock sums
    tier: list                # "hot" | "warm" | "cold" per session
    local_sum: float
    engine: str = ""

    def verdict_of(self, sid) -> str:
        return STATUS_NAMES[int(self.status[self.sids.index(sid)])]

    def fp_of(self, sid) -> float:
        return float(self.fp[self.sids.index(sid)])

    def counts(self) -> dict:
        return {name: int(np.sum(self.status == code))
                for code, name in STATUS_NAMES.items()}

    def tier_counts(self) -> dict:
        return {t: self.tier.count(t) for t in TIERS}


def _fold_i32(cells: np.ndarray) -> np.ndarray:
    """Fold int64 logical values onto the int32 mod-2^32 circle."""
    return (np.asarray(cells, np.int64)
            & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def host_buffer(shape, dtype: torch.dtype, pinned: bool) -> torch.Tensor:
    """A zeroed host tensor, page-locked when ``pinned`` (copies from it
    to the card can then run without blocking the host)."""
    return torch.zeros(shape, dtype=dtype, pin_memory=pinned)


class TieredRegistry:
    """Hot/warm/cold session-clock store behind one classify front door.

    ``device`` places the hot slab (None = the card); the warm and cold
    tiers live on the host either way.
    """

    def __init__(self, cfg: TierConfig = TierConfig(), *, m: int = 64,
                 k: int = 4, policy: CausalPolicy | None = None,
                 device=None):
        self.cfg = cfg
        self.m = m
        self.k = k
        base_pol = policy if policy is not None else CausalPolicy()
        if base_pol.mesh is not None:
            # the tier split is a host-level construct; scale-out across
            # devices stays the flat slab's job, and the pin below is
            # resolved at the flat capacity
            base_pol = dataclasses.replace(base_pol, mesh=None)
        device = resolve_device(device)
        # Pin the one-vs-many blocks ONCE, resolved at the flat-equivalent
        # capacity: the table is keyed by slab N, and per-tier resolution
        # could tile m differently per tier and break the flat-slab
        # bit-identity.
        bn, bm = ops._one_vs_many_blocks(
            cfg.hot_capacity + cfg.warm_capacity, m, base_pol.bn,
            base_pol.bm, autotune.backend_of(device), base_pol.autotune)
        self.policy = dataclasses.replace(base_pol, bn=bn, bm=bm)
        self.blocks = (bn, bm)
        self.hot = ClockRegistry(capacity=cfg.hot_capacity, m=m, k=k,
                                 policy=self.policy, device=device)
        self.device = self.hot.device
        self.hot.on_evict = self._ingest_warm
        self.engine: CausalEngine = self.hot.engine
        self.obs = resolve(self.policy.observer)
        # warm tier: the slab layout, host-side; the int32 fold of the
        # bases is kept beside the int64 values for the card copy
        W = cfg.warm_capacity
        pinned = self.device.type == "cuda"
        self._w_u8_t = host_buffer((W, m), torch.uint8, pinned)
        self._w_base32_t = host_buffer((W,), torch.int32, pinned)
        self._w_u8 = self._w_u8_t.numpy()
        self._w_base32 = self._w_base32_t.numpy()
        self._w_base = host_buffer((W,), torch.int64, pinned).numpy()
        self._w_sums = host_buffer((W,), torch.float32, pinned).numpy()
        self._w_alive = host_buffer((W,), torch.bool, pinned).numpy()
        self._w_copied: Optional[torch.cuda.Event] = None
        self._w_wide: dict[int, np.ndarray] = {}
        self._w_slot_of: dict = {}
        self._w_free: list[int] = list(range(W - 1, -1, -1))
        # cold tier: append-only frame spill + offset index
        self._own_spill_dir = cfg.spill_dir is None
        self._spill_dir = cfg.spill_dir or tempfile.mkdtemp(
            prefix="bloomclock_cold_")
        os.makedirs(self._spill_dir, exist_ok=True)
        self._spill_path = os.path.join(self._spill_dir, "cold.bin")
        self._spill_file = None
        self._cold_index: dict = {}       # sid -> (offset, nbytes)
        # movement bookkeeping
        self._tier_of: dict = {}
        self._access: dict = {}
        self._age: dict = {}
        self._age_seq = 0
        self.promotions = 0
        self.demotions = 0
        self.spills = 0
        # hysteresis bookkeeping
        self._promoted_at: dict = {}
        self._window_touches = 0
        self._window_migrations = 0
        self.promotion_deferrals = 0

    # ---- membership ----
    def __len__(self) -> int:
        return len(self._tier_of)

    def __contains__(self, sid) -> bool:
        return sid in self._tier_of

    def tier_of(self, sid) -> str:
        return self._tier_of[sid]

    def sids(self) -> list:
        return list(self._tier_of)

    def occupancy(self) -> dict:
        return {
            "hot": len(self.hot),
            "warm": len(self._w_slot_of),
            "cold": len(self._cold_index),
        }

    def _note_occupancy(self) -> None:
        if self.obs:
            for tier, n in self.occupancy().items():
                self.obs.metrics.gauge("tier_occupancy", tier=tier).set(n)

    # ---- admission ----
    def admit(self, sid, clock: bc.BloomClock) -> None:
        self.admit_many({sid: clock})

    def admit_many(self, clocks: dict) -> None:
        """Admit (or overwrite) sessions into the HOT tier; one scatter
        for the batch.  A full hot slab demotes its least-touched rows
        into warm first (which may cascade a warm spill to cold)."""
        if not clocks:
            return
        items = list(clocks.items())
        # a batch larger than the hot slab lands in capacity-sized
        # waves; earlier waves demote into warm as later ones arrive
        step = max(1, self.hot.capacity // 2)
        for at in range(0, len(items), step):
            batch = dict(items[at:at + step])
            for sid in batch:   # re-admission supersedes the old copy
                if self._tier_of.get(sid) in ("warm", "cold"):
                    self._drop_from_tier(sid)
            fresh = [sid for sid in batch if sid not in self.hot]
            # never demote a row this wave is about to overwrite: the
            # re-admit would then need a slot the eviction just promised
            # to someone else
            self._ensure_hot_room(len(fresh), exclude=batch.keys())
            self.hot.admit_many(batch)
            for sid in batch:
                self._tier_of[sid] = "hot"
                self._access.setdefault(sid, 0)
                self._age[sid] = self._age_seq
                self._age_seq += 1
        self._note_occupancy()

    def release(self, sid) -> None:
        """Forget a session entirely (expiry)."""
        tier = self._tier_of.get(sid)
        if tier is None:
            return
        if tier == "hot":
            # a released row is gone, not demoted
            hook, self.hot.on_evict = self.hot.on_evict, None
            try:
                self.hot.evict(sid)
            finally:
                self.hot.on_evict = hook
        else:
            self._drop_from_tier(sid)
        del self._tier_of[sid]
        self._access.pop(sid, None)
        self._age.pop(sid, None)
        self._promoted_at.pop(sid, None)
        self._note_occupancy()

    # ---- access-driven movement ----
    def touch(self, sid) -> None:
        """Count one access; crossing ``promote_after`` promotes the
        session one tier toward the card, unless this window's
        migration budget is spent (hysteresis: an adversarial access
        pattern at the hot boundary gets a bounded number of moves per
        window, not one per touch)."""
        self._window_touches += 1
        if self._window_touches >= self.cfg.window:
            self._window_touches = 0
            self._window_migrations = 0
        self._access[sid] = self._access.get(sid, 0) + 1
        if (self._tier_of.get(sid) in ("warm", "cold")
                and self._access[sid] >= self.cfg.promote_after):
            if self._window_migrations >= self.cfg.max_migrations_per_window:
                self.promotion_deferrals += 1
                if self.obs:
                    self.obs.metrics.counter("tier_promotion_deferred").inc()
                return
            self.promote(sid)

    def promote(self, sid) -> None:
        """Pull a warm/cold session into the hot slab (exact row move:
        the stored clock re-admits bit-identically)."""
        tier = self._tier_of.get(sid)
        if tier not in ("warm", "cold"):
            return
        clock = self._host_clock(sid)
        self._drop_from_tier(sid)
        self._tier_of.pop(sid, None)
        self.admit_many({sid: clock})
        self._access[sid] = 0          # fresh residency, fresh count
        self._promoted_at[sid] = self._age_seq
        self.promotions += 1
        self._window_migrations += 1
        if self.obs:
            self.obs.metrics.counter("tier_promotions", src=tier).inc()

    def _victims(self, sids, count: int) -> list:
        """Least-touched first, oldest residency breaking ties.

        Freshly promoted rows (within ``min_residency`` admissions) are
        skipped while alternatives exist: ``promote`` resets the access
        count, so without this immunity the row just pulled up would be
        the very next eviction's first victim.  When every candidate is
        fresh the eviction still proceeds (room must be made)."""
        fresh = {s for s in sids
                 if self._age_seq - self._promoted_at.get(s, -(1 << 62))
                 < self.cfg.min_residency}
        ranked = sorted(sids, key=lambda s: (s in fresh,
                                             self._access.get(s, 0),
                                             self._age.get(s, 0)))
        return ranked[:count]

    def _ensure_hot_room(self, need: int, exclude=()) -> None:
        free = self.hot.capacity - len(self.hot)
        if free >= need:
            return
        short = need - free
        exclude = set(exclude)
        candidates = [s for s in self.hot.peer_ids() if s not in exclude]
        # rounded up to a demote_batch multiple, as in the reference: the
        # count decides which rows move
        db = self.cfg.demote_batch
        count = -(-max(short, db) // db) * db
        victims = self._victims(candidates, count)
        self.hot.evict_many(victims)   # on_evict hook lands them in warm

    def _warm_fence(self) -> None:
        """Wait for the last non-blocking copy out of the warm arrays
        before the host writes them."""
        if self._w_copied is not None:
            self._w_copied.synchronize()
            self._w_copied = None

    def _ingest_warm(self, captured: dict) -> None:
        """``ClockRegistry.on_evict`` hook: demoted hot rows arrive in
        the packed representation and land in the warm arrays as-is."""
        self._ensure_warm_room(len(captured))
        self._warm_fence()
        for sid, row in captured.items():
            slot = self._w_free.pop()
            self._w_slot_of[sid] = slot
            self._w_u8[slot] = row.cells_u8
            self._w_base[slot] = row.base
            self._w_base32[slot] = _fold_i32([row.base])[0]
            self._w_sums[slot] = row.sum
            self._w_alive[slot] = True
            if row.wide is not None:
                self._w_wide[slot] = row.wide
            else:
                self._w_wide.pop(slot, None)
            self._tier_of[sid] = "warm"
        self.demotions += len(captured)
        if self.obs:
            self.obs.metrics.counter("tier_demotions").inc(len(captured))

    def _ensure_warm_room(self, need: int) -> None:
        if len(self._w_free) >= need:
            return
        short = need - len(self._w_free)
        sb = self.cfg.spill_batch
        victims = self._victims(
            list(self._w_slot_of), -(-max(short, sb) // sb) * sb)
        self._spill(victims)

    def _spill(self, sids: list) -> None:
        """Encode warm rows as §4 wire frames and append them to the
        cold file (promoted rows ship int32; everything else ships
        u8 + base: the exact bytes ``get`` will decode back)."""
        f = self._spill_handle()
        self._warm_fence()
        for sid in sids:
            slot = self._w_slot_of.pop(sid)
            if slot in self._w_wide:
                snap = {"cells": self._w_wide.pop(slot),
                        "base": 0, "k": self.k}
            else:
                snap = {"cells": self._w_u8[slot].copy(),
                        "base": int(self._w_base[slot]), "k": self.k}
            frame = wire.encode_clock(snap)
            offset = f.tell()
            f.write(frame)
            self._cold_index[sid] = (offset, len(frame))
            self._w_alive[slot] = False
            self._w_free.append(slot)
            self._tier_of[sid] = "cold"
        f.flush()
        self.spills += len(sids)
        if self.obs:
            self.obs.metrics.counter("tier_spills").inc(len(sids))

    def _spill_handle(self):
        if self._spill_file is None:
            self._spill_file = open(self._spill_path, "a+b")
        self._spill_file.seek(0, os.SEEK_END)
        return self._spill_file

    def _read_frame(self, sid) -> bytes:
        offset, nbytes = self._cold_index[sid]
        f = self._spill_handle()
        f.seek(offset)
        return f.read(nbytes)

    def _drop_from_tier(self, sid) -> None:
        """Remove a session's warm/cold storage (tier map untouched)."""
        tier = self._tier_of.get(sid)
        if tier == "warm":
            self._warm_fence()
            slot = self._w_slot_of.pop(sid)
            self._w_alive[slot] = False
            self._w_wide.pop(slot, None)
            self._w_free.append(slot)
        elif tier == "cold":
            # the frame bytes stay orphaned in the append-only file;
            # compaction is an operator job (rewrite to a fresh file)
            self._cold_index.pop(sid, None)

    # ---- retrieval ----
    def stored_row(self, sid):
        """The stored clock of a session without a trip through the
        card: ``(None, slot)`` for a packed hot row (the caller gathers
        it on the card), else ``(cells, None)`` with its int32 logical
        cells on the host.  Not an access."""
        tier = self._tier_of[sid]
        if tier == "hot":
            slot = self.hot.slot_of(sid)
            if slot not in self.hot._wide:
                return None, slot
            return self.hot._wide[slot].copy(), None
        if tier == "warm":
            slot = self._w_slot_of[sid]
            if slot in self._w_wide:
                return self._w_wide[slot].copy(), None
            return _fold_i32(self._w_u8[slot].astype(np.int64)
                             + self._w_base[slot]), None
        snap = wire.decode_clock(self._read_frame(sid))
        return _fold_i32(np.asarray(snap["cells"]).astype(np.int64)
                         + int(snap["base"])), None

    def _host_clock(self, sid, device=None) -> bc.BloomClock:
        """A warm or cold session's clock, built on ``device`` (None =
        the host) in the representation the reference's ``get`` uses."""
        if self._tier_of[sid] == "cold":
            return bc.from_wire(wire.decode_clock(self._read_frame(sid)),
                                device=device)
        slot = self._w_slot_of[sid]
        if slot in self._w_wide:
            return bc.BloomClock(
                cells=torch.as_tensor(self._w_wide[slot], device=device),
                base=torch.zeros((), dtype=torch.int32, device=device),
                k=self.k)
        return bc.BloomClock(
            cells=torch.as_tensor(self._w_u8[slot].astype(np.int32),
                                  device=device),
            base=torch.tensor(int(self._w_base32[slot]), dtype=torch.int32,
                              device=device),
            k=self.k)

    def get(self, sid, count: bool = True) -> bc.BloomClock:
        """The session's clock from whichever tier holds it (cold rows
        decode their frame), on the registry's device.  Counts as an
        access unless ``count=False``: repeated gets promote a tail
        session toward the card."""
        if count:
            self.touch(sid)   # may promote it
        if self._tier_of[sid] == "hot":
            return self.hot.get(sid)
        return self._host_clock(sid, self.device)

    # ---- the classify front door ----
    def classify(self, query: bc.BloomClock,
                 sids: Optional[list] = None) -> TieredView:
        """Classify the query against every stored session (or the given
        subset), composing per-tier ``CausalEngine`` calls (same packed
        layout, same pinned kernel blocks) into one view that is
        bit-identical per session to a flat slab."""
        want = self.sids() if sids is None else list(sids)
        tier_idx = {t: [] for t in TIERS}
        for i, sid in enumerate(want):
            tier_idx[self._tier_of[sid]].append(i)
        status = np.zeros(len(want), np.int8)
        fp = np.zeros(len(want), np.float32)
        sums = np.zeros(len(want), np.float32)
        engines = []
        local_sum = float(bc.clock_sum(query))
        with self.obs.trace.span("tiers.classify", n=len(want)) as span:
            for tier in ("hot", "warm"):
                at = np.asarray(tier_idx[tier], np.int64)
                if not at.size:
                    continue
                if tier == "hot":
                    view = self.hot.classify_all(query)
                    slot_of = self.hot.slot_of
                else:
                    view = self._classify_warm(query)
                    slot_of = self._w_slot_of.__getitem__
                engines.append(f"{tier}:{view.engine}")
                slots = np.fromiter((slot_of(want[i]) for i in at),
                                    np.int64, at.size)
                status[at] = view.status[slots]
                fp[at] = view.fp[slots]
                sums[at] = view.sums[slots]
            if tier_idx["cold"]:
                eng = self._classify_cold(query, want, tier_idx["cold"],
                                          status, fp, sums)
                engines.append(f"cold:{eng}")
            span.set(engine=" ".join(engines))
        tiers = [self._tier_of[s] for s in want]
        if sids is not None:
            # a targeted query is an access (promotion pressure); a
            # full-population sweep (dashboards, replay) is not
            for sid in want:
                self.touch(sid)
        self._note_occupancy()
        return TieredView(
            sids=want, status=status, fp=fp, sums=sums, tier=tiers,
            local_sum=local_sum, engine=" ".join(engines))

    def _classify_warm(self, query: bc.BloomClock) -> FleetView:
        if self.device.type == "cuda":
            u8 = self._w_u8_t.to(self.device, non_blocking=True)
            base = self._w_base32_t.to(self.device, non_blocking=True)
            self._w_copied = torch.cuda.Event()
            self._w_copied.record()
        else:
            u8, base = self._w_u8_t, self._w_base32_t
        slab = PackedSlab(u8, base, base_host=self._w_base, wide=self._w_wide)
        res = self.engine.classify(query, slab, bn=self.blocks[0],
                                   bm=self.blocks[1]).to_host()
        return view_from_classify(res, self._w_alive, self.cfg.warm_capacity)

    def _classify_cold(self, query, want, at, status, fp, sums) -> str:
        """Chunked classify over decoded cold frames: each chunk builds
        a transient packed slab (near-wrap / i32 frames ride the wide
        overlay, as everywhere else) and runs the same engine call with
        the same pinned blocks."""
        B = self.cfg.cold_batch
        engine = ""
        for lo in range(0, len(at), B):
            chunk = at[lo:lo + B]
            # ragged tails pad to the full chunk shape (zero rows are
            # ignored below), as the reference does
            u8 = np.zeros((B, self.m), np.uint8)
            base = np.zeros(B, np.int64)
            wide: dict[int, np.ndarray] = {}
            for i, j in enumerate(chunk):
                snap = wire.decode_clock(self._read_frame(want[j]))
                cells = np.asarray(snap["cells"])
                if (cells.dtype == np.uint8
                        and not _near_wrap(np.asarray([snap["base"]]))[0]):
                    u8[i] = cells
                    base[i] = snap["base"]
                else:
                    wide[i] = _fold_i32(
                        cells.astype(np.int64) + int(snap["base"]))
            slab = PackedSlab(torch.from_numpy(u8).to(self.device),
                              torch.from_numpy(_fold_i32(base)).to(self.device),
                              base_host=base, wide=wide)
            res = self.engine.classify(query, slab, bn=self.blocks[0],
                                       bm=self.blocks[1]).to_host()
            alive = np.zeros(B, bool)
            alive[:len(chunk)] = True
            view = view_from_classify(res, alive, B)
            engine = view.engine
            n = len(chunk)
            idx = np.asarray(chunk, np.int64)
            status[idx] = view.status[:n]
            fp[idx] = view.fp[:n]
            sums[idx] = view.sums[:n]
        return engine

    def close(self) -> None:
        if self._spill_file is not None:
            self._spill_file.close()
            self._spill_file = None
        if self._own_spill_dir:
            shutil.rmtree(self._spill_dir, ignore_errors=True)
