"""ClockRegistry: a fixed-capacity quantized slab of peer bloom clocks.

Peer state lives in four tensors, the §4 packed layout
(``kernels.pack``):

    cells_u8 [N, m] uint8  window-relative residuals per slot
    base     [N]    int32  per-slot window offset (logical = base + u8)
    sums     [N]    f32    cached total increments (Eq. 3 inputs)
    alive    [N]    bool   liveness mask (evicted slots stay allocated)

A row whose residual span cannot fit a byte, or whose base is near the
int32 wrap, is promoted: its int32 logical cells go to a host side
store (``_wide``) and ``classify_all`` overlays it through the exact
int32 kernel.  Mutations update the slab tensors in place (one indexed
write per batch), which keeps the slab's device memory at one copy.

Slot assignment is host-side (a dict and a free list).  Status codes
(``FleetView.status``): DEAD < 0; ANCESTOR: peer ≼ local; SAME;
DESCENDANT: local ≼ peer; FORKED: concurrent (exact, paper §3).

``on_evict`` hands the live rows an ``evict_many`` frees to a hook as
``EvictedRow`` objects (the tiered store of ``repro_torch.serve``
demotes through it).

**Sharded mode** (``ClockRegistry(..., mesh=make_fleet_mesh(d))``): the
slab is ``d`` row shards (``RowShard``), shard i holding slots
``[i N/d, (i + 1) N/d)`` in its own four tensors on ``mesh.devices[i]``.
One registry in one process drives every shard, as the reference's
single controller does.  Every mutation writes each row to its owning
shard, one indexed write a shard a batch; ``classify_all`` runs the
packed one-vs-many kernel once a shard (the query replicated, blocks
resolved at full N) and ``all_pairs`` the single-device engines on a
replica gathered onto ``mesh.devices[0]``.  Both are bit-identical to
the unsharded slab at every shard count, and results that are not per
shard live on ``mesh.devices[0]`` (``device``).  The host mirrors
(alive, bases, CRCs, promoted rows) keep global slots.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.causal import CausalEngine, CausalPolicy, PackedSlab
from repro_torch.core import clock as bc
from repro_torch.core import wire
from repro_torch.device import indexed_device, resolve_device
from repro_torch.kernels import pack
from repro_torch.obs.observer import resolve
from repro_torch.sharding import FLEET_AXIS, shard_rows, slot_groups, split_rows

__all__ = [
    "ClockRegistry",
    "EvictedRow",
    "FleetView",
    "RowShard",
    "view_from_classify",
    "DEAD",
    "ANCESTOR",
    "SAME",
    "DESCENDANT",
    "FORKED",
    "STATUS_NAMES",
    "NEAR_WRAP_MARGIN",
]

INT32_MAX = np.iinfo(np.int32).max

#: a row whose §4 base lands within this margin of INT32_MAX (or has
#: already wrapped negative) is promoted to the exact int32 rim: the
#: packed path's in-kernel float sums are not wrap-safe.
NEAR_WRAP_MARGIN = 1 << 20


def _near_wrap(base: np.ndarray) -> np.ndarray:
    """Bool mask of §4 bases too close to (or past) the int32 wrap."""
    base = np.asarray(base, np.int64)
    return (base > INT32_MAX - NEAR_WRAP_MARGIN) | (base < 0)


DEAD = -1
ANCESTOR = 0
SAME = 1
DESCENDANT = 2
FORKED = 3

STATUS_NAMES = {
    DEAD: "dead",
    ANCESTOR: "ancestor",
    SAME: "same",
    DESCENDANT: "descendant",
    FORKED: "forked",
}


@dataclasses.dataclass
class EvictedRow:
    """One row captured for an ``on_evict`` hook, in the slab's packed
    representation: u8 residuals + base, plus the promoted int32
    logical row when the slot was wide."""

    cells_u8: np.ndarray      # [m] uint8 residuals
    base: int                 # §4 window offset
    sum: float                # cached clock sum (Eq. 3 input)
    wide: Optional[np.ndarray] = None   # promoted int32 logical row

    def logical(self) -> np.ndarray:
        """Materialized int32 logical cells (mod-2^32 circle)."""
        if self.wide is not None:
            return np.asarray(self.wide, np.int32)
        return (self.cells_u8.astype(np.int64)
                + int(self.base)).astype(np.int32)


@dataclasses.dataclass
class FleetView:
    """Host-side result of one ``classify_all`` call (numpy, [capacity])."""

    status: np.ndarray        # int8 status code per slot
    fp: np.ndarray            # float32 Eq. 3 fp of the claimed direction
    sums: np.ndarray          # float32 clock sums
    alive: np.ndarray         # bool liveness mask
    local_sum: float          # the query clock's total increments
    engine: str = ""          # dispatch label that produced this view

    def slots(self, code: int) -> np.ndarray:
        return np.flatnonzero(self.status == code)

    def counts(self) -> dict[str, int]:
        return {name: int(np.sum(self.status == code))
                for code, name in STATUS_NAMES.items()}

    def confident(self, threshold: float) -> np.ndarray:
        """The uniform Eq. 3 gate over the claimed direction (SAME,
        FORKED and DEAD carry fp 0 and are always confident)."""
        return self.fp <= threshold


def view_from_classify(res, alive: np.ndarray, capacity: int,
                       local_sum: float | None = None) -> FleetView:
    """Fold a host-side ``ClassifyResult`` into a ``FleetView``: the one
    place classify flags become status codes + claimed-direction fp."""
    alive = np.asarray(alive, bool)
    status = np.full(capacity, FORKED, np.int8)
    status[res.after()] = ANCESTOR
    status[res.before()] = DESCENDANT
    status[res.equal()] = SAME
    status[~alive] = DEAD
    fp = np.asarray(res.claimed_fp(), np.float32)
    fp[~alive] = 0.0
    return FleetView(
        status=status,
        fp=fp,
        sums=res.sum_p,
        alive=alive.copy(),
        local_sum=float(res.sum_q) if local_sum is None else local_sum,
        engine=res.engine or "",
    )


def _scatter_rows(cells_u8, base, sums, alive, idx, new_u8, new_base,
                  new_sums) -> None:
    """Write rows ``idx`` of the slab in place."""
    cells_u8[idx] = new_u8
    base[idx] = new_base
    sums[idx] = new_sums
    alive[idx] = True


def _union_gain(cells_u8, base, mask, local_cells) -> torch.Tensor:
    """max over masked logical rows of relu(row - local): the gain of the
    wrap-safe union ``local + relu(row - local)``; max is associative,
    so the gains of row shards combine by another max."""
    logical = cells_u8.to(torch.int32) + base[:, None]
    gain = torch.where(mask[:, None], torch.clamp(logical - local_cells, min=0),
                       0)
    return gain.amax(0)


def _broadcast_rows(cells_u8, base, sums, mask, row_u8, row_base,
                    row_sum) -> None:
    """Write one packed row into every masked slot, in place."""
    cells_u8[mask] = row_u8
    base[mask] = row_base
    sums[mask] = row_sum


@dataclasses.dataclass
class RowShard:
    """One row shard of the slab: its four tensors on its device."""

    cells_u8: torch.Tensor    # [rows, m] uint8
    base: torch.Tensor        # [rows] int32
    sums: torch.Tensor        # [rows] float32
    alive: torch.Tensor       # [rows] bool

    @classmethod
    def zeros(cls, rows: int, m: int, device) -> "RowShard":
        return cls(
            cells_u8=torch.zeros((rows, m), dtype=torch.uint8, device=device),
            base=torch.zeros((rows,), dtype=torch.int32, device=device),
            sums=torch.zeros((rows,), dtype=torch.float32, device=device),
            alive=torch.zeros((rows,), dtype=torch.bool, device=device))

    @property
    def device(self) -> torch.device:
        return self.cells_u8.device


def _take(x: torch.Tensor, pos, device) -> torch.Tensor:
    """Rows ``pos`` of ``x`` (all of them for None), on ``device``."""
    if pos is not None:
        x = x.index_select(0, torch.as_tensor(pos, device=x.device))
    return x.to(device, non_blocking=True)


class ClockRegistry:
    """Peer clock registry: one slab on one device, or row shards over
    a ``launch.mesh.FleetMesh``."""

    def __init__(self, capacity: int, m: int, k: int = 4, *, mesh=None,
                 axis: str = FLEET_AXIS, policy: CausalPolicy | None = None,
                 device=None):
        self.capacity = capacity
        self.m = m
        self.k = k
        # the mesh and axis fold into the policy (explicit arguments win),
        # and every comparison goes through the resulting engine
        base_policy = policy if policy is not None else CausalPolicy()
        if mesh is None:
            mesh = base_policy.mesh
            if mesh is not None and axis == FLEET_AXIS:
                axis = base_policy.axis
        self.policy = (base_policy
                       if (base_policy.mesh, base_policy.axis) == (mesh, axis)
                       else dataclasses.replace(base_policy, mesh=mesh,
                                                axis=axis))
        self.engine = CausalEngine(self.policy)
        self.obs = resolve(self.policy.observer)
        self.mesh = mesh
        self.axis = axis if mesh is not None else None
        if mesh is None:
            self.device = resolve_device(device)
            devices = (self.device,)
        else:
            shards = mesh.shape[axis]
            if capacity % shards:
                raise ValueError(
                    f"capacity {capacity} not divisible by mesh axis "
                    f"{axis!r} extent {shards}")
            devices = tuple(mesh.devices)
            self.device = devices[0]
            if (device is not None
                    and indexed_device(device) != self.device):
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {self.device}")
        self._rows = capacity // len(devices)
        self.shards = [RowShard.zeros(self._rows, m, d) for d in devices]
        self._alive_host = np.zeros(capacity, bool)
        self._base_host = np.zeros(capacity, np.int64)
        # per-slot CRC32 of the logical cells, written at every mutation:
        # the ground truth check_integrity() verifies the slab against
        self._crc_host = np.zeros(capacity, np.int64)
        self._wide: dict[int, np.ndarray] = {}   # promoted int32 rows
        self._mat: torch.Tensor | None = None    # materialized i32 cache
        self._slot_of: dict = {}
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        #: demotion hook: called as ``on_evict({peer_id: EvictedRow})``
        #: with every ALIVE row an ``evict_many`` frees; quarantined
        #: rows are never handed out
        self.on_evict: Optional[Callable[[dict], None]] = None

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def _whole(self, name: str) -> torch.Tensor:
        parts = [getattr(sh, name) for sh in self.shards]
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.device, non_blocking=True) for p in parts])

    # the slab's tensors: on one device the registry's own, which it
    # writes in place; on a mesh a copy on ``device``, gathered in slot
    # order (mutate through the registry's methods)
    @property
    def cells_u8(self) -> torch.Tensor:
        return self._whole("cells_u8")

    @property
    def base(self) -> torch.Tensor:
        return self._whole("base")

    @property
    def sums(self) -> torch.Tensor:
        return self._whole("sums")

    @property
    def alive(self) -> torch.Tensor:
        return self._whole("alive")

    def _groups(self, slots) -> list:
        """``(shard, local rows on its device, positions in the batch)``
        for each shard ``slots`` touch (positions None: the whole batch),
        so each shard takes one indexed write."""
        if self.mesh is None:
            sh = self.shards[0]
            return [(sh, torch.as_tensor(slots, device=sh.device), None)]
        return [(self.shards[i], torch.as_tensor(local, device=self.shards[i].device),
                 pos) for i, local, pos in slot_groups(slots, self._rows)]

    def _rows_of(self, slots, *names: str) -> list:
        """Rows ``slots`` of the named slab tensors, in that order, on
        ``device``: one gather a shard."""
        if self.mesh is None:
            j = torch.as_tensor(slots, device=self.device)
            return [getattr(self.shards[0], n).index_select(0, j) for n in names]
        out = []
        for n in names:
            t = getattr(self.shards[0], n)
            out.append(torch.empty((len(slots),) + tuple(t.shape[1:]),
                                   dtype=t.dtype, device=self.device))
        for sh, local, pos in self._groups(slots):
            at = torch.as_tensor(pos, device=self.device)
            for o, n in zip(out, names):
                o[at] = getattr(sh, n).index_select(0, local).to(
                    self.device, non_blocking=True)
        return out

    def _shard_masks(self, mask_h: np.ndarray):
        """(shard, its slice of the host mask) for each shard with a set
        slot."""
        for i, sh in enumerate(self.shards):
            part = mask_h[i * self._rows:(i + 1) * self._rows]
            if part.any():
                yield sh, part

    def _load(self, cells_u8: np.ndarray, base: np.ndarray, sums: np.ndarray,
              alive: np.ndarray) -> None:
        """Replace every slab tensor by host arrays in slot order."""
        devices = [sh.device for sh in self.shards]
        for name, x in (("cells_u8", cells_u8), ("base", base),
                        ("sums", sums), ("alive", alive)):
            for sh, part in zip(self.shards,
                                split_rows(torch.from_numpy(np.array(x)),
                                           devices)):
                setattr(sh, name, part)
        self._mat = None

    # ---- membership ----
    def __len__(self) -> int:
        return len(self._slot_of)

    def __contains__(self, peer_id) -> bool:
        return peer_id in self._slot_of

    def slot_of(self, peer_id) -> int:
        return self._slot_of[peer_id]

    def peer_ids(self) -> list:
        return list(self._slot_of)

    def row_alive(self, peer_id) -> bool:
        """True when the peer's row is present AND not quarantined."""
        slot = self._slot_of.get(peer_id)
        return slot is not None and bool(self._alive_host[slot])

    @property
    def packed(self) -> bool:
        """True when every row is in the u8 fast-path representation."""
        return not self._wide

    @property
    def cells(self) -> torch.Tensor:
        """Materialized int32 logical cells [capacity, m] on ``device``
        (debug view; on a mesh the shards unpacked in slot order)."""
        return self._materialized()

    def _materialized(self) -> torch.Tensor:
        if self._mat is None:
            mat = pack.unpack_rows(self.cells_u8, self.base)
            if self._wide:
                widx = sorted(self._wide)
                mat[torch.as_tensor(widx, device=self.device)] = torch.as_tensor(
                    np.stack([self._wide[s] for s in widx]), device=self.device)
            self._mat = mat
        return self._mat

    def _slab(self) -> PackedSlab:
        if self.mesh is None:
            sh = self.shards[0]
            return PackedSlab(sh.cells_u8, sh.base, base_host=self._base_host,
                              wide=self._wide)
        return PackedSlab(tuple(sh.cells_u8 for sh in self.shards),
                          tuple(sh.base for sh in self.shards),
                          base_host=self._base_host, wide=self._wide,
                          mesh=self.mesh)

    # ---- batched mutation ----
    def admit_many(self, peers: dict) -> dict:
        """Admit {peer_id: BloomClock}; one scatter for the whole batch.
        Re-admitting a known peer overwrites its row.  Returns
        {peer_id: slot}; raises when capacity is exhausted."""
        if not peers:
            return {}
        fresh = [pid for pid in peers if pid not in self._slot_of]
        if len(fresh) > len(self._free):
            raise RuntimeError(
                f"registry full: {len(fresh)} admits, {len(self._free)} free slots")
        with self.obs.trace.span("registry.admit", n=len(peers),
                                 fresh=len(fresh)):
            slots = {pid: (self._slot_of[pid] if pid in self._slot_of
                           else self._free.pop()) for pid in peers}
            self._slot_of.update(slots)
            self._write(list(slots.values()), list(peers.values()))
        self.obs.metrics.counter("registry_admits").inc(len(peers))
        self._note_occupancy()
        return slots

    def admit(self, peer_id, clock: bc.BloomClock) -> int:
        return self.admit_many({peer_id: clock})[peer_id]

    def update_many(self, peers: dict) -> None:
        """Overwrite existing peers' rows; one scatter for the batch."""
        if not peers:
            return
        with self.obs.trace.span("registry.update", n=len(peers)):
            self._write([self._slot_of[pid] for pid in peers],
                        list(peers.values()))

    def update(self, peer_id, clock: bc.BloomClock) -> None:
        self.update_many({peer_id: clock})

    def evict_many(self, peer_ids) -> None:
        peer_ids = list(dict.fromkeys(peer_ids))   # dedupe, keep order
        # resolve every slot BEFORE mutating: an unknown peer_id raises
        # with the registry untouched instead of half-evicted
        idx = [self._slot_of[pid] for pid in peer_ids]
        if not idx:
            return
        captured = self._capture_rows(peer_ids, idx)
        with self.obs.trace.span("registry.evict", n=len(idx)):
            for pid in peer_ids:
                del self._slot_of[pid]
            for sh, local, _ in self._groups(idx):
                sh.alive[local] = False
            self._alive_host[idx] = False
            for slot in idx:
                self._wide.pop(slot, None)
            self._free.extend(idx)
        self.obs.metrics.counter("registry_evictions").inc(len(idx))
        self._note_occupancy()
        if captured:
            self.on_evict(captured)

    def _capture_rows(self, peer_ids: list, idx: list) -> Optional[dict]:
        """Snapshot the alive rows an eviction is about to free, packed:
        one gather of the victims' u8 rows and sums, one transfer."""
        if self.on_evict is None:
            return None
        live = [(pid, slot) for pid, slot in zip(peer_ids, idx)
                if self._alive_host[slot]]
        if not live:
            return None
        u8, sums = self._rows_of([slot for _, slot in live], "cells_u8",
                                 "sums")
        rows = torch.cat([u8, sums.view(torch.uint8).reshape(len(live), 4)], 1)
        rows = rows.cpu().numpy()
        u8, sums = rows[:, :self.m], rows[:, self.m:].copy().view(np.float32)
        return {
            pid: EvictedRow(
                cells_u8=u8[pos].copy(),
                base=int(self._base_host[slot]),
                sum=float(sums[pos, 0]),
                wide=(None if slot not in self._wide
                      else self._wide[slot].copy()))
            for pos, (pid, slot) in enumerate(live)
        }

    def evict(self, peer_id) -> None:
        self.evict_many([peer_id])

    def _write(self, idx: list, clocks: list) -> None:
        # logical rows on the host with the mod-2^32 fold (clocks may
        # live on either device), then one transfer and one scatter
        logical_h = np.empty((len(clocks), self.m), np.int32)
        for pos, c in enumerate(clocks):
            cells = c.cells.cpu().numpy().astype(np.int64)
            logical_h[pos] = ((cells + int(c.base)) & 0xFFFFFFFF).astype(
                np.uint32).view(np.int32)
        logical = torch.as_tensor(logical_h, device=self.device)
        new_sums = bc.clock_sum(bc.BloomClock(
            cells=logical, base=torch.zeros(len(clocks), dtype=torch.int32,
                                            device=self.device),
            k=clocks[0].k))
        new_u8, new_base, ok = pack.pack_rows(logical)
        for sh, local, pos in self._groups(idx):
            dev = sh.device
            _scatter_rows(sh.cells_u8, sh.base, sh.sums, sh.alive, local,
                          _take(new_u8, pos, dev), _take(new_base, pos, dev),
                          _take(new_sums, pos, dev))
        ok_h = ok.cpu().numpy()
        base_h = new_base.cpu().numpy()
        nw_h = _near_wrap(base_h)
        self._base_host[idx] = base_h
        self._alive_host[idx] = True
        promoted = demoted = 0
        for pos, slot in enumerate(idx):
            self._crc_host[slot] = wire.cells_crc(logical_h[pos])
            if ok_h[pos] and not nw_h[pos]:
                if self._wide.pop(slot, None) is not None:
                    demoted += 1               # demotion: row packs again
            else:                  # promotion: span > U8_MAX or near-wrap
                if slot not in self._wide:
                    promoted += 1
                self._wide[slot] = logical_h[pos].copy()
        if promoted:
            self.obs.metrics.counter("registry_promotions").inc(promoted)
        if demoted:
            self.obs.metrics.counter("registry_demotions").inc(demoted)
        self._mat = None

    def _note_occupancy(self) -> None:
        obs = self.obs
        if obs:
            obs.metrics.gauge("registry_occupancy").set(len(self._slot_of))
            obs.metrics.gauge("registry_wide_rows").set(len(self._wide))

    # ---- self-stabilization: row integrity ----
    def check_integrity(self) -> list:
        """Peer ids whose alive row no longer hashes to the CRC recorded
        when it was written (detection only; see ``quarantine_rows``)."""
        mat = self._materialized().cpu().numpy()
        bad = []
        for pid, slot in self._slot_of.items():
            if not self._alive_host[slot]:
                continue
            if wire.cells_crc(mat[slot]) != int(self._crc_host[slot]):
                bad.append(pid)
        if bad:
            self.obs.metrics.counter("registry_corrupt_rows").inc(len(bad))
        return bad

    def quarantine_rows(self, peer_ids) -> None:
        """Mark corrupted rows dead WITHOUT freeing their slots; a later
        ``update_many`` rewrites the row and revives it."""
        idx = [self._slot_of[pid] for pid in peer_ids]
        if not idx:
            return
        for sh, local, _ in self._groups(idx):
            sh.alive[local] = False
        self._alive_host[idx] = False
        self._mat = None

    def get(self, peer_id) -> bc.BloomClock:
        slot = self._slot_of[peer_id]
        if slot in self._wide:
            return bc.BloomClock(
                cells=torch.as_tensor(self._wide[slot], device=self.device),
                base=torch.zeros((), dtype=torch.int32, device=self.device),
                k=self.k)
        shard, row = shard_rows(slot, self._rows)
        sh = self.shards[shard]
        return bc.BloomClock(
            cells=sh.cells_u8[row].to(torch.int32).to(self.device),
            base=sh.base[row].clone().to(self.device), k=self.k)

    # ---- batched classification ----
    def classify_all(self, local: bc.BloomClock) -> FleetView:
        """Lineage status + Eq. 3 fp for EVERY slot: one packed
        one-vs-many kernel call (one a row shard on a mesh), plus one
        int32 call for promoted rows.

        A peer ≼ the local clock is an ANCESTOR, a peer the local clock
        is ≼ is a DESCENDANT, incomparable peers are FORKED (exact, §3).
        """
        res = self.engine.classify(local, self._slab()).to_host()
        return view_from_classify(res, self._alive_host, self.capacity)

    def all_pairs(self, **kw):
        """Tiled all-pairs compare -> ``causal.ComparisonMatrix``; dead
        slots report all-False flags and ``fp = row_sums = 0``.

        One ``engine.pairs`` call over the packed slab: dead slots are
        compacted away (they cost no compute) and promoted rows are
        patched in through the exact int32 rim; a sharded slab runs the
        same on a replica gathered onto ``device``, masking dead slots
        with the registry's own ``alive`` on ``device`` (no upload).
        ``**kw`` carries per-call dispatch overrides (engine, block
        shapes, interpret).
        """
        return self.engine.pairs(self._slab(), alive=self._alive_host,
                                 alive_dev=self.alive, **kw)

    # ---- batched merge ----
    def union(self, mask: np.ndarray, local: bc.BloomClock) -> bc.BloomClock:
        """Merge the local clock with every masked row (wrap-safe max).
        With promoted rows present, only the masked rows are gathered."""
        local_cells = local.logical_cells().to(torch.int32).to(self.device)
        mask_h = np.asarray(mask, bool)
        midx = np.flatnonzero(mask_h)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if midx.size == 0:
            return bc.BloomClock(cells=local_cells, base=zero, k=self.k)
        if self.packed:
            gains = [_union_gain(sh.cells_u8, sh.base,
                                 torch.as_tensor(part, device=sh.device),
                                 local_cells.to(sh.device, non_blocking=True))
                     .to(self.device, non_blocking=True)
                     for sh, part in self._shard_masks(mask_h)]
            gain = gains[0]
            for g in gains[1:]:
                gain = torch.maximum(gain, g)
            merged = local_cells + gain
        else:
            rows = pack.unpack_rows(*self._rows_of(midx, "cells_u8", "base"))
            wsel = [(pos, int(s)) for pos, s in enumerate(midx)
                    if int(s) in self._wide]
            if wsel:
                rows[torch.as_tensor([p for p, _ in wsel],
                                     device=self.device)] = torch.as_tensor(
                    np.stack([self._wide[s] for _, s in wsel]),
                    device=self.device)
            merged = local_cells + torch.clamp(
                (rows - local_cells).amax(0), min=0)
        return bc.BloomClock(cells=merged, base=zero, k=self.k)

    def broadcast(self, mask: np.ndarray, clock: bc.BloomClock) -> bool:
        """Write one clock into every masked row (anti-entropy push-back)
        as u8 residuals + one base; a row too wide for u8 promotes the
        masked slots instead.  Returns whether the row went out packed."""
        logical = clock.logical_cells().to(torch.int32).to(self.device)
        row_u8, row_base, ok = pack.pack_rows(logical[None])
        row_sum = bc.clock_sum(bc.BloomClock(
            cells=clock.cells.to(self.device), base=clock.base.to(self.device),
            k=clock.k))
        mask_h = np.asarray(mask, bool)
        for sh, part in self._shard_masks(mask_h):
            dev = sh.device
            _broadcast_rows(sh.cells_u8, sh.base, sh.sums,
                            torch.as_tensor(part, device=dev),
                            row_u8[0].to(dev), row_base[0].to(dev),
                            row_sum.to(dev))
        midx = np.flatnonzero(mask_h)
        base0 = int(row_base[0])
        self._base_host[midx] = base0
        row_np = logical.cpu().numpy()
        self._crc_host[midx] = wire.cells_crc(row_np)
        # a union row pushed back near the int32 wrap stays on the rim
        packed_ok = bool(ok[0]) and not bool(_near_wrap(np.asarray([base0]))[0])
        if packed_ok:
            for slot in midx:
                self._wide.pop(int(slot), None)
        else:
            for slot in midx:
                self._wide[int(slot)] = row_np
        self._mat = None
        return packed_ok
