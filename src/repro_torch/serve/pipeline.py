"""Streaming admission pipeline: continuous-batching causality-as-a-service.

Admission runs as a stream:

  - any number of host feeder threads ``submit()`` clock updates and
    queries into one bounded queue and get a ticket to wait on;
  - one worker drains the queue into batches and keeps TWO batches in
    flight: while the card classifies batch *t*, the worker stages
    batch *t+1* on the host (frame decode, digest-cache probe, packed
    rows) and only then waits for *t*;
  - a digest cache keyed on the §4 wire-cell CRC (``core.wire``) skips
    re-classifying sessions whose cells, and the local clock, are
    unchanged since their last verdict.  An entry is valid only while
    the LOCAL clock's CRC still matches the one stored with it, so any
    local merge or tick flushes the cache (fp depends on both sums).

The double buffer is explicit.  Each batch takes one of two staging
slots: ``_stage`` writes the batch's u8 rows and int32 bases into the
slot's host buffers (pinned when the registry is on the card), copies
them to the card without blocking, gathers the rows of queried hot
sessions from the hot slab on the card, enqueues ``engine.classify``,
copies the flags, fp and sums into the slot's pinned result buffers
without blocking and records one CUDA event.  ``_finalize`` waits on
that event and on nothing else.  Batch *t+2* reuses batch *t*'s slot
after *t*'s event.  Everything runs on the worker's current stream, so
a hot row gathered for batch *t+1* is read before batch *t*'s admits
are scattered into the slab: queries staged in *t+1* see the stored
clocks as they were before *t*'s admits land, as in the reference.
The host waits for the card between two such points only where a
queried session's access promotes it (the hot registry's write).

Verdicts come from the same ``CausalEngine`` call, over the same packed
layout, with the same pinned kernel blocks as the tiered registry
(``serve.tiers``), and every acted-on admission verdict is audited like
a gossip verdict (CRC pair, claimed-direction Eq. 3 fp, threshold,
engine, wire frames), so ``AuditTrail.replay_frames`` re-derives a
serve run bit for bit.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from array import array
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.causal import ClassifyResult, PackedSlab
from repro_torch.core import clock as bc
from repro_torch.core import wire
from repro_torch.fleet.registry import _near_wrap
from repro_torch.kernels import ops
from repro_torch.serve.tiers import TieredRegistry, _fold_i32, host_buffer

__all__ = ["PipelineConfig", "AdmissionVerdict", "AdmissionTicket",
           "AdmissionPipeline"]

#: admission-latency histogram bin edges (milliseconds)
LATENCY_MS_EDGES = (0.5, 1, 2, 5, 10, 20, 50, 100, 250, 1000)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    batch_size: int = 256         # sessions classified per card call
    queue_depth: int = 2048       # bounded feeder queue (backpressure)
    max_wait_s: float = 0.005     # batch fill window before dispatch
    digest_cache: bool = True
    cache_capacity: int = 65536   # LRU digest-cache entries


@dataclasses.dataclass
class AdmissionVerdict:
    """What one request resolved to."""

    sid: str
    kind: str                 # "admit" | "query"
    verdict: str              # STATUS_NAMES string ("unknown" if absent)
    fp: float                 # claimed-direction Eq. 3 fp
    admitted: bool            # admit requests: did it pass the gate
    cached: bool              # served from the digest cache
    engine: str
    latency_s: float


class AdmissionTicket:
    """Feeder-side handle: ``result()`` blocks until the verdict lands."""

    __slots__ = ("_event", "_verdict")

    def __init__(self):
        self._event = threading.Event()
        self._verdict: Optional[AdmissionVerdict] = None

    def _resolve(self, verdict: AdmissionVerdict) -> None:
        self._verdict = verdict
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> AdmissionVerdict:
        if not self._event.wait(timeout):
            raise TimeoutError("admission verdict not ready")
        return self._verdict


@dataclasses.dataclass
class _Request:
    kind: str
    sid: str
    frame: Optional[bytes]    # encoded clock (admits)
    t_submit: float
    ticket: AdmissionTicket


class _Slot:
    """One staging slot of the double buffer: host rows, their card
    copies, and the host buffers the results come back to."""

    def __init__(self, n: int, m: int, device: torch.device):
        pinned = device.type == "cuda"
        self.u8 = host_buffer((n, m), torch.uint8, pinned)
        self.base = host_buffer((n,), torch.int32, pinned)
        self.wide_at = host_buffer((n,), torch.int64, pinned)
        self.wide = host_buffer((n, m), torch.int32, pinned)
        self.flags = host_buffer((n, 2), torch.bool, pinned)
        self.vals = host_buffer((n, 3), torch.float32, pinned)
        self.d_u8 = torch.empty((n, m), dtype=torch.uint8, device=device)
        self.d_base = torch.empty((n,), dtype=torch.int32, device=device)
        self.done: Optional[torch.cuda.Event] = None

    def fence(self) -> None:
        """Wait until the card is done with this slot's last batch."""
        if self.done is not None:
            self.done.synchronize()
            self.done = None


@dataclasses.dataclass
class _Staged:
    """One in-flight batch: the card's work and the host leftovers."""

    reqs: list                # cache-miss requests, row-aligned
    rows: list                # host (cells, base) per request
    admits: list              # (decoded frame, peer CRC) per admit row
    slot: Optional[_Slot]     # the staging slot holding its results
    engine: str
    hits: list                # (request, cached-entry, frame) cache hits
    unknown: list             # query requests for absent sids
    local: bc.BloomClock
    local_crc: int
    local_sum: float


class AdmissionPipeline:
    """Bounded-queue streaming admission over a ``TieredRegistry``.

    ``local_source`` is a zero-arg callable returning the CURRENT local
    (replica) clock; it is read once per staged batch, so feeders may
    tick it between batches (each batch's verdicts are consistent with
    one local snapshot, and the audit frames pin which one).  A new
    clock object is a new snapshot: the host copy of its cells is taken
    once per object.
    """

    def __init__(self, tiers: TieredRegistry,
                 local_source, cfg: PipelineConfig = PipelineConfig()):
        self.tiers = tiers
        self.cfg = cfg
        self.local_source = local_source
        self.engine = tiers.engine          # pinned blocks ride the policy
        self.policy = tiers.policy
        self.obs = tiers.obs
        self.device = tiers.device
        self.threshold = float(self.policy.fp_threshold)
        self._queue: queue.Queue = queue.Queue(maxsize=cfg.queue_depth)
        self._cache: OrderedDict = OrderedDict()  # peer_crc -> entry
        self._local_frames: dict[int, bytes] = {}
        self._local_key = None              # (clock, host cells, crc, sum)
        self._slots = [_Slot(cfg.batch_size, tiers.m, self.device)
                       for _ in range(2)]
        self._staged = 0
        self._pending = 0
        self._pending_lock = threading.Condition()
        self._closed = False
        self._error: Optional[BaseException] = None
        self.latencies = array("d")         # per-request submit->verdict s
        self.n_admitted = 0
        self.n_rejected = 0
        self.n_queries = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.batches = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="admission-pipeline")
        self._worker.start()

    # ---- feeder side ----
    def submit(self, sid: str, clock: bc.BloomClock | None = None,
               frame: bytes | None = None,
               kind: str = "admit") -> AdmissionTicket:
        """Enqueue one request (thread-safe; blocks when the queue is
        full: bounded-queue backpressure).  ``admit`` needs a clock or
        an encoded wire frame; ``query`` classifies the session's
        STORED clock against the local one."""
        if self._closed:
            raise RuntimeError("pipeline is closed")
        if kind == "admit" and frame is None:
            if clock is None:
                raise ValueError("admit needs a clock or a frame")
            frame = wire.encode_clock(bc.to_wire(clock))
        ticket = AdmissionTicket()
        with self._pending_lock:
            self._pending += 1
        self._queue.put(_Request(kind=kind, sid=str(sid), frame=frame,
                                 t_submit=time.perf_counter(),
                                 ticket=ticket))
        return ticket

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted request has resolved."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._pending_lock:
            while self._pending > 0:
                if self._error is not None:
                    raise RuntimeError(
                        "admission worker died") from self._error
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                if not self._pending_lock.wait(timeout=remaining):
                    raise TimeoutError(
                        f"{self._pending} requests still in flight")
            if self._error is not None:
                raise RuntimeError(
                    "admission worker died") from self._error

    def close(self) -> None:
        """Drain and stop the worker (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._worker.join(timeout=60.0)

    # ---- worker side ----
    def _run(self) -> None:
        inflight: Optional[_Staged] = None
        try:
            while True:
                reqs = self._collect()
                staged = self._stage(reqs) if reqs else None
                if inflight is not None:
                    # finalize batch t AFTER enqueueing t+1: the card is
                    # already computing t+1 while the host applies t
                    self._finalize(inflight)
                inflight = staged
                if (inflight is None and self._closed
                        and self._queue.empty()):
                    break
        except BaseException as e:   # surface in drain(), don't hang it
            self._error = e
            with self._pending_lock:
                self._pending_lock.notify_all()

    def _collect(self) -> list:
        """Up to ``batch_size`` requests, waiting at most ``max_wait_s``
        past the first one."""
        try:
            first = self._queue.get(timeout=0.02)
        except queue.Empty:
            return []
        reqs = [first]
        deadline = time.perf_counter() + self.cfg.max_wait_s
        while len(reqs) < self.cfg.batch_size:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                reqs.append(self._queue.get(timeout=left))
            except queue.Empty:
                break
        return reqs

    def _local_snapshot(self, local: bc.BloomClock):
        """(host int32 cells, CRC, clock sum) of the local clock, read
        from the card once per clock object."""
        key = self._local_key
        if key is None or key[0] is not local:
            cells = local.logical_cells().to(torch.int32).cpu().numpy()
            key = (local, cells, wire.cells_crc(cells),
                   float(bc.clock_sum(local)))
            self._local_key = key
        return key[1:]

    def _gather_hot(self, pending: list, parts: list) -> None:
        """Enqueue the gather of the hot rows ``pending`` ((row, slot)
        pairs) from the slab, as it stands now, into ``parts``."""
        if not pending:
            return
        idx = torch.tensor(pending, dtype=torch.int64).T.contiguous()
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        reg = self.tiers.hot
        parts.append((idx[0], reg.cells_u8.index_select(0, idx[1]),
                      reg.base.index_select(0, idx[1])))
        pending.clear()

    def _stage(self, reqs: list) -> _Staged:
        """Host staging + enqueued card work for one batch."""
        with self.obs.trace.span("pipeline.stage", n=len(reqs)):
            return self._stage_batch(reqs)

    def _stage_batch(self, reqs: list) -> _Staged:
        local = self.local_source()
        _, local_crc, local_sum = self._local_snapshot(local)
        hits, misses, rows, admits, unknown = [], [], [], [], []
        pending, parts = [], []
        for req in reqs:
            if req.kind == "query":
                if req.sid not in self.tiers:
                    unknown.append(req)
                    continue
                # the query's access may promote a warm or cold session,
                # rewriting hot slots: rows noted so far are gathered
                # first, so each query reads its stored clock as of now
                if self.tiers.tier_of(req.sid) != "hot":
                    self._gather_hot(pending, parts)
                self.tiers.touch(req.sid)
                cells, slot = self.tiers.stored_row(req.sid)
                if cells is None:     # packed hot row: stays on the card
                    pending.append((len(rows), slot))
                misses.append(req)
                rows.append((cells, 0))
                admits.append(None)
                continue
            snap = wire.decode_clock(req.frame)
            cells, base = snap["cells"], snap["base"]
            peer_crc = wire.cells_crc(cells, base)
            entry = None
            if self.cfg.digest_cache:
                entry = self._cache_probe(peer_crc, local_crc)
            if entry is not None:
                hits.append((req, entry, snap))
            else:
                misses.append(req)
                rows.append((cells, base))
                admits.append((snap, peer_crc))
        self._gather_hot(pending, parts)
        slot, engine = None, ""
        if misses:
            slot = self._slots[self._staged % 2]
            self._staged += 1
            engine = self._enqueue(slot, local, rows, parts)
        return _Staged(reqs=misses, rows=rows, admits=admits, slot=slot,
                       engine=engine, hits=hits, unknown=unknown,
                       local=local, local_crc=local_crc, local_sum=local_sum)

    def _enqueue(self, slot: _Slot, local: bc.BloomClock, rows: list,
                 hot_parts: list) -> str:
        """Fill ``slot`` with the batch's host rows, patch in the hot
        rows gathered on the card, and enqueue the classify and the
        copies of its results; returns the engine label."""
        slot.fence()
        u8, base_v = slot.u8.numpy(), slot.base.numpy()
        wide_at, wide = slot.wide_at.numpy(), slot.wide.numpy()
        # rows past the batch are all-zero u8 (one kernel shape for the
        # whole stream); their verdicts are computed and ignored
        u8[:] = 0
        base_v[:] = 0
        nw = 0
        for i, (cells, base) in enumerate(rows):
            if cells is None:
                continue
            if (cells.dtype == np.uint8
                    and not _near_wrap(np.asarray([base]))[0]):
                u8[i] = cells
                base_v[i] = _fold_i32([base])[0]
                continue
            # int32 frame: min-lift into the u8+base layout when the
            # span allows (same split rule as kernels/pack); the exact
            # int32 overlay is for genuine rim rows only
            logical = cells.astype(np.int64) + base
            mn = int(logical.min())
            if (0 <= mn and int(logical.max()) - mn <= 255
                    and not _near_wrap(np.asarray([mn]))[0]):
                u8[i] = (logical - mn).astype(np.uint8)
                base_v[i] = _fold_i32([mn])[0]
            else:
                wide_at[nw] = i
                wide[nw] = _fold_i32(logical)
                nw += 1
        dev = self.device
        slot.d_u8.copy_(slot.u8, non_blocking=True)
        slot.d_base.copy_(slot.base, non_blocking=True)
        for at, rows_u8, rows_base in hot_parts:
            slot.d_u8.index_copy_(0, at, rows_u8)
            slot.d_base.index_copy_(0, at, rows_base)
        q = local.logical_cells().to(torch.int32).to(dev)
        res = self.engine.classify(q, PackedSlab(slot.d_u8, slot.d_base))
        out = {key: getattr(res, key) for key in ClassifyResult._FIELDS}
        engine = res.engine or ""
        if nw:
            out = ops._overlay_wide_classify(
                out, q, slot.wide_at[:nw].to(dev, non_blocking=True),
                slot.wide[:nw].to(dev, non_blocking=True))
            engine += "+wide_overlay"
        slot.flags.copy_(torch.stack([out["q_le_p"], out["p_le_q"]], 1),
                         non_blocking=True)
        slot.vals.copy_(torch.stack([out["fp_q_before_p"],
                                     out["fp_p_before_q"], out["sum_p"]], 1),
                        non_blocking=True)
        if dev.type == "cuda":
            slot.done = torch.cuda.Event()
            slot.done.record()
        return engine

    def _cache_probe(self, peer_crc: int, local_crc: int):
        entry = self._cache.get(peer_crc)
        if entry is None or entry["local_crc"] != local_crc:
            return None
        self._cache.move_to_end(peer_crc)
        return entry

    def _cache_store(self, peer_crc: int, local_crc: int, verdict: str,
                     fp: float, admitted: bool, engine: str) -> None:
        self._cache[peer_crc] = {
            "local_crc": local_crc, "verdict": verdict, "fp": fp,
            "admitted": admitted, "engine": engine, "peer_crc": peer_crc}
        self._cache.move_to_end(peer_crc)
        while len(self._cache) > self.cfg.cache_capacity:
            self._cache.popitem(last=False)

    def _finalize(self, staged: _Staged) -> None:
        """Wait for batch t's results, then apply, audit and resolve."""
        with self.obs.trace.span("pipeline.finalize", n=len(staged.reqs)):
            self._finalize_batch(staged)

    def _finalize_batch(self, staged: _Staged) -> None:
        obs = self.obs
        now = time.perf_counter
        to_admit: dict = {}
        resolved: list = []   # tickets resolve only AFTER tiers apply,
        # so drain() implies every admitted clock is queryable
        if staged.slot is not None:
            slot = staged.slot
            slot.fence()
            n = len(staged.reqs)
            flags = slot.flags.numpy()[:n]
            vals = slot.vals.numpy()[:n]
            res = ClassifyResult(
                q_le_p=flags[:, 0], p_le_q=flags[:, 1],
                sum_q=np.float32(staged.local_sum), sum_p=vals[:, 2],
                fp_q_before_p=vals[:, 0], fp_p_before_q=vals[:, 1])
            after = np.asarray(res.after(), bool)
            equal = np.asarray(res.equal(), bool)
            before = np.asarray(res.before(), bool)
            claimed = np.asarray(res.claimed_fp(), np.float32)
            gate_fp = np.asarray(res.fp_after(), np.float32)
            engine = staged.engine
            for i, req in enumerate(staged.reqs):
                verdict = ("same" if equal[i]
                           else "ancestor" if after[i]
                           else "descendant" if before[i]
                           else "forked")
                fp = float(claimed[i])
                if req.kind == "admit":
                    ok = bool(after[i]) and float(gate_fp[i]) <= self.threshold
                    snap, peer_crc = staged.admits[i]
                    if self.cfg.digest_cache:
                        self._cache_store(peer_crc, staged.local_crc,
                                          verdict, fp, ok, engine)
                    if ok:
                        to_admit[req.sid] = bc.from_wire(snap)
                    self._audit(req, snap, staged, verdict, fp, ok, engine,
                                peer_crc)
                    self._count_admit(ok)
                else:
                    self.n_queries += 1
                resolved.append((req, verdict, fp,
                                 req.sid in to_admit, False, engine))
        for req, entry, snap in staged.hits:
            verdict, fp = entry["verdict"], entry["fp"]
            ok = entry["admitted"]
            if ok:
                to_admit[req.sid] = bc.from_wire(snap)
            self._audit(req, snap, staged, verdict, fp, ok,
                        "digest_cache", entry["peer_crc"])
            self._count_admit(ok, cached=True)
            resolved.append((req, verdict, fp, ok, True, "digest_cache"))
        for req in staged.unknown:
            self.n_queries += 1
            resolved.append((req, "unknown", 0.0, False, False, ""))
        if to_admit:
            self.tiers.admit_many(to_admit)
        for req, verdict, fp, ok, cached, engine in resolved:
            self._resolve(req, verdict, fp, admitted=ok, cached=cached,
                          engine=engine, now=now())
        self.batches += 1
        if obs:
            obs.metrics.gauge("pipeline_queue_depth").set(
                self._queue.qsize())

    def _count_admit(self, ok: bool, cached: bool = False) -> None:
        if ok:
            self.n_admitted += 1
        else:
            self.n_rejected += 1
        if cached:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        if self.obs:
            self.obs.metrics.counter(
                "pipeline_admissions",
                outcome="adopted" if ok else "rejected").inc()
            self.obs.metrics.counter(
                "digest_cache",
                outcome="hit" if cached else "miss").inc()

    def _resolve(self, req: _Request, verdict: str, fp: float, *,
                 admitted: bool, cached: bool, engine: str,
                 now: float) -> None:
        latency = now - req.t_submit
        self.latencies.append(latency)
        if self.obs:
            self.obs.metrics.histogram(
                "admission_latency_ms",
                edges=LATENCY_MS_EDGES).observe(latency * 1e3)
        req.ticket._resolve(AdmissionVerdict(
            sid=req.sid, kind=req.kind, verdict=verdict, fp=fp,
            admitted=admitted, cached=cached, engine=engine,
            latency_s=latency))
        with self._pending_lock:
            self._pending -= 1
            if self._pending == 0:
                self._pending_lock.notify_all()

    def _audit(self, req: _Request, snap: dict, staged: _Staged,
               verdict: str, fp: float, ok: bool, engine: str,
               peer_crc: int) -> None:
        """Audit one acted-on admission verdict, gossip-shaped: replay
        and replay_frames re-derive it bit for bit."""
        audit = self.obs.audit
        if not audit:
            return
        frames = {}
        if audit.store_frames:
            lf = self._local_frames.get(staged.local_crc)
            if lf is None:
                lf = wire.encode_clock(bc.to_wire(staged.local))
                self._local_frames[staged.local_crc] = lf
                if len(self._local_frames) > 64:
                    self._local_frames.pop(next(iter(self._local_frames)))
            frames = {"local_frame": lf, "peer_frame": req.frame}
        peer_sum = float(
            np.asarray(snap["cells"], np.float64).sum()
            + float(snap["base"]) * self.tiers.m)
        audit.record(
            "verdict", req.sid,
            verdict=verdict,
            action="adopt" if ok else "reject",
            fp=fp,
            threshold=self.threshold,
            engine=engine,
            local_crc=staged.local_crc,
            peer_crc=peer_crc,
            local_sum=staged.local_sum,
            peer_sum=peer_sum,
            transport="serve_pipeline",
            **frames)

    # ---- introspection ----
    def latency_quantiles(self) -> dict:
        """p50/p95/p99 submit->verdict latency (seconds)."""
        if not self.latencies:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        lat = np.asarray(self.latencies)
        return {
            "p50": float(np.quantile(lat, 0.50)),
            "p95": float(np.quantile(lat, 0.95)),
            "p99": float(np.quantile(lat, 0.99)),
        }

    def stats(self) -> dict:
        q = self.latency_quantiles()
        return {
            "admitted": self.n_admitted,
            "rejected": self.n_rejected,
            "queries": self.n_queries,
            "batches": self.batches,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "p50_ms": q["p50"] * 1e3,
            "p95_ms": q["p95"] * 1e3,
            "p99_ms": q["p99"] * 1e3,
        }
