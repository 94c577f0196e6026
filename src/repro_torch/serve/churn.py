"""Seeded churn driver: million-session serving load with exact truth.

Simulates a serving replica admitting a stream of sessions that arrive,
get queried with Zipf-skewed access, migrate, and expire — the workload
shape the tiered registry exists for — while tracking a vector-clock
ground truth cheap enough to hold for millions of sessions.

Truth model.  The replica's history is a single event chain (R ticks
total).  Each session is minted from a snapshot of the replica taken at
``T_birth`` replica ticks and then given ``P`` private ticks (events the
replica never saw).  The replica only ticks between pipeline ``drain()``
barriers, so every verdict in a step is classified against one known R:

- ``P == 0``            → session ≼ replica (*related*: ancestor/same).
  Bloom dominance is exact, so classifying it FORKED is a false
  negative — the paper's §3 guarantee broken somewhere in the stack
  (tiering, packing, wire, kernel).  The driver asserts ZERO of these.
- ``P > 0, T_birth < R`` → truly concurrent.  Bloom may still report
  "ancestor" when the private ticks collide with cells the replica also
  advanced — that's the §3 false positive Eq. 3 prices; the driver
  reports the measured rate next to the claimed one.

Arrivals are minted from the PREVIOUS step's snapshot, so by the time
they classify the replica has advanced past ``T_birth`` and ``P > 0``
sessions are genuinely concurrent, not merely descendants.  Related
arrivals within a step share one wire frame, which is what makes the
digest cache earn its keep under real load (same cells, same local
clock → one classify, many hits).

``--quick`` runs a small fully-audited configuration and asserts both
zero false negatives and bit-for-bit audit replay (the serve-smoke
gate); the big-run defaults keep auditing off so memory stays flat at
millions of sessions.  The run is on the card unless ``--device``
(``run_churn(device=...)``) asks for another device:

    python -m repro_torch.serve.churn --quick
    python -m repro_torch.serve.churn --device cpu --quick
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.causal import CausalPolicy
from repro_torch.core import clock as bc
from repro_torch.core import wire
from repro_torch.device import resolve_device
from repro_torch.serve.pipeline import AdmissionPipeline, PipelineConfig
from repro_torch.serve.tiers import TierConfig, TieredRegistry

__all__ = ["ChurnConfig", "ChurnReport", "run_churn", "main"]


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    sessions: int = 1_000_000     # total arrivals over the run
    steps: int = 64               # drain barriers (replica ticks between)
    queries_per_step: int = 2048  # Zipf-skewed lookups per step
    migrate_per_step: int = 64    # sessions re-minted from a fresh snapshot
    expire_frac: float = 0.05     # fraction of a step's arrivals released
    concurrent_frac: float = 0.25 # arrivals with private (P>0) ticks
    private_ticks: int = 3        # P for concurrent arrivals
    replica_ticks: int = 4        # replica events per step
    zipf_a: float = 1.3           # access-skew exponent
    m: int = 256
    k: int = 4
    seed: int = 0
    batch_size: int = 256
    hot_capacity: int = 4096
    warm_capacity: int = 65536
    promote_after: int = 3
    fp_threshold: float = 1.0     # admission gate (1.0: admit all related)
    audit: bool = False           # gossip-style audit of every verdict
    trace_dir: Optional[str] = None

    @staticmethod
    def quick(**kw) -> "ChurnConfig":
        """Small, fully audited: the serve-smoke configuration."""
        defaults = dict(sessions=3000, steps=12, queries_per_step=256,
                        migrate_per_step=16, m=64, batch_size=64,
                        hot_capacity=128, warm_capacity=512,
                        promote_after=2, audit=True)
        defaults.update(kw)
        return ChurnConfig(**defaults)


@dataclasses.dataclass
class ChurnReport:
    sessions: int = 0             # arrivals submitted
    admitted: int = 0
    rejected: int = 0
    queries: int = 0
    migrations: int = 0
    expiries: int = 0
    fn_violations: int = 0        # related sessions classified forked
    concurrent_seen: int = 0
    measured_fp: float = 0.0      # concurrent classified as related
    claimed_fp_mean: float = 0.0  # mean Eq. 3 claim on those verdicts
    cache_hits: int = 0
    cache_misses: int = 0
    promotions: int = 0
    demotions: int = 0
    spills: int = 0
    tier_counts: dict = dataclasses.field(default_factory=dict)
    p50_ms: float = 0.0
    p95_ms: float = 0.0
    p99_ms: float = 0.0
    qps: float = 0.0              # resolved requests / wall second
    wall_s: float = 0.0
    replay: Optional[dict] = None # audit replay result (when audited)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def ok(self) -> bool:
        good = self.fn_violations == 0
        if self.replay is not None:
            good = good and not self.replay.get("mismatches")
        return good


class _Live:
    """Live-session set with O(1) insert/remove and stable positional
    indexing for Zipf rank sampling (index 0 = oldest survivor)."""

    def __init__(self):
        self.sids: list = []
        self.pos: dict = {}

    def __len__(self):
        return len(self.sids)

    def add(self, sid) -> None:
        self.pos[sid] = len(self.sids)
        self.sids.append(sid)

    def remove(self, sid) -> None:
        i = self.pos.pop(sid)
        last = self.sids.pop()
        if last != sid:
            self.sids[i] = last
            self.pos[last] = i

    def rank(self, r: int):
        return self.sids[(r - 1) % len(self.sids)]


def _mint_concurrent(snap: bc.BloomClock, hi: np.ndarray,
                     lo: np.ndarray) -> np.ndarray:
    """[n, m] int32 cells: snapshot + per-session private ticks.

    hi/lo: [n, P] uint32 event ids.  One batched ``bc.tick`` call per
    step (one launch of the tick kernel on the card) — private cells
    collide with the replica's exactly as real concurrent histories
    would.
    """
    n = hi.shape[0]
    cells = snap.logical_cells().to(torch.int32).expand(n, snap.m)
    batch = bc.BloomClock(
        cells=cells.contiguous(),
        base=torch.zeros((n,), dtype=torch.int32, device=snap.device),
        k=snap.k)
    out = bc.tick(batch, hi, lo)
    return out.logical_cells().cpu().numpy()


def run_churn(cfg: ChurnConfig = ChurnConfig(), observer=None,
              device=None, inspect=None) -> ChurnReport:
    """Run the driver on ``device`` (None = the card); returns a
    :class:`ChurnReport` (no asserts — the CLI turns report failures
    into exit codes).  ``inspect(tiers, replica)``, when given, sees the
    final store and replica clock before the tiers close."""
    from repro_torch.obs import Observer, resolve
    from repro_torch.obs.audit import AuditTrail
    dev = resolve_device(device)
    if observer is None and (cfg.audit or cfg.trace_dir):
        observer = Observer.to_dir(cfg.trace_dir) if cfg.trace_dir \
            else Observer()
    obs = resolve(observer)
    if cfg.audit and not obs.audit:
        observer = Observer(trace=obs.trace or None,
                            metrics=obs.metrics or None,
                            audit=AuditTrail(store_frames=True))
        obs = resolve(observer)

    rng = np.random.default_rng(cfg.seed)
    policy = CausalPolicy(fp_threshold=cfg.fp_threshold, observer=observer)
    tiers = TieredRegistry(
        TierConfig(hot_capacity=cfg.hot_capacity,
                   warm_capacity=cfg.warm_capacity,
                   promote_after=cfg.promote_after,
                   # big slabs move in big waves: amortize the card's
                   # scatters
                   demote_batch=max(32, cfg.hot_capacity // 8),
                   spill_batch=max(256, cfg.warm_capacity // 8)),
        m=cfg.m, k=cfg.k, policy=policy, device=dev)
    replica = [bc.zeros(cfg.m, cfg.k, device=dev)]
    pipe = AdmissionPipeline(tiers, lambda: replica[0],
                             PipelineConfig(batch_size=cfg.batch_size))

    # truth arrays, indexed by integer session id ("s<idx>")
    cap = cfg.sessions + 1
    t_birth = np.zeros(cap, np.int64)
    private = np.zeros(cap, np.int32)
    next_idx = 0
    live = _Live()
    stored_p = {}             # sid -> P of the clock the tiers hold
    report = ChurnReport()
    conc_related = 0          # concurrent sessions classified related
    conc_claims: list = []
    r_ticks = 0               # replica tick count (== truth R)
    replica_event = 0
    # lagged snapshot: arrivals mint from the clock BEFORE this step's
    # ticks, so concurrent arrivals truly concurrent at classify time
    snap = replica[0]
    snap_ticks = 0

    arrivals_left = cfg.sessions
    per_step = max(1, cfg.sessions // cfg.steps)
    t0 = time.perf_counter()

    for step in range(cfg.steps):
        n_arr = min(per_step if step < cfg.steps - 1 else arrivals_left,
                    arrivals_left)
        arrivals_left -= n_arr
        tickets = []

        # ---- arrivals ----
        conc_mask = rng.random(n_arr) < cfg.concurrent_frac
        idxs = np.arange(next_idx, next_idx + n_arr)
        next_idx += n_arr
        t_birth[idxs] = snap_ticks
        private[idxs] = np.where(conc_mask, cfg.private_ticks, 0)
        shared_frame = wire.encode_clock(bc.to_wire(snap))
        n_conc = int(conc_mask.sum())
        if n_conc:
            ci = idxs[conc_mask]
            hi = np.broadcast_to(ci[:, None] & 0xFFFFFFFF,
                                 (n_conc, cfg.private_ticks)
                                 ).astype(np.uint32)
            lo = np.broadcast_to(
                (np.arange(cfg.private_ticks) * 0x9E370001) & 0xFFFFFFFF,
                (n_conc, cfg.private_ticks)).astype(np.uint32)
            conc_cells = _mint_concurrent(snap, hi, lo)
        conc_at = 0
        admitted_now = set()   # sids with an admit in flight this step
        for j, idx in enumerate(idxs):
            sid = f"s{idx}"
            if conc_mask[j]:
                fr = wire.encode_clock(
                    {"cells": conc_cells[conc_at], "base": 0,
                     "k": cfg.k})
                conc_at += 1
            else:
                fr = shared_frame
            tickets.append((sid, "admit", int(private[idx]),
                            pipe.submit(sid, frame=fr)))
            admitted_now.add(sid)
            live.add(sid)
        report.sessions += n_arr

        # ---- migrations: re-mint live sessions from the snapshot ----
        n_mig = min(cfg.migrate_per_step, len(live))
        if n_mig:
            picks = rng.choice(len(live), size=n_mig, replace=False)
            for sid in [live.sids[p] for p in picks]:
                idx = int(sid[1:])
                t_birth[idx] = snap_ticks
                private[idx] = 0
                tickets.append((sid, "admit", 0,
                                pipe.submit(sid, frame=shared_frame)))
                admitted_now.add(sid)
            report.migrations += n_mig

        # ---- Zipf-skewed queries ----
        n_q = min(cfg.queries_per_step, len(live))
        if n_q:
            for r in rng.zipf(cfg.zipf_a, size=n_q):
                sid = live.rank(int(r))
                tickets.append((sid, "query", None,
                                pipe.submit(sid, kind="query")))
            report.queries += n_q

        pipe.drain()

        # ---- truth check at the barrier ----
        # Admit verdicts classify the request's own frame: always
        # checkable against its P.  Query verdicts classify the STORED
        # clock, whose P is only known once this step's admits settle —
        # so same-step-admitted sids are skipped (their stored clock
        # mid-step depends on batch interleaving).
        for sid, kind, p, ticket in tickets:
            v = ticket.result()
            if v.verdict == "unknown":
                continue      # queried before admission or after expiry
            if kind == "admit":
                if p == 0 and v.verdict == "forked":
                    report.fn_violations += 1
                if p != 0:
                    report.concurrent_seen += 1
                    if v.verdict in ("ancestor", "same"):
                        conc_related += 1
                        conc_claims.append(v.fp)
            elif sid not in admitted_now:
                if stored_p.get(sid) == 0 and v.verdict == "forked":
                    report.fn_violations += 1
        for sid, kind, p, ticket in tickets:
            if kind == "admit" and ticket.result().admitted:
                stored_p[sid] = p

        # ---- expiries (between barriers: tiers are ours to mutate) ----
        n_exp = min(int(cfg.expire_frac * n_arr), max(0, len(live) - 1))
        if n_exp:
            picks = rng.choice(len(live), size=n_exp, replace=False)
            for sid in [live.sids[p] for p in picks]:
                live.remove(sid)
                stored_p.pop(sid, None)
                if sid in tiers:
                    tiers.release(sid)
            report.expiries += n_exp

        # ---- replica advances (next step's arrivals see this lag) ----
        snap = replica[0]
        snap_ticks = r_ticks
        ev = np.arange(replica_event, replica_event + cfg.replica_ticks)
        replica_event += cfg.replica_ticks
        replica[0] = bc.tick(replica[0],
                             np.full(cfg.replica_ticks, 0x5EED0001,
                                     np.uint32),
                             (ev & 0xFFFFFFFF).astype(np.uint32))
        r_ticks += cfg.replica_ticks

    pipe.drain()
    wall = time.perf_counter() - t0
    total = pipe.n_admitted + pipe.n_rejected + pipe.n_queries

    report.admitted = pipe.n_admitted
    report.rejected = pipe.n_rejected
    report.cache_hits = pipe.cache_hits
    report.cache_misses = pipe.cache_misses
    report.promotions = tiers.promotions
    report.demotions = tiers.demotions
    report.spills = tiers.spills
    from collections import Counter
    report.tier_counts = dict(Counter(tiers._tier_of.values()))
    q = pipe.latency_quantiles()
    report.p50_ms = q["p50"] * 1e3
    report.p95_ms = q["p95"] * 1e3
    report.p99_ms = q["p99"] * 1e3
    report.qps = total / wall if wall > 0 else 0.0
    report.wall_s = wall
    if report.concurrent_seen:
        report.measured_fp = conc_related / report.concurrent_seen
    if conc_claims:
        report.claimed_fp_mean = float(np.mean(conc_claims))

    pipe.close()
    if cfg.audit and obs.audit:
        rep = obs.audit.replay_frames(
            policy=dataclasses.replace(tiers.policy, observer=None),
            device=dev)
        report.replay = {"checked": rep.checked, "matched": rep.matched,
                         "stale": rep.stale, "skipped": rep.skipped,
                         "mismatches": [str(x) for x in rep.mismatches]}
    if inspect is not None:
        inspect(tiers, replica[0])
    if observer is not None and hasattr(observer, "flush"):
        observer.flush()
    tiers.close()
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="bloom-clock serving churn driver")
    ap.add_argument("--quick", action="store_true",
                    help="small fully-audited CI configuration")
    ap.add_argument("--sessions", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--queries", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--m", type=int, default=None)
    ap.add_argument("--hot", type=int, default=None)
    ap.add_argument("--warm", type=int, default=None)
    ap.add_argument("--zipf", type=float, default=None)
    ap.add_argument("--fp-threshold", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--audit", action="store_true")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--json", default=None,
                    help="write the report to this path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    over = {k: v for k, v in dict(
        sessions=args.sessions, steps=args.steps,
        queries_per_step=args.queries, batch_size=args.batch,
        m=args.m, hot_capacity=args.hot, warm_capacity=args.warm,
        zipf_a=args.zipf, fp_threshold=args.fp_threshold,
    ).items() if v is not None}
    over["seed"] = args.seed
    if args.audit:
        over["audit"] = True
    if args.trace_dir:
        over["trace_dir"] = args.trace_dir
    cfg = ChurnConfig.quick(**over) if args.quick else ChurnConfig(**over)

    report = run_churn(cfg, device=args.device)
    out = report.to_dict()
    print(json.dumps(out, indent=2, default=str))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2, default=str)
    if report.fn_violations:
        print(f"FAIL: {report.fn_violations} false negatives "
              "(related session classified forked)", file=sys.stderr)
        return 1
    if report.replay is not None and report.replay["mismatches"]:
        print(f"FAIL: audit replay mismatches: "
              f"{report.replay['mismatches'][:3]}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
