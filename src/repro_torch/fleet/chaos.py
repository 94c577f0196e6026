"""ChaosTransport: seeded, replayable fault injection over any fabric.

The hostile-fleet harness.  :class:`ChaosTransport` wraps any
:class:`~repro_torch.fleet.transport.Transport` (loopback, mesh-collective,
socket) and injects the failure modes a real deployment sees, WITHOUT
the wrapped fabric or the session protocol knowing:

- **drops** — a peer's digest answer or pulled delta frame is lost;
- **duplicates / delays** — a pulled frame is ALSO redelivered on the
  next round (a stale duplicate), or arrives one round late instead;
- **reorders** — the realized delivery order of a round's frames is
  permuted;
- **truncations / bit-flips** — a frame arrives damaged, inbound or on
  the push-back path;
- **crashes** — a peer answers the digest exchange and then dies
  mid-session (pull and push fail), staying down for a configured
  number of rounds before it restarts;
- **partitions** — a set of peers is unreachable for a window of rounds
  and then heals.

Every injected fault is **deterministic in** ``(seed, round, phase,
peer, op)`` — the decision stream is independent of wall clock, thread
interleaving, and dict ordering — and is recorded twice: on
``ChaosTransport.schedule`` (the realized :class:`FaultEvent` list) and
in the ``repro_torch.obs`` audit trail as ``kind="chaos"`` records.  Two runs
with the same seed inject the identical fault schedule, so a failing
chaos run is a repro, not an anecdote.

What the harness demonstrates (``tests/test_torch_chaos.py``,
``python -m repro_torch.fleet.chaos --smoke``,
``core.sim.run_gossip_sim(chaos=...)``): the
anti-entropy session survives every fault class — damaged frames are
rejected at decode and re-pulled, duplicated/reordered deliveries are
idempotent under the §3 merge-on-ingest receive rule, dead peers are
skipped-and-reported — and once faults quiesce the fleet converges to
identical rows with zero false negatives.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import zlib
from typing import Optional

import numpy as np

from repro_torch.fleet.transport.base import Transport
from repro_torch.fleet.transport.socket import PeerRejected
from repro_torch.obs.observer import resolve
from repro_torch.sharding import shard_rows

__all__ = ["ChaosConfig", "ChaosTransport", "FaultEvent",
           "corrupt_registry_row", "main", "smoke_chaos"]


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Fault mix for one :class:`ChaosTransport`.

    Probabilities are per (round, peer) decision points; ``crashes`` and
    ``partitions`` are explicit schedules.  All randomness derives from
    ``seed`` + the decision coordinates, never from global state.
    """

    seed: int = 0
    p_drop_digest: float = 0.0    # peer's digest answer lost this round
    p_drop_frame: float = 0.0     # pulled delta frame lost in flight
    p_duplicate: float = 0.0      # pulled frame ALSO redelivered next round
    p_delay: float = 0.0          # pulled frame arrives next round instead
    p_reorder: float = 0.0        # per-round: permute frame delivery order
    p_truncate: float = 0.0       # pulled frame cut at a random offset
    p_bitflip: float = 0.0        # pulled frame gets one random bit flipped
    p_drop_push: float = 0.0      # outbound union frame to one peer lost
    p_bitflip_push: float = 0.0   # outbound union frame damaged
    #: (peer_id, crash_round, n_down_rounds): the peer answers digests on
    #: ``crash_round`` and then dies mid-session (pull/push fail); it is
    #: fully gone for the next ``n_down_rounds - 1`` rounds, then back.
    crashes: tuple = ()
    #: (peer_ids, start_round, heal_round): the peers are unreachable for
    #: rounds in [start, heal) and then the partition heals.
    partitions: tuple = ()
    #: round index after which all probabilistic faults switch off (the
    #: settle window a convergence check needs); crash / partition
    #: schedules still honor their own rounds.  None = never quiesce.
    quiesce_after: Optional[int] = None


@dataclasses.dataclass
class FaultEvent:
    """One realized injected fault (the schedule entry)."""

    round: int
    phase: str     # digest | pull | push
    pid: str
    kind: str      # peer_down, drop_digest, drop_frame, duplicate, ...
    detail: str = ""

    def as_tuple(self) -> tuple:
        return (self.round, self.phase, self.pid, self.kind, self.detail)


def _flip_bit(frame: bytes, rng: np.random.Generator) -> bytes:
    """Flip one random bit of a frame (never a no-op for len > 0)."""
    if not frame:
        return frame
    pos = int(rng.integers(0, len(frame)))
    bit = int(rng.integers(0, 8))
    buf = bytearray(frame)
    buf[pos] ^= 1 << bit
    return bytes(buf)


class ChaosTransport(Transport):
    """Wrap a transport in a seeded, replayable fault schedule.

    The wrapper proxies ``have`` / ``unreachable`` to the inner
    transport (the session mutates them through the wrapper), counts
    rounds at each ``digests()`` call, and injects faults between the
    session and the fabric.  Faults surface exactly like real ones:
    a dropped digest or dead peer lands in ``unreachable`` (prefixed
    ``chaos:``), a damaged frame reaches the session's decode layer and
    is rejected there — the session code path under test is the real
    one, not a mock.
    """

    authoritative = False        # overridden per-instance from inner

    def __init__(self, inner: Transport, cfg: ChaosConfig = ChaosConfig(),
                 observer=None):
        # deliberately NOT calling super().__init__(): have/unreachable
        # live on the inner transport so the session sees one state
        self.inner = inner
        self.cfg = cfg
        self.obs = resolve(observer)
        self.name = f"chaos+{inner.name}"
        self.authoritative = inner.authoritative
        self.schedule: list[FaultEvent] = []
        self._round = -1           # first digests() call makes it round 0
        self._stash: dict = {}     # pid -> frame queued for next round
        self._quiesced = False

    # ---- session-visible state proxies ----
    @property
    def have(self) -> dict:
        return self.inner.have

    @property
    def unreachable(self) -> dict:
        return self.inner.unreachable

    # ---- deterministic decision stream ----
    def _rng(self, phase: str, pid, op: str) -> np.random.Generator:
        tag = zlib.crc32(f"{phase}|{pid}|{op}".encode())
        return np.random.default_rng((self.cfg.seed, self._round, tag))

    def _hit(self, p: float, phase: str, pid, op: str) -> bool:
        if p <= 0.0 or self._quiesced:
            return False
        if (self.cfg.quiesce_after is not None
                and self._round > self.cfg.quiesce_after):
            return False
        return float(self._rng(phase, pid, op).random()) < p

    def _down(self, pid, digest_phase: bool = False) -> Optional[str]:
        """Crash/partition verdict for this peer at the current round.

        On the crash round itself the peer still answers digests (it
        dies MID-session) — only pull/push see it down.
        """
        if self._quiesced:
            return None
        for c_pid, start, n_down in self.cfg.crashes:
            lo = start + 1 if digest_phase else start
            if str(c_pid) == str(pid) and lo <= self._round < start + n_down:
                return f"crashed r{start} (down {n_down} rounds)"
        for pids, start, heal in self.cfg.partitions:
            if start <= self._round < heal and any(
                    str(q) == str(pid) for q in pids):
                return f"partitioned rounds [{start},{heal})"
        return None

    def quiesce(self) -> None:
        """Switch every fault off (heal crashes and partitions too) —
        the settle window a convergence assertion runs in."""
        self._quiesced = True

    def _fault(self, phase: str, pid, kind: str, detail: str = "") -> None:
        ev = FaultEvent(round=self._round, phase=phase, pid=str(pid),
                        kind=kind, detail=detail)
        self.schedule.append(ev)
        self.obs.audit.record(
            "chaos", pid, action=kind, transport=self.name,
            detail=f"r{ev.round}/{phase}" + (f": {detail}" if detail else ""))
        self.obs.metrics.counter("chaos_faults", kind=kind).inc()

    # ---- the Transport surface ----
    def digests(self):
        self._round += 1
        digs, nbytes = self.inner.digests()    # inner resets unreachable
        out = {}
        for pid in sorted(digs, key=str):
            why = self._down(pid, digest_phase=True)
            if why:
                self.inner.unreachable[pid] = f"chaos: {why}"
                self._fault("digest", pid, "peer_down", why)
                continue
            if self._hit(self.cfg.p_drop_digest, "digest", pid, "drop"):
                self.inner.unreachable[pid] = "chaos: digest dropped"
                self._fault("digest", pid, "drop_digest")
                continue
            out[pid] = digs[pid]
        return out, nbytes

    def pull(self, peer_ids):
        live = []
        for pid in peer_ids:
            why = self._down(pid)
            if why:
                self.inner.unreachable[pid] = f"chaos: {why}"
                self._fault("pull", pid, "peer_down", why)
            else:
                live.append(pid)
        frames, nbytes = self.inner.pull(live)

        order = sorted(frames, key=str)
        if len(order) > 1 and self._hit(self.cfg.p_reorder, "pull",
                                        "*", "reorder"):
            perm = self._rng("pull", "*", "perm").permutation(len(order))
            order = [order[int(i)] for i in perm]
            self._fault("pull", "*", "reorder",
                        "->".join(str(p) for p in order))

        # frames stashed in an earlier round (duplicates / delays) are
        # redelivered now — stale by one-or-more rounds, which the
        # session's merge-on-ingest must absorb without regressing
        ready, self._stash = self._stash, {}
        out: dict = {}
        for pid, frame in ready.items():
            self._fault("pull", pid, "redeliver", f"{len(frame)}B stale")
            out[pid] = frame

        for pid in order:
            frame = frames[pid]
            if self._hit(self.cfg.p_drop_frame, "pull", pid, "drop"):
                self._fault("pull", pid, "drop_frame", f"{len(frame)}B")
                continue
            if self._hit(self.cfg.p_duplicate, "pull", pid, "dup"):
                self._stash[pid] = frame     # clean copy arrives AGAIN
                self._fault("pull", pid, "duplicate")
            if self._hit(self.cfg.p_truncate, "pull", pid, "trunc"):
                cut = int(self._rng("pull", pid, "cutpos").integers(
                    0, max(len(frame), 1)))
                self._fault("pull", pid, "truncate",
                            f"{cut}/{len(frame)}B")
                frame = frame[:cut]
            elif self._hit(self.cfg.p_bitflip, "pull", pid, "flip"):
                frame = _flip_bit(frame, self._rng("pull", pid, "flippos"))
                self._fault("pull", pid, "bitflip")
            if self._hit(self.cfg.p_delay, "pull", pid, "delay"):
                self._stash[pid] = frame     # arrives NEXT round instead
                self._fault("pull", pid, "delay")
                continue
            out[pid] = frame
        return out, nbytes

    def push(self, peer_ids, frame: bytes) -> int:
        sent = 0
        for pid in peer_ids:
            why = self._down(pid)
            if why:
                self.inner.unreachable[pid] = f"chaos: {why}"
                self._fault("push", pid, "peer_down", why)
                continue
            if self._hit(self.cfg.p_drop_push, "push", pid, "drop"):
                # the peer never saw the union: report it so the session
                # neither counts the bytes nor advances the have key
                self.inner.unreachable[pid] = "chaos: push dropped"
                self._fault("push", pid, "drop_push")
                continue
            out = frame
            if self._hit(self.cfg.p_bitflip_push, "push", pid, "flip"):
                out = _flip_bit(frame, self._rng("push", pid, "flippos"))
                self._fault("push", pid, "bitflip_push")
                try:
                    sent += self.inner.push([pid], out)
                except PeerRejected as e:
                    # the peer is alive and refused our damaged frame —
                    # under chaos that is the fabric's fault, not a bug
                    # in our encoder, so report instead of propagating
                    self.inner.unreachable[pid] = (
                        f"chaos: push rejected ({e})")
                    self._fault("push", pid, "push_rejected", str(e))
                continue
            sent += self.inner.push([pid], out)
        return sent

    def close(self) -> None:
        self.inner.close()


def corrupt_registry_row(registry, peer_id, seed: int = 0) -> None:
    """Flip state in one stored registry row WITHOUT refreshing its CRC
    — simulated bit rot / hostile mutation for the self-stabilization
    path (``ClockRegistry.check_integrity`` must flag the row,
    ``GossipConfig.verify_rows`` sessions must quarantine + repair it).

    The same cell and bit as the reference's, from the same
    ``default_rng((seed, crc32(peer_id)))`` draws: a promoted row is
    rewritten in the host store; a packed row is written in place into
    its owning shard's ``cells_u8`` (on a mesh ``registry.cells_u8`` is
    a gathered copy, and the in-place write bumps the shard's version,
    which invalidates any memoised replica).
    """
    rng = np.random.default_rng((seed, zlib.crc32(str(peer_id).encode())))
    slot = registry.slot_of(peer_id)
    if slot in registry._wide:
        row = registry._wide[slot].copy()
        i = int(rng.integers(0, row.shape[0]))
        row[i] ^= row.dtype.type(1 << int(rng.integers(0, 16)))
        registry._wide[slot] = row
    else:
        shard, row = shard_rows(slot, registry._rows)
        cells = registry.shards[shard].cells_u8
        i = int(rng.integers(0, cells.shape[1]))
        cells[row, i] ^= 1 << int(rng.integers(0, 8))
    registry._mat = None


def main(argv=None) -> int:
    """The hostile-fleet smoke: one seeded socket fleet, end to end.

    Runs ``core.sim.run_gossip_sim`` over a real TCP fabric wrapped in
    a ChaosTransport injecting drops, duplicates, damaged frames, and
    one mid-session peer crash, plus one corrupted registry row, then
    asserts the §3 story survived: zero false negatives, convergence to
    identical rows after faults quiesce, the corrupted row repaired,
    and the fault schedule + frame order replayable from the audit
    trail.  The observer's registry lives on ``--device`` (the card
    unless ``--device cpu``).
    """
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="run the seeded hostile-fleet smoke")
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="the registry's device (default: the card)")
    ap.add_argument("--trace-dir", default=None,
                    help="write trace/metrics/audit JSONL here")
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.error("nothing to do (pass --smoke)")

    from repro_torch.causal import CausalPolicy
    from repro_torch.core.sim import SimConfig, run_gossip_sim
    from repro_torch.device import resolve_device
    from repro_torch.fleet.gossip import GossipConfig
    from repro_torch.obs import AuditTrail, Observer

    device = resolve_device(args.device)
    obs = (Observer.to_dir(args.trace_dir) if args.trace_dir
           else Observer(audit=AuditTrail(store_frames=True)))
    res = run_gossip_sim(
        SimConfig(n_nodes=args.nodes, n_events=150, m=64, k=3,
                  seed=args.seed),
        n_rounds=args.rounds,
        gossip_cfg=GossipConfig(policy=CausalPolicy(fp_threshold=1.0),
                                straggler_gap=np.inf, observer=obs,
                                merge_forked=True),
        transport="socket",
        chaos=smoke_chaos(args.seed, args.nodes, args.rounds),
        corrupt_at=(3, 1),
        device=device,
    )
    print("chaos-smoke:", res.summary())

    failures = []
    if res.false_negatives:
        failures.append(f"false negatives: {res.false_negatives}")
    if not res.converged:
        failures.append("fleet did not converge after quiesce")
    if not res.fault_events:
        failures.append("chaos injected no faults (schedule empty)")
    if not res.repaired:
        failures.append("corrupted registry row was never repaired")

    # the trail must carry the realized fault schedule and replay the
    # session frames bit-for-bit (a failing run is a repro)
    chaos_recs = [r for r in obs.audit.records if r.kind == "chaos"]
    if not chaos_recs:
        failures.append("no chaos records in the audit trail")
    rep = obs.audit.replay_frames(device=device)
    if not rep.ok:
        failures.append(f"audit frame replay diverged: {rep.summary()}")
    print(f"chaos-smoke: {len(chaos_recs)} audited faults, "
          f"replay {rep.summary()}")

    if args.trace_dir:
        obs.close()
    if failures:
        for f in failures:
            print("chaos-smoke FAIL:", f, file=sys.stderr)
        return 1
    print("chaos-smoke: OK")
    return 0


def smoke_chaos(seed: int = 7, nodes: int = 5, rounds: int = 6) -> ChaosConfig:
    """The smoke's fault mix: every probabilistic fault class, one
    mid-session crash of the last node, quiesced after the last round."""
    return ChaosConfig(
        seed=seed,
        p_drop_digest=0.10, p_drop_frame=0.15, p_duplicate=0.20,
        p_delay=0.10, p_reorder=0.30, p_truncate=0.10, p_bitflip=0.10,
        p_drop_push=0.10,
        crashes=((f"n{nodes - 1}", 2, 2),),
        quiesce_after=rounds - 1,
    )


if __name__ == "__main__":
    sys.exit(main())
