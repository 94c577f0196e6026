"""Append-only audit trail of acted-on causality verdicts.

Every strict-order verdict a gossip session or a serving admit *acts
on* — accept a peer's history, quarantine a fork, adopt a migrating
session — is recorded with everything needed to re-check it later:
the CRC content digests of both clocks (``core.wire.cells_crc``), the
verdict, the Eq. 3 false-positive probability the engine claimed, the
policy threshold it was gated against, and which engine produced it.
With ``store_frames=True`` the trail additionally keeps both clocks'
wire frames (base64 in the JSONL), making every record *standalone
replayable* even after push-back has overwritten the registry row the
verdict was computed from.

Two replay checkers:

- :func:`AuditTrail.replay` re-runs ``classify_all`` against a live
  registry and compares verdict + fp **bit-for-bit**; records whose
  CRC pair no longer matches the registry state are reported ``stale``
  rather than failed (the row moved on — expected under push-back).
- :func:`AuditTrail.replay_frames` decodes the stored wire frames,
  re-admits them into a scratch registry, and re-runs the same
  ``classify_all`` path the live session used — exact regardless of
  what happened to the original registry since.

Under ``run_gossip_sim`` each verdict is additionally annotated with
vector-clock ground truth (``annotate_truth``), so the trail reports a
*measured* fp rate next to the predicted one and ``fp_within_band``
becomes a continuously evaluated property instead of a sim-only one.
"""
from __future__ import annotations

import base64
import dataclasses
import json
from typing import Optional

import numpy as np

__all__ = ["AuditRecord", "AuditTrail", "NullAudit", "NULL_AUDIT",
           "ReplayReport"]


@dataclasses.dataclass
class AuditRecord:
    """One acted-on verdict (or transport fault) in the trail."""

    seq: int
    kind: str                 # "verdict" | "peer_unreachable" | "chaos"
                              # | "frame_ingest" | "frame_rejected"
                              # | "row_corrupt" | "row_repaired"
    peer_id: str
    verdict: str = ""         # STATUS_NAMES string, e.g. "ancestor"
    action: str = ""          # what the verdict drove: accept/quarantine/...
    fp: float = 0.0           # Eq. 3 fp the engine claimed
    threshold: float = 0.0    # policy gate it was compared against
    engine: str = ""          # dispatch label that produced it
    local_crc: int = 0        # cells_crc of the local/query clock
    peer_crc: int = 0         # cells_crc of the peer clock
    local_sum: float = 0.0
    peer_sum: float = 0.0
    transport: str = ""
    detail: str = ""          # free text (e.g. the unreachable error)
    truth_ok: Optional[bool] = None   # vector-clock ground truth, if known
    local_frame: Optional[bytes] = None   # wire frames for replay_frames
    peer_frame: Optional[bytes] = None

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for key in ("local_frame", "peer_frame"):
            if d[key] is not None:
                d[key] = base64.b64encode(d[key]).decode()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "AuditRecord":
        d = dict(d)
        for key in ("local_frame", "peer_frame"):
            if d.get(key) is not None:
                d[key] = base64.b64decode(d[key])
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


@dataclasses.dataclass
class ReplayReport:
    """Outcome of re-verifying a trail's verdicts."""

    checked: int = 0          # records re-verified
    matched: int = 0          # verdict AND fp bit-identical
    stale: int = 0            # CRC pair no longer matches registry state
    skipped: int = 0          # not replayable (no frames / unknown peer)
    mismatches: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.checked > 0 and not self.mismatches

    def summary(self) -> str:
        return (f"replay: {self.matched}/{self.checked} matched, "
                f"{self.stale} stale, {self.skipped} skipped, "
                f"{len(self.mismatches)} mismatched")


class AuditTrail:
    """Append-only verdict log, optionally mirrored to JSONL."""

    def __init__(self, path=None, *, store_frames: bool = False):
        self.records: list[AuditRecord] = []
        self.store_frames = store_frames
        self._path = str(path) if path else None
        self._file = open(self._path, "w") if self._path else None
        self._seq = 0

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self.records)

    def record(self, kind: str, peer_id, **kw) -> AuditRecord:
        if not self.store_frames:
            kw.pop("local_frame", None)
            kw.pop("peer_frame", None)
        rec = AuditRecord(seq=self._seq, kind=kind, peer_id=str(peer_id), **kw)
        self._seq += 1
        self.records.append(rec)
        if self._file is not None:
            self._file.write(json.dumps(rec.as_dict()) + "\n")
        return rec

    def annotate_truth(self, rec: AuditRecord, ok: bool) -> None:
        """Attach vector-clock ground truth to a recorded verdict; the
        JSONL mirror gets an amend line keyed by seq."""
        rec.truth_ok = bool(ok)
        if self._file is not None:
            self._file.write(json.dumps(
                {"amend": rec.seq, "truth_ok": rec.truth_ok}) + "\n")

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    # ---- accounting ----
    def verdicts(self) -> list[AuditRecord]:
        return [r for r in self.records if r.kind == "verdict"]

    def chaos_events(self) -> list[AuditRecord]:
        """Realized fault schedule (``kind="chaos"``) in injection
        order — with the seed, this is the repro of a hostile run."""
        return [r for r in self.records if r.kind == "chaos"]

    def frame_sequence(self) -> list[AuditRecord]:
        """Realized ingest order of decoded delta frames
        (``kind="frame_ingest"``): which frame landed in which session,
        in order — the message schedule a chaos replay must reproduce."""
        return [r for r in self.records if r.kind == "frame_ingest"]

    def mean_predicted_fp(self) -> float:
        """Mean claimed Eq. 3 fp over strict-order verdicts on record."""
        fps = [r.fp for r in self.verdicts()
               if r.verdict in ("ancestor", "descendant")]
        return float(np.mean(fps)) if fps else 0.0

    def measured_fp_rate(self) -> Optional[float]:
        """Fraction of truth-annotated strict verdicts ground truth
        refutes — the *measured* counterpart of Eq. 3.  None until at
        least one verdict has been annotated."""
        judged = [r for r in self.verdicts() if r.truth_ok is not None]
        if not judged:
            return None
        return float(np.mean([not r.truth_ok for r in judged]))

    def fp_within_band(self, slack: float = 3.0, abs_tol: float = 0.01) -> Optional[bool]:
        """Is the measured fp rate consistent with the mean prediction?
        Same band as ``fleet.monitor.fp_within_band``."""
        measured = self.measured_fp_rate()
        if measured is None:
            return None
        from repro_torch.fleet.monitor import fp_within_band
        return fp_within_band(measured, self.mean_predicted_fp(),
                              slack=slack, abs_tol=abs_tol)

    # ---- replay ----
    def replay(self, registry, local) -> ReplayReport:
        """Re-verify recorded verdicts against a LIVE registry.

        Re-runs the registry's own ``classify_all`` once and compares
        each record whose (local_crc, peer_crc) still matches current
        state — verdict string and fp float must be bit-identical.
        Records whose row has since changed count as ``stale``.
        """
        from repro_torch.core.wire import cells_crc
        from repro_torch.fleet.registry import STATUS_NAMES

        rep = ReplayReport()
        todo = self.verdicts()
        if not todo:
            return rep
        local_crc = cells_crc(local.logical_cells().cpu().numpy())
        view = registry.classify_all(local)
        mat = registry._materialized().cpu().numpy()
        for rec in todo:
            if rec.peer_id not in registry:
                rep.skipped += 1
                continue
            slot = registry.slot_of(rec.peer_id)
            peer_crc = cells_crc(mat[slot])
            if rec.local_crc != local_crc or rec.peer_crc != peer_crc:
                rep.stale += 1
                continue
            rep.checked += 1
            got_verdict = STATUS_NAMES[int(view.status[slot])]
            got_fp = float(view.fp[slot])
            if got_verdict == rec.verdict and got_fp == rec.fp:
                rep.matched += 1
            else:
                rep.mismatches.append({
                    "seq": rec.seq, "peer_id": rec.peer_id,
                    "recorded": (rec.verdict, rec.fp),
                    "replayed": (got_verdict, got_fp)})
        return rep

    def replay_frames(self, policy=None, device=None) -> ReplayReport:
        """Re-verify from the stored wire frames alone.

        Frames are decoded, re-admitted into a scratch registry built
        from ``policy`` (grouped per local clock so each group costs one
        ``classify_all``), and compared bit-for-bit — the original
        registry may have been pushed-back over, discarded, or live in
        another process.  Requires ``store_frames=True`` at record time.
        ``device`` places the scratch registry (None = the card).
        """
        from repro_torch.core import clock as bc
        from repro_torch.core.wire import decode_clock
        from repro_torch.fleet.registry import ClockRegistry, STATUS_NAMES

        rep = ReplayReport()
        groups: dict[bytes, list[AuditRecord]] = {}
        for rec in self.verdicts():
            if rec.local_frame is None or rec.peer_frame is None:
                rep.skipped += 1
                continue
            groups.setdefault(rec.local_frame, []).append(rec)
        for local_frame, recs in groups.items():
            snap = decode_clock(local_frame)
            local = bc.from_wire(snap, device=device)
            m, k = int(np.asarray(snap["cells"]).shape[0]), int(snap["k"])
            reg = ClockRegistry(capacity=max(8, len(recs)), m=m, k=k,
                                policy=policy, device=device)
            clocks = {}
            for i, rec in enumerate(recs):
                psnap = decode_clock(rec.peer_frame)
                clocks[f"replay/{i}"] = bc.from_wire(psnap, device=device)
            reg.admit_many(clocks)
            view = reg.classify_all(local)
            for i, rec in enumerate(recs):
                rep.checked += 1
                slot = reg.slot_of(f"replay/{i}")
                got_verdict = STATUS_NAMES[int(view.status[slot])]
                got_fp = float(view.fp[slot])
                if got_verdict == rec.verdict and got_fp == rec.fp:
                    rep.matched += 1
                else:
                    rep.mismatches.append({
                        "seq": rec.seq, "peer_id": rec.peer_id,
                        "recorded": (rec.verdict, rec.fp),
                        "replayed": (got_verdict, got_fp)})
        return rep

    @classmethod
    def load(cls, path) -> "AuditTrail":
        """Read a JSONL trail back (amend lines applied in order)."""
        trail = cls()
        by_seq = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                if "amend" in d:
                    rec = by_seq.get(d["amend"])
                    if rec is not None:
                        rec.truth_ok = d.get("truth_ok")
                    continue
                rec = AuditRecord.from_dict(d)
                by_seq[rec.seq] = rec
                trail.records.append(rec)
        trail._seq = max(by_seq) + 1 if by_seq else 0
        trail.store_frames = any(
            r.local_frame is not None for r in trail.records)
        return trail


class NullAudit:
    """Auditing disabled: records vanish, replay reports empty."""

    __slots__ = ()
    store_frames = False

    def __bool__(self) -> bool:
        return False

    def __len__(self) -> int:
        return 0

    def record(self, kind: str, peer_id, **kw) -> None:
        return None

    def annotate_truth(self, rec, ok) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL_AUDIT = NullAudit()
