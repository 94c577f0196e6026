"""The transport-agnostic anti-entropy session protocol.

One session is the full reconcile a node runs when it wakes up; WHERE
the peer rows live is the transport's problem and WHAT the node decides
is shared, bit for bit, across fabrics:

1. **digest exchange** — ``transport.digests()`` advertises every
   peer's content key.  Authoritative transports (loopback,
   mesh-collective) skip ingest: the session registry IS the peer state.
2. **delta pull** — only peers whose key differs from the row this node
   holds (``transport.have``) are pulled, as ``core.wire`` clock frames.
   A frame that fails decode is rejected for that peer only (a
   ``frame_rejected`` audit record, ``GossipReport.rejected``); decoded
   rows are merged into live rows (§3 receive rule, so duplicated and
   reordered deliveries are idempotent), replace quarantined rows, or
   are admitted.  The decoded clocks go straight to the registry's
   device; each ingested frame leaves a ``frame_ingest`` record.
3. **classify** — one ``registry.classify_all`` kernel call;
4. **policy** — quarantine FORKED peers (unless ``merge_forked``), skip
   stragglers, gate the comparable rest on the Eq. 3 confidence
   threshold (numpy on [N] host vectors);
5. **union merge** — one batched max-reduce over the accepted rows
   (paper §3 receive rule fleet-wide), then §4 re-compress;
6. **push-back** — the union is shipped as ONE encoded §4 wire frame via
   ``transport.push`` and written into the accepted registry rows; on a
   non-authoritative fabric only into the rows whose push was
   acknowledged.

The session resolves its ``Observer`` from ``cfg.observer`` →
``cfg.policy.observer`` → the registry's policy and instruments every
phase: spans (``gossip.digest``, ``gossip.pull``, ``gossip.classify``,
``gossip.union``, ``gossip.push`` under ``gossip.session``), byte and
outcome counters, a log10 histogram of claimed fp, and an audit record
per acted-on verdict, captured before push-back overwrites the rows.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import clock as bc
from repro_torch.core import wire
from repro_torch.fleet import registry as reg
from repro_torch.fleet.gossip import GossipConfig, GossipReport
from repro_torch.fleet.transport.base import Transport
from repro_torch.obs.observer import resolve

__all__ = ["anti_entropy_session"]

# log10(ms) bins for session round latency: 10µs .. 100s
_LATENCY_EDGES = tuple(float(x) for x in np.linspace(-2.0, 5.0, 15))


def _session_observer(cfg: GossipConfig, registry: reg.ClockRegistry):
    obs = cfg.observer
    if obs is None and cfg.policy is not None:
        obs = cfg.policy.observer
    if obs is None:
        obs = registry.policy.observer
    return resolve(obs)


def _ingest_delta(registry: reg.ClockRegistry, transport: Transport,
                  obs) -> tuple[int, int, dict, set]:
    """Digest exchange + delta pull into the session registry.

    Returns measured (digest_bytes, delta_bytes, rejected, revived):
    ``revived`` holds the pids whose quarantined (corrupt) row this pull
    rewrote.  Peers advertised with an unchanged content key are
    skipped; vanished peers stay in the registry.  A frame that fails
    decode is dropped for THIS peer only and its ``have`` key is not
    advanced, so the next round re-pulls it.  A decoded row is merged
    with the live row it updates; a quarantined row is replaced
    outright (merging would launder the corruption).

    Device traffic, per pulled frame on a card registry: two
    host-to-device copies (the decoded cells and base) and two reads
    back in the registry's write (one of them synchronising); a live
    row adds its ``get`` and the merge, about 16 small device ops.  The
    ``have`` keys come from the CRCs the registry records at the write
    and the audit CRCs from the decoded host frames, so neither costs a
    transfer.
    """
    with obs.trace.span("gossip.digest") as sp:
        digests, digest_bytes = transport.digests()
        sp.set(peers=len(digests), bytes=digest_bytes)
    if transport.authoritative:
        return digest_bytes, 0, {}, set()
    wanted = [pid for pid, d in digests.items()
              if transport.have.get(pid) != d.key]
    with obs.trace.span("gossip.pull", wanted=len(wanted)) as sp:
        if not wanted:
            sp.set(bytes=0)
            return digest_bytes, 0, {}, set()
        frames, delta_bytes = transport.pull(wanted)
        sp.set(pulled=len(frames), bytes=delta_bytes)
        clocks, frame_crc, rejected = {}, {}, {}
        for pid, frame in frames.items():
            try:
                snap = wire.decode_clock(frame)
            except wire.WireFormatError as e:
                rejected[pid] = str(e)
                obs.audit.record("frame_rejected", pid,
                                 transport=transport.name, detail=str(e))
                obs.metrics.counter("frames_rejected",
                                    transport=transport.name).inc()
                continue
            clocks[pid] = bc.from_wire(snap, device=registry.device)
            frame_crc[pid] = wire.cells_crc(snap["cells"], snap["base"])
        known, fresh, revived = {}, {}, set()
        for pid, c in clocks.items():
            if pid not in registry:
                fresh[pid] = c
            elif registry.row_alive(pid):
                known[pid] = bc.merge(registry.get(pid), c)
            else:
                known[pid] = c       # quarantined row: replace, don't merge
                revived.add(pid)
        if known:
            registry.update_many(known)
        if fresh:
            registry.admit_many(fresh)
        if obs.audit:
            for pid in clocks:
                obs.audit.record("frame_ingest", pid,
                                 transport=transport.name,
                                 peer_crc=frame_crc[pid])
        for pid in clocks:
            # the key of the row we now HOLD (not the advertised key):
            # if a delayed or duplicated frame left the row stale, the
            # keys differ and the next digest exchange re-pulls the peer
            transport.have[pid] = (
                int(registry._crc_host[registry.slot_of(pid)]), registry.m)
        if rejected:
            sp.set(rejected=len(rejected))
    return digest_bytes, delta_bytes, rejected, revived


def _audit_verdicts(obs, registry: reg.ClockRegistry,
                    local: bc.BloomClock, view: reg.FleetView,
                    masks: dict, cfg: GossipConfig,
                    transport_name: str) -> list:
    """One audit record per acted-on verdict, captured pre-push-back."""
    mat = registry._materialized().cpu().numpy()
    local_cells = local.logical_cells().cpu().numpy()
    local_crc = wire.cells_crc(local_cells)
    local_frame = (wire.encode_clock(bc.to_wire(local))
                   if obs.audit.store_frames else None)
    slot_pid = {registry.slot_of(pid): pid for pid in registry.peer_ids()}
    recs = []
    for action, mask in masks.items():
        for slot in np.flatnonzero(mask):
            pid = slot_pid.get(int(slot))
            if pid is None:
                continue
            peer_frame = None
            if obs.audit.store_frames:
                peer_frame = wire.encode_clock(
                    bc.to_wire(registry.get(pid)))
            recs.append(obs.audit.record(
                "verdict", pid,
                verdict=reg.STATUS_NAMES[int(view.status[slot])],
                action=action,
                fp=float(view.fp[slot]),
                threshold=float(cfg.fp_gate),
                engine=view.engine,
                local_crc=local_crc,
                peer_crc=wire.cells_crc(mat[slot]),
                local_sum=float(view.local_sum),
                peer_sum=float(view.sums[slot]),
                transport=transport_name,
                local_frame=local_frame,
                peer_frame=peer_frame,
            ))
    return recs


def anti_entropy_session(
    registry: reg.ClockRegistry,
    local: bc.BloomClock,
    transport: Transport,
    cfg: GossipConfig = GossipConfig(),
) -> tuple[bc.BloomClock, GossipReport]:
    """Run one anti-entropy session; returns (merged local clock, report)."""
    obs = _session_observer(cfg, registry)
    t0 = time.perf_counter_ns()
    with obs.trace.span("gossip.session", transport=transport.name,
                        shards=registry.n_shards) as sess_sp:
        corrupted: tuple = ()
        if cfg.verify_rows:
            with obs.trace.span("gossip.verify") as sp:
                bad = registry.check_integrity()
                sp.set(corrupted=len(bad))
            if bad:
                registry.quarantine_rows(bad)
                for pid in bad:
                    obs.audit.record(
                        "row_corrupt", pid, transport=transport.name,
                        detail="registry row CRC mismatch; quarantined "
                               "pending gossip repair")
                    obs.metrics.counter("rows_corrupt",
                                        transport=transport.name).inc()
                    if not transport.authoritative:
                        # force the delta phase to re-pull the row from
                        # any peer whose digest covers it
                        transport.have.pop(pid, None)
                corrupted = tuple(sorted(bad, key=str))

        digest_bytes, delta_bytes, rejected, revived = _ingest_delta(
            registry, transport, obs)

        # repairs are pulls that rewrote a quarantined row, including
        # rows quarantined in an earlier session whose re-pull the
        # fabric kept dropping until now
        repaired = tuple(sorted(revived, key=str))
        for pid in repaired:
            obs.audit.record("row_repaired", pid, transport=transport.name,
                             detail="corrupt row replaced by re-pulled "
                                    "peer frame")
            obs.metrics.counter("rows_repaired",
                                transport=transport.name).inc()

        with obs.trace.span("gossip.classify") as sp:
            view = registry.classify_all(local)
            sp.set(engine=view.engine, alive=int(view.alive.sum()))
        alive = view.alive

        forked = alive & (view.status == reg.FORKED)
        # the §3 pure receive rule merges concurrent histories; the
        # default policy quarantines them as suspected replica divergence
        quarantined = (np.zeros_like(forked) if cfg.merge_forked
                       else forked)

        stragglers = np.zeros_like(alive)
        if alive.any():
            med = float(np.median(view.sums[alive]))
            stragglers = alive & ~quarantined & (
                (med - view.sums) > cfg.straggler_gap)

        comparable = alive & ~quarantined & ~stragglers
        unconfident = comparable & ~view.confident(cfg.fp_gate)
        accepted = comparable & ~unconfident

        if obs.audit:
            _audit_verdicts(
                obs, registry, local, view,
                {"accept": accepted, "quarantine": quarantined}, cfg,
                transport.name)

        merged = local
        pushback_bytes = 0
        if accepted.any():
            with obs.trace.span("gossip.union", n=int(accepted.sum())):
                merged = bc.compress(registry.union(accepted, local))
            if cfg.push_back:
                with obs.trace.span("gossip.push") as sp:
                    snap = bc.to_wire(merged)
                    frame = wire.encode_clock(snap)
                    accepted_ids = [pid for pid in registry.peer_ids()
                                    if accepted[registry.slot_of(pid)]]
                    pushback_bytes = transport.push(accepted_ids, frame)
                    sp.set(peers=len(accepted_ids), bytes=pushback_bytes)
                    if transport.authoritative:
                        registry.broadcast(accepted, merged)
                    else:
                        # a staging row mirrors its PEER: only rows whose
                        # push was acknowledged may claim the union, or
                        # the row would fork from the peer it stands for
                        delivered = [pid for pid in accepted_ids
                                     if pid not in transport.unreachable]
                        dmask = np.zeros_like(accepted)
                        for pid in delivered:
                            dmask[registry.slot_of(pid)] = True
                        if dmask.any():
                            registry.broadcast(dmask, merged)
                        # the union row is now what those peers hold
                        # (unless they tick first, which the next digest
                        # exchange sees)
                        key = wire.digest_of("", snap["cells"],
                                             snap["base"], snap["k"]).key
                        for pid in delivered:
                            transport.have[pid] = key

        # peers the transport skipped and reported in any phase of this
        # round: audit + metric per peer, session completed without them
        unreachable = dict(transport.unreachable)
        for pid, err in unreachable.items():
            obs.metrics.counter("peer_unreachable",
                                transport=transport.name).inc()
            obs.audit.record("peer_unreachable", pid,
                             transport=transport.name, detail=str(err))

        sess_sp.set(accepted=int(accepted.sum()),
                    quarantined=int(quarantined.sum()),
                    unreachable=len(unreachable),
                    rejected=len(rejected),
                    corrupted=len(corrupted))

    if obs.metrics:
        ms = (time.perf_counter_ns() - t0) / 1e6
        obs.metrics.counter("gossip_sessions",
                            transport=transport.name).inc()
        obs.metrics.histogram("gossip_session_ms", edges=_LATENCY_EDGES,
                              transport=transport.name).observe(ms)
        for phase, nbytes in (("digest", digest_bytes),
                              ("delta", delta_bytes),
                              ("push", pushback_bytes)):
            obs.metrics.counter("gossip_bytes", phase=phase).inc(nbytes)
        for outcome, mask in (("accepted", accepted),
                              ("quarantined", quarantined),
                              ("stragglers", stragglers),
                              ("unconfident", unconfident)):
            n = int(mask.sum())
            if n:
                obs.metrics.counter("gossip_peers", outcome=outcome).inc(n)
        strict = alive & np.isin(view.status,
                                 (reg.ANCESTOR, reg.DESCENDANT))
        if strict.any():
            obs.metrics.histogram("fp_claimed").observe_many(
                view.fp[strict])

    return merged, GossipReport(
        accepted=accepted,
        quarantined=quarantined,
        stragglers=stragglers,
        unconfident=unconfident,
        view=view,
        pushback_bytes=pushback_bytes,
        digest_bytes=digest_bytes,
        delta_bytes=delta_bytes,
        transport=transport.name,
        shards=registry.n_shards,
        unreachable=tuple(sorted(unreachable)),
        rejected=tuple(sorted(rejected, key=str)),
        corrupted=corrupted,
        repaired=repaired,
    )
