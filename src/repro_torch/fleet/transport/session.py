"""The transport-agnostic anti-entropy session protocol.

One session is the full reconcile a node runs when it wakes up:

1. **digest exchange** — ``transport.digests()``;
2. **classify** — one ``registry.classify_all`` kernel call;
3. **policy** — quarantine FORKED peers, skip stragglers, gate the
   comparable rest on the Eq. 3 confidence threshold (numpy on [N]
   host vectors);
4. **union merge** — one batched max-reduce over the accepted rows
   (paper §3 receive rule fleet-wide), then §4 re-compress;
5. **push-back** — the union is written into the accepted registry rows
   and shipped as ONE encoded §4 wire frame via ``transport.push``.

Only authoritative transports (the registry IS the peer state) are
ported so far, so there is no delta pull.  The session resolves its
``Observer`` from ``cfg.observer`` → ``cfg.policy.observer`` → the
registry's policy and instruments every phase: spans, byte and outcome
counters, a log10 histogram of claimed fp, and an audit record per
acted-on verdict, captured before push-back overwrites the rows.
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
    if not transport.authoritative:
        raise ValueError(
            f"transport {transport.name!r} is not authoritative: delta "
            "pulls from remote peers are not ported yet")
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
                        detail="registry row CRC mismatch; quarantined")
                    obs.metrics.counter("rows_corrupt",
                                        transport=transport.name).inc()
                corrupted = tuple(sorted(bad, key=str))

        with obs.trace.span("gossip.digest") as sp:
            digests, digest_bytes = transport.digests()
            sp.set(peers=len(digests), bytes=digest_bytes)

        with obs.trace.span("gossip.classify") as sp:
            view = registry.classify_all(local)
            sp.set(engine=view.engine, alive=int(view.alive.sum()))
        alive = view.alive

        # concurrent histories are quarantined as suspected divergence
        quarantined = alive & (view.status == reg.FORKED)

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
                    frame = wire.encode_clock(bc.to_wire(merged))
                    accepted_ids = [pid for pid in registry.peer_ids()
                                    if accepted[registry.slot_of(pid)]]
                    pushback_bytes = transport.push(accepted_ids, frame)
                    sp.set(peers=len(accepted_ids), bytes=pushback_bytes)
                    registry.broadcast(accepted, merged)

        unreachable = dict(transport.unreachable)
        for pid, err in unreachable.items():
            obs.metrics.counter("peer_unreachable",
                                transport=transport.name).inc()
            obs.audit.record("peer_unreachable", pid,
                             transport=transport.name, detail=str(err))

        sess_sp.set(accepted=int(accepted.sum()),
                    quarantined=int(quarantined.sum()),
                    unreachable=len(unreachable),
                    corrupted=len(corrupted))

    if obs.metrics:
        ms = (time.perf_counter_ns() - t0) / 1e6
        obs.metrics.counter("gossip_sessions",
                            transport=transport.name).inc()
        obs.metrics.histogram("gossip_session_ms", edges=_LATENCY_EDGES,
                              transport=transport.name).observe(ms)
        for phase, nbytes in (("digest", digest_bytes),
                              ("delta", 0),
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
        transport=transport.name,
        shards=registry.n_shards,
        unreachable=tuple(sorted(unreachable)),
        corrupted=corrupted,
    )
