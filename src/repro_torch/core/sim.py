"""Event-driven N-node protocol simulator (paper §3 Fig. 6, scaled up).

Generates a random distributed execution (internal events, broadcasts
with per-link drops and delays) and replays it under both the vector
clock (exact ground truth) and the bloom clock, then scores the bloom
clock: no false negatives (§3), the measured fp rate of "A happened
before B" claims against Eq. 3, and wire bytes per message.

The replay is sequential by nature and runs on host numpy.
``run_gossip_sim`` interleaves real fleet gossip rounds over the
loopback, mesh-collective or socket transport, optionally under a
``ChaosTransport``; its registry lives on ``device`` (the card unless
``device="cpu"``), while socket peers serve host numpy clocks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import clock as bc
from repro_torch.core.hashing import bloom_indices

__all__ = ["SimConfig", "SimResult", "run_sim",
           "GossipSimResult", "run_gossip_sim", "monte_carlo_overlap"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_nodes: int = 8
    n_events: int = 400          # total events across all nodes
    m: int = 64                  # bloom cells
    k: int = 3                   # hash probes
    p_broadcast: float = 0.5     # P(event is a broadcast) vs internal
    p_drop: float = 0.2          # per-recipient message drop
    max_delay: int = 3           # message delay in "event slots"
    seed: int = 0
    sample_pairs: int = 4000     # event pairs scored for fp measurement


@dataclasses.dataclass
class SimResult:
    false_negatives: int          # truly-ordered pairs bloom called concurrent (must be 0)
    true_concurrent: int          # pairs both call concurrent
    true_positives: int           # ordered pairs bloom confirms (right direction)
    false_positives: int          # bloom claims order, truth says concurrent/reverse
    measured_fp_rate: float
    mean_predicted_fp: float      # mean Eq. 3 value over claimed-order pairs
    bloom_wire_bytes: int
    vector_wire_bytes: int
    n_pairs_scored: int

    def summary(self) -> str:
        return (
            f"fn={self.false_negatives} tp={self.true_positives} "
            f"fp={self.false_positives} conc={self.true_concurrent} "
            f"measured_fp={self.measured_fp_rate:.4f} "
            f"predicted_fp={self.mean_predicted_fp:.4f} "
            f"wire bloom={self.bloom_wire_bytes}B vector={self.vector_wire_bytes}B"
        )


def _event_probe_indices(cfg: SimConfig) -> np.ndarray:
    """Bloom indices for every event id, by the runtime's hasher.
    [n_events, k]."""
    ev_ids = np.arange(cfg.n_events, dtype=np.uint64)
    return bloom_indices(
        (ev_ids >> np.uint64(32)).astype(np.int64),
        (ev_ids & np.uint64(0xFFFFFFFF)).astype(np.int64),
        cfg.k, cfg.m).numpy()


def _replay(cfg: SimConfig, rng: np.random.Generator, idx: np.ndarray):
    """Shared protocol-event generator for both sims.

    Yields (t, src, bloom [n, m], vec [n, n]) after each event commits.
    The yielded arrays are the LIVE state: consumers may mutate them
    between events and the mutation takes effect from the next event.
    """
    n = cfg.n_nodes
    bloom = np.zeros((n, cfg.m), np.int64)
    vec = np.zeros((n, n), np.int64)
    # in-flight messages: (deliver_slot, dst, bloom_snapshot, vec_snapshot)
    inflight: list[tuple[int, int, np.ndarray, np.ndarray]] = []

    for t in range(cfg.n_events):
        # deliver due messages first (receive = merge, §3 step 3)
        due = [msg for msg in inflight if msg[0] <= t]
        inflight = [msg for msg in inflight if msg[0] > t]
        for _, dst, bsnap, vsnap in due:
            np.maximum(bloom[dst], bsnap, out=bloom[dst])
            np.maximum(vec[dst], vsnap, out=vec[dst])

        src = rng.integers(n)
        np.add.at(bloom[src], idx[t], 1)
        vec[src, src] += 1

        if rng.random() < cfg.p_broadcast:
            for dst in range(n):
                if dst == src or rng.random() < cfg.p_drop:
                    continue
                delay = 1 + rng.integers(cfg.max_delay)
                inflight.append((t + delay, dst, bloom[src].copy(), vec[src].copy()))

        yield t, src, bloom, vec


def run_sim(cfg: SimConfig) -> SimResult:
    rng = np.random.default_rng(cfg.seed)
    n, m = cfg.n_nodes, cfg.m
    idx = _event_probe_indices(cfg)

    ev_bloom = np.zeros((cfg.n_events, m), np.int64)
    ev_vec = np.zeros((cfg.n_events, n), np.int64)
    for t, src, bloom, vec in _replay(cfg, rng, idx):
        ev_bloom[t] = bloom[src]
        ev_vec[t] = vec[src]

    pa = rng.integers(cfg.n_events, size=cfg.sample_pairs)
    pb = rng.integers(cfg.n_events, size=cfg.sample_pairs)
    keep = pa != pb
    pa, pb = pa[keep], pb[keep]

    A_b, B_b = ev_bloom[pa], ev_bloom[pb]
    A_v, B_v = ev_vec[pa], ev_vec[pb]

    truth_ab = np.all(A_v <= B_v, axis=1) & ~np.all(B_v <= A_v, axis=1)
    truth_ba = np.all(B_v <= A_v, axis=1) & ~np.all(A_v <= B_v, axis=1)
    truth_conc = ~truth_ab & ~truth_ba & ~np.all(A_v == B_v, axis=1)
    truth_eq = np.all(A_v == B_v, axis=1)

    claim_ab = np.all(A_b <= B_b, axis=1)
    claim_ba = np.all(B_b <= A_b, axis=1)
    claim_conc = ~claim_ab & ~claim_ba

    # if truth says A->B then cell-wise dominance MUST hold
    false_negatives = int(np.sum(truth_ab & ~claim_ab) + np.sum(truth_ba & ~claim_ba))

    strict_ab = claim_ab & ~claim_ba
    strict_ba = claim_ba & ~claim_ab
    tp = int(np.sum(strict_ab & truth_ab) + np.sum(strict_ba & truth_ba))
    fp = int(np.sum(strict_ab & ~truth_ab & ~truth_eq) + np.sum(strict_ba & ~truth_ba & ~truth_eq))
    conc_agree = int(np.sum(claim_conc & truth_conc))

    sa = A_b.sum(1).astype(np.float32)
    sb = B_b.sum(1).astype(np.float32)
    pred_ab = bc.fp_rate(torch.as_tensor(sa), torch.as_tensor(sb), m).numpy()
    pred_ba = bc.fp_rate(torch.as_tensor(sb), torch.as_tensor(sa), m).numpy()
    preds = np.concatenate([pred_ab[strict_ab], pred_ba[strict_ba]])

    claims = int(np.sum(strict_ab) + np.sum(strict_ba))
    return SimResult(
        false_negatives=false_negatives,
        true_concurrent=conc_agree,
        true_positives=tp,
        false_positives=fp,
        measured_fp_rate=fp / max(claims, 1),
        mean_predicted_fp=float(preds.mean()) if preds.size else 0.0,
        bloom_wire_bytes=m * 4,
        vector_wire_bytes=n * 4,
        n_pairs_scored=int(pa.size),
    )


@dataclasses.dataclass
class GossipSimResult:
    """Score of fleet gossip rounds against vector-clock ground truth."""

    rounds: int
    false_negatives: int      # truth-ordered peers the fleet called FORKED (must be 0)
    claims: int               # ordered/equal verdicts issued across rounds
    false_positives: int      # claims the vector clocks contradict
    measured_fp_rate: float
    mean_predicted_fp: float  # mean Eq. 3 fp over the issued claims
    within_eq3_band: bool     # measured consistent with predicted
    merges: int               # peers actually merged across rounds
    quarantines: int          # FORKED verdicts (all truth-concurrent when fn == 0)
    transport: str = "loopback"   # fabric the audited sessions ran over
    digest_bytes: int = 0     # MEASURED inbound digest bytes across rounds
    delta_bytes: int = 0      # MEASURED inbound delta-frame bytes
    pushback_bytes: int = 0   # MEASURED outbound push-back frame bytes
    converged: bool = True    # all nodes ended on identical rows (chaos)
    fault_events: int = 0     # faults the ChaosTransport injected
    rejected_frames: int = 0  # damaged frames the sessions rejected
    corrupted: int = 0        # registry rows flagged by integrity checks
    repaired: int = 0         # quarantined rows rewritten by gossip repair

    @property
    def wire_bytes(self) -> int:
        return self.digest_bytes + self.delta_bytes + self.pushback_bytes

    def summary(self) -> str:
        s = (
            f"rounds={self.rounds} fn={self.false_negatives} "
            f"claims={self.claims} fp={self.false_positives} "
            f"measured_fp={self.measured_fp_rate:.4f} "
            f"predicted_fp={self.mean_predicted_fp:.4f} "
            f"band_ok={self.within_eq3_band} merges={self.merges} "
            f"quarantines={self.quarantines} "
            f"wire={self.wire_bytes}B[{self.transport}]"
        )
        if self.fault_events:
            s += (f" faults={self.fault_events} "
                  f"rejected={self.rejected_frames} "
                  f"converged={self.converged}")
        if self.corrupted:
            s += f" corrupted={self.corrupted} repaired={self.repaired}"
        return s


def run_gossip_sim(cfg: SimConfig, n_rounds: int = 6, observer: int = 0,
                   gossip_cfg=None, registry_factory=None,
                   transport="loopback", chaos=None, corrupt_at=None,
                   settle_rounds: int = 3, device=None) -> GossipSimResult:
    """Replay a random execution and interleave real fleet gossip rounds
    at node ``observer``, scoring every verdict against the exact
    vector-clock truth: a FORKED verdict for a truth-ordered peer is a
    false negative (§3 says never); ordered/equal verdicts the vector
    clocks contradict are false positives, whose measured rate must sit
    within the Eq. 3 band; accepted merges (and the push-back) are
    applied to both clock families so causality stays aligned.

    ``registry_factory(capacity, m, k) -> ClockRegistry`` swaps the
    observer's registry construction (default: one slab on ``device``);
    a mesh-backed factory runs every audited verdict through the
    sharded paths.  ``transport`` picks the fabric the audited sessions
    run over: ``"loopback"`` (peer rows admitted into the slab directly),
    ``"mesh"`` (``MeshCollectiveTransport`` over the factory's sharded
    registry: the digest ring between its devices), ``"socket"`` (every
    peer's clock served from a threaded TCP ``ClockPeerServer`` of host
    numpy cells; the observer's registry syncs purely through the
    digest/delta/§4 wire-frame path) or a callable
    ``transport(registry) -> Transport``.  Reported wire bytes are
    measured frame lengths, summed over the rounds' reports.

    ``chaos`` (a ``fleet.chaos.ChaosConfig``) wraps the fabric in a
    ``ChaosTransport``; after the event rounds, ``settle_rounds`` more
    event-free rounds run with faults quiesced, and the result reports
    ``converged`` (every node on identical rows).  Under chaos a
    registry row may be a stale snapshot of its peer, so verdicts are
    scored against the vector-clock state each row actually carries,
    tracked per published-snapshot CRC through the audit trail's
    ``frame_ingest`` records.  ``corrupt_at=(round, peer)`` flips a bit
    of that peer's registry row before the given round and turns on
    ``GossipConfig.verify_rows``: the session must detect, quarantine
    and repair it (``corrupted`` / ``repaired``).  ``device`` places the
    replayed clocks.
    """
    from repro_torch.causal import CausalPolicy
    from repro_torch.core import wire
    from repro_torch.device import resolve_device
    from repro_torch.fleet import gossip as fg
    from repro_torch.fleet import monitor as fm
    from repro_torch.fleet import registry as fr
    from repro_torch.fleet import transport as ft
    from repro_torch.fleet.transport.socket import stop_servers
    from repro_torch.obs.observer import resolve

    if not (callable(transport)
            or transport in ("loopback", "mesh", "socket")):
        raise ValueError(f"unknown transport {transport!r}")
    device = resolve_device(device)
    if gossip_cfg is None:
        # accept-everything-comparable audit policy.  Under chaos, forks
        # are legitimate concurrency (not replica divergence), so
        # sessions merge them (§3 pure receive rule)
        fg_cfg = fg.GossipConfig(policy=CausalPolicy(fp_threshold=1.0),
                                 straggler_gap=np.inf,
                                 merge_forked=chaos is not None)
    else:
        fg_cfg = gossip_cfg
    if chaos is not None and corrupt_at is not None:
        fg_cfg = dataclasses.replace(fg_cfg, verify_rows=True)
    rng = np.random.default_rng(cfg.seed)
    n, m, k = cfg.n_nodes, cfg.m, cfg.k
    idx = _event_probe_indices(cfg)

    if registry_factory is None:
        registry_factory = lambda cap, mm, kk: fr.ClockRegistry(
            cap, mm, kk, device=device)
    registry = registry_factory(max(8, n), m, k)
    peers = [p for p in range(n) if p != observer]
    # the instrumentation observer (not the observer NODE above): when
    # present, every audited verdict gets its ground truth attached
    obs = resolve(fg_cfg.observer
                  or (fg_cfg.policy.observer if fg_cfg.policy is not None
                      else None)
                  or registry.policy.observer)
    if chaos is not None and not obs.audit:
        # chaos scoring reads realized ingest order + row CRCs from the
        # trail, so an audit sink is mandatory under fault injection
        from repro_torch.obs import AuditTrail, Observer
        obs = Observer(trace=obs.trace, metrics=obs.metrics,
                       audit=AuditTrail())
        fg_cfg = dataclasses.replace(fg_cfg, observer=obs)

    nodes: dict = {}
    servers: list = []
    try:
        if callable(transport):
            tp = transport(registry)
        elif transport == "mesh":
            tp = ft.MeshCollectiveTransport(registry)
        elif transport == "socket":
            for p in peers:
                node = ft.ClockNode(f"n{p}", m, k)
                servers.append(ft.ClockPeerServer(node).start())
                nodes[p] = node
            tp = ft.SocketTransport(
                {f"n{p}": s.address for p, s in zip(peers, servers)})
        else:
            tp = ft.LoopbackTransport(registry)
    except BaseException:
        stop_servers(servers)
        raise
    chaos_tp = None
    if chaos is not None:
        from repro_torch.fleet import chaos as chaos_mod
        chaos_tp = chaos_mod.ChaosTransport(tp, chaos, observer=obs)
        tp = chaos_tp
    # registry key each sim peer is tracked under (socket peers arrive
    # from the wire under their node ids)
    pid_of = {p: (f"n{p}" if p in nodes else p) for p in peers}

    def as_clock(cells_row: np.ndarray) -> bc.BloomClock:
        return bc.BloomClock(
            cells=torch.as_tensor(cells_row.astype(np.int32), device=device),
            base=torch.zeros((), dtype=torch.int32, device=device), k=k)

    fn = fp_count = claims = merges = quarantines = 0
    digest_bytes = delta_bytes = pushback_bytes = 0
    rejected_frames = corrupted_rows = repaired_rows = 0
    predicted: list[float] = []
    round_marks = set(
        np.linspace(cfg.n_events // max(n_rounds, 1), cfg.n_events - 1,
                    n_rounds, dtype=int).tolist())
    rounds_done = 0
    converged = True
    corrupt_done = False
    # chaos ground truth: a registry row may be a STALE snapshot of its
    # peer, so each published bloom state's CRC maps to the vector-clock
    # state it was taken with, and ``reg_truth`` shadows what each
    # registry row causally contains (None = unknowable, never scored)
    vec_by_crc: dict[int, np.ndarray] = {}
    reg_truth: dict = {}
    by_spid = {str(pid_of[p]): p for p in peers}

    def chaos_round(bloom, vec):
        """One gossip round under fault injection, scored against the
        snapshot each registry row actually carries."""
        nonlocal fn, fp_count, claims, merges, quarantines
        nonlocal digest_bytes, delta_bytes, pushback_bytes
        nonlocal rejected_frames, corrupted_rows, repaired_rows
        nonlocal corrupt_done
        if tp.authoritative:
            registry.admit_many({p: as_clock(bloom[p]) for p in peers})
        else:
            for p in peers:
                nodes[p].set_cells(bloom[p])
                vec_by_crc[wire.cells_crc(bloom[p])] = vec[p].copy()
        if (corrupt_at is not None and not corrupt_done
                and rounds_done - 1 >= corrupt_at[0]):
            pid_c = pid_of[corrupt_at[1]]
            if pid_c in registry and registry.row_alive(pid_c):
                chaos_mod.corrupt_registry_row(registry, pid_c,
                                               seed=chaos.seed)
                corrupt_done = True
        local = as_clock(bloom[observer])
        audit_mark = len(obs.audit.records)
        merged, report = ft.anti_entropy_session(registry, local, tp, fg_cfg)
        digest_bytes += report.digest_bytes
        delta_bytes += report.delta_bytes
        pushback_bytes += report.pushback_bytes
        rejected_frames += len(report.rejected)
        corrupted_rows += len(report.corrupted)
        repaired_rows += len(report.repaired)

        # what does each registry row causally contain now?  Fresh or
        # repair pulls replace the row with the frame's snapshot; pulls
        # into a live row merge with it (§3 receive rule)
        if tp.authoritative:
            for p in peers:
                reg_truth[pid_of[p]] = vec[p].copy()
        else:
            for rec in obs.audit.records[audit_mark:]:
                if rec.kind != "frame_ingest":
                    continue
                p = by_spid.get(rec.peer_id)
                if p is None:
                    continue
                pid = pid_of[p]
                frame_vec = vec_by_crc.get(int(rec.peer_crc))
                if frame_vec is None:
                    reg_truth[pid] = None
                elif pid in report.repaired or pid not in reg_truth:
                    reg_truth[pid] = frame_vec.copy()
                elif reg_truth[pid] is not None:
                    reg_truth[pid] = np.maximum(reg_truth[pid], frame_vec)

        vo = vec[observer]
        truth_of: dict[str, bool] = {}
        for p in peers:
            pid = pid_of[p]
            if pid not in registry:
                continue           # digest dropped before first ingest
            s = registry.slot_of(pid)
            if not bool(report.view.alive[s]):
                continue           # quarantined this round: no verdict
            vp = reg_truth.get(pid)
            if vp is None:
                continue           # row snapshot unknowable: not scored
            code = int(report.view.status[s])
            p_le_o = bool(np.all(vp <= vo))
            o_le_p = bool(np.all(vo <= vp))
            if code == fr.FORKED:
                quarantines += 1
                truth_of[str(pid)] = not (p_le_o or o_le_p)
                if p_le_o or o_le_p:
                    fn += 1        # §3 violation: can never happen
                continue
            claims += 1
            predicted.append(float(report.view.fp[s]))
            truth_ok = {
                fr.ANCESTOR: p_le_o,
                fr.SAME: p_le_o and o_le_p,
                fr.DESCENDANT: o_le_p,
            }[code]
            truth_of[str(pid)] = truth_ok
            if not truth_ok:
                fp_count += 1

        for rec in obs.audit.records[audit_mark:]:
            if rec.kind == "verdict" and rec.peer_id in truth_of:
                obs.audit.annotate_truth(rec, truth_of[rec.peer_id])

        # commit: the union's causal content is the join of the
        # SNAPSHOTS its rows carried, not the peers' current clocks
        accept_ids = [p for p in peers if pid_of[p] in registry
                      and report.accepted[registry.slot_of(pid_of[p])]]
        merges += len(accept_ids)
        if accept_ids:
            merged_np = merged.logical_cells().cpu().numpy().astype(np.int64)
            union_vec = vo.copy()
            union_known = True
            for p in accept_ids:
                vp = reg_truth.get(pid_of[p])
                if vp is None:
                    union_known = False
                else:
                    np.maximum(union_vec, vp, out=union_vec)
            np.maximum(bloom[observer], merged_np, out=bloom[observer])
            if union_known:
                np.maximum(vec[observer], union_vec, out=vec[observer])
            if fg_cfg.push_back:
                for p in accept_ids:
                    if (not tp.authoritative
                            and pid_of[p] in report.unreachable):
                        continue   # chaos ate the push: peer never saw it
                    np.maximum(bloom[p], merged_np, out=bloom[p])
                    if union_known:
                        np.maximum(vec[p], union_vec, out=vec[p])
                    # the session broadcast the union into this row (on
                    # non-authoritative fabrics: only because the push
                    # was acknowledged)
                    reg_truth[pid_of[p]] = (union_vec.copy()
                                            if union_known else None)

    last_state = None
    try:
        for t, _src, bloom, vec in _replay(cfg, rng, idx):
            if t not in round_marks:
                continue
            rounds_done += 1
            last_state = (bloom, vec)
            if chaos is not None:
                chaos_round(bloom, vec)
                continue
            if tp.authoritative:
                registry.admit_many({p: as_clock(bloom[p]) for p in peers})
            else:
                # peers publish their CURRENT clock on their own server;
                # the observer's registry syncs via digest/delta frames
                for p in peers:
                    nodes[p].set_cells(bloom[p])
            local = as_clock(bloom[observer])
            audit_mark = len(obs.audit.records) if obs.audit else 0
            merged, report = ft.anti_entropy_session(registry, local, tp,
                                                     fg_cfg)
            digest_bytes += report.digest_bytes
            delta_bytes += report.delta_bytes
            pushback_bytes += report.pushback_bytes

            vo = vec[observer]
            truth_of: dict[str, bool] = {}
            for p in peers:
                s = registry.slot_of(pid_of[p])
                code = int(report.view.status[s])
                p_le_o = bool(np.all(vec[p] <= vo))
                o_le_p = bool(np.all(vo <= vec[p]))
                if code == fr.FORKED:
                    quarantines += 1
                    # a quarantine is "correct" iff truly concurrent
                    truth_of[str(pid_of[p])] = not (p_le_o or o_le_p)
                    if p_le_o or o_le_p:
                        fn += 1      # §3 violation: can never happen
                    continue
                claims += 1
                predicted.append(float(report.view.fp[s]))
                truth_ok = {
                    fr.ANCESTOR: p_le_o,
                    fr.SAME: p_le_o and o_le_p,
                    fr.DESCENDANT: o_le_p,
                }[code]
                truth_of[str(pid_of[p])] = truth_ok
                if not truth_ok:
                    fp_count += 1

            if obs.audit:
                for rec in obs.audit.records[audit_mark:]:
                    if rec.kind == "verdict" and rec.peer_id in truth_of:
                        obs.audit.annotate_truth(rec, truth_of[rec.peer_id])

            # commit the round to BOTH clock families (receive rule)
            accept_ids = [p for p in peers
                          if report.accepted[registry.slot_of(pid_of[p])]]
            merges += len(accept_ids)
            if accept_ids:
                union_vec = vo.copy()
                for p in accept_ids:
                    np.maximum(union_vec, vec[p], out=union_vec)
                merged_np = merged.logical_cells().cpu().numpy().astype(np.int64)
                bloom[observer] = merged_np
                vec[observer] = union_vec
                if fg_cfg.push_back:
                    for p in accept_ids:
                        bloom[p] = merged_np
                        vec[p] = union_vec.copy()

        # ---- chaos settle: faults off, no new events, prove recovery ----
        if chaos is not None and last_state is not None:
            chaos_tp.quiesce()
            bloom, vec = last_state
            for _ in range(max(settle_rounds, 0)):
                rounds_done += 1
                chaos_round(bloom, vec)
            converged = all(
                np.array_equal(bloom[p], bloom[observer]) for p in peers)
    finally:
        tp.close()
        stop_servers(servers)

    measured = fp_count / max(claims, 1)
    mean_pred = float(np.mean(predicted)) if predicted else 0.0
    if obs.metrics:
        obs.metrics.gauge("sim_measured_fp").set(measured)
        obs.metrics.gauge("sim_mean_predicted_fp").set(mean_pred)
        obs.metrics.gauge("sim_fp_within_band").set(
            float(fm.fp_within_band(measured, mean_pred)))
    return GossipSimResult(
        rounds=rounds_done,
        false_negatives=fn,
        claims=claims,
        false_positives=fp_count,
        measured_fp_rate=measured,
        mean_predicted_fp=mean_pred,
        within_eq3_band=fm.fp_within_band(measured, mean_pred),
        merges=merges,
        quarantines=quarantines,
        transport=tp.name,
        digest_bytes=digest_bytes,
        delta_bytes=delta_bytes,
        pushback_bytes=pushback_bytes,
        converged=converged,
        fault_events=len(chaos_tp.schedule) if chaos_tp is not None else 0,
        rejected_frames=rejected_frames,
        corrupted=corrupted_rows,
        repaired=repaired_rows,
    )


def monte_carlo_overlap(m: int, sum_a: int, sum_b: int, trials: int,
                        seed: int = 0) -> float:
    """Empirical probability that a random clock with ``sum_b``
    increments cell-wise dominates an independent random clock with
    ``sum_a`` increments: the quantity Eq. 3 approximates (the paper's
    m=6, ΣB=10, ΣA=7 -> 0.29 example).  numpy's ``default_rng(seed)``
    draws, so the same arguments give the reference's float."""
    rng = np.random.default_rng(seed)
    a_cells = rng.multinomial(sum_a, np.full(m, 1.0 / m), size=trials)
    b_cells = rng.multinomial(sum_b, np.full(m, 1.0 / m), size=trials)
    return float(np.mean(np.all(a_cells <= b_cells, axis=1)))
