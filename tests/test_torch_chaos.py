"""The port's hostile-fleet harness against the JAX package's
(``tests/test_chaos.py``), on the CPU.

- **the decision stream** — under one seed and config the port's
  ``ChaosTransport.schedule`` is the reference's, fault for fault: over
  a scripted fabric (every fault class, quiesce, a healing partition),
  and inside ``run_gossip_sim`` over loopback and real TCP;
- **survival** — ``run_gossip_sim(..., chaos=..., corrupt_at=(3, 1))``
  gives the reference's ``GossipSimResult`` fields, with fn == 0,
  ``converged`` and the corrupted row repaired; ``main --smoke`` passes;
- **self-stabilization** — ``corrupt_registry_row`` flips the
  reference's cell and bit, ``check_integrity`` flags it on one slab and
  on a 4-shard CPU mesh (whose memoised replica the in-place write
  invalidates), and a ``verify_rows`` session repairs it over TCP;
- **ingest** — a rejected frame skips the peer, not the round;
  duplicate and stale ingest is idempotent; near-wrap rows ride the
  exact int32 rim and union exactly.

Tolerances: schedules, result counts, cells, masks and bytes identical;
the sims' mean predicted fp within a relative 5e-2.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.causal import CausalPolicy as JPolicy  # noqa: E402
from repro.core import clock as jbc  # noqa: E402
from repro.core.sim import SimConfig as JSimConfig  # noqa: E402
from repro.core.sim import run_gossip_sim as jrun_gossip_sim  # noqa: E402
from repro.fleet import ClockRegistry as JRegistry  # noqa: E402
from repro.fleet import GossipConfig as JGossipConfig  # noqa: E402
from repro.fleet import chaos as jchaos  # noqa: E402
from repro.fleet import transport as jft  # noqa: E402
from repro.fleet.transport.base import Transport as JTransport  # noqa: E402
from repro.obs import AuditTrail as JAuditTrail  # noqa: E402
from repro.obs import Observer as JObserver  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.causal import CausalPolicy as TPolicy  # noqa: E402
from repro_torch.core import clock as tbc  # noqa: E402
from repro_torch.core import wire  # noqa: E402
from repro_torch.core.sim import SimConfig, run_gossip_sim  # noqa: E402
from repro_torch.fleet import ClockRegistry as TRegistry  # noqa: E402
from repro_torch.fleet import GossipConfig  # noqa: E402
from repro_torch.fleet import chaos as tchaos  # noqa: E402
from repro_torch.fleet import registry as fr  # noqa: E402
from repro_torch.fleet import transport as ft  # noqa: E402
from repro_torch.fleet.transport.base import Transport  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_fleet_mesh  # noqa: E402
from repro_torch.obs import AuditTrail, Observer  # noqa: E402

CPU = "cpu"
FP_RTOL = 5e-2
INT32_MAX = np.iinfo(np.int32).max
RESULT_FIELDS = ("rounds", "false_negatives", "claims", "false_positives",
                 "merges", "quarantines", "transport", "digest_bytes",
                 "delta_bytes", "pushback_bytes", "within_eq3_band",
                 "converged", "fault_events", "rejected_frames", "corrupted",
                 "repaired", "measured_fp_rate")


def tclock(cells, k=3) -> tbc.BloomClock:
    return tbc.BloomClock(torch.as_tensor(np.asarray(cells, np.int32)),
                          torch.zeros((), dtype=torch.int32), k)


def jclock(cells, k=3) -> jbc.BloomClock:
    return jbc.BloomClock(jnp.asarray(np.asarray(cells), jnp.int32),
                          jnp.zeros((), jnp.int32), k)


def wrapped(cells64) -> np.ndarray:
    """int64 logical values folded onto the int32 two's-complement rim."""
    return (np.asarray(cells64, np.int64) & 0xFFFFFFFF).astype(
        np.uint32).view(np.int32)


def no_address(detail: str) -> str:
    """A fault's detail without the ephemeral TCP port it may quote."""
    return re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:*", detail)


def audit_cfg(obs, policy_cls=TPolicy, cfg_cls=GossipConfig):
    return cfg_cls(policy=policy_cls(fp_threshold=1.0), straggler_gap=np.inf,
                   observer=obs, merge_forked=True)


# ---------------------------------------------------------------------------
# the decision stream: the port's schedule is the reference's
# ---------------------------------------------------------------------------

def scripted(base_cls, clock, m: int = 16, n: int = 4):
    """A minimal non-authoritative fabric of either package: fixed
    peers, fixed frames (``tests/test_chaos.py::_ScriptedInner``)."""

    class Scripted(base_cls):
        name = "scripted"
        authoritative = False

        def __init__(self):
            super().__init__()
            self.m = m
            self.rows = {f"p{i}": np.arange(m, dtype=np.int64) + i
                         for i in range(n)}

        def digests(self):
            self._begin_round()
            digs = {pid: wire.digest_of(pid, row)
                    for pid, row in self.rows.items()}
            return digs, 8 * len(digs)

        def pull(self, peer_ids):
            frames = {}
            for pid in peer_ids:
                if pid in self.unreachable:
                    continue
                frames[pid] = wire.encode_clock(
                    clock.to_wire(clock_of(clock, self.rows[pid])))
            return frames, sum(len(f) for f in frames.values())

        def push(self, peer_ids, frame):
            return len(frame) * len(peer_ids)

    return Scripted()


def clock_of(mod, row):
    return tclock(row) if mod is tbc else jclock(row)


HOT = tchaos.ChaosConfig(
    seed=13, p_drop_digest=0.3, p_drop_frame=0.4, p_duplicate=0.5,
    p_delay=0.3, p_reorder=0.6, p_truncate=0.3, p_bitflip=0.3,
    p_drop_push=0.4, crashes=(("p1", 2, 2),),
    partitions=((("p2",), 1, 3),))

SCHEDULES = {
    "hot": HOT,
    "hot_seed14": dataclasses.replace(HOT, seed=14),
    "bitflip": tchaos.ChaosConfig(seed=1, p_bitflip=0.9),
    "push": tchaos.ChaosConfig(seed=4, p_drop_push=0.3, p_bitflip_push=0.5),
    "partition": tchaos.ChaosConfig(seed=3, p_drop_frame=0.1,
                                    partitions=((("p0", "p3"), 1, 4),)),
    "quiesce_after": dataclasses.replace(HOT, quiesce_after=3),
}


def run_schedule(chaos_mod, base_cls, clock, cfg, rounds: int = 8,
                 quiesce_at=None):
    tp = chaos_mod.ChaosTransport(scripted(base_cls, clock), cfg)
    outputs = []
    for r in range(rounds):
        if r == quiesce_at:
            tp.quiesce()
        digs, _ = tp.digests()
        frames, _ = tp.pull(sorted(digs))
        tp.push(sorted(digs), b"x" * 40)
        outputs.append((sorted(digs), {p: frames[p] for p in sorted(frames)},
                        sorted(tp.unreachable)))
    return [ev.as_tuple() for ev in tp.schedule], outputs


def jax_config(cfg: tchaos.ChaosConfig) -> jchaos.ChaosConfig:
    return jchaos.ChaosConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("quiesce_at", [None, 2])
def test_schedule_matches_reference(name, quiesce_at):
    """Fault for fault, frame for frame: the port's realized schedule
    and deliveries equal the reference's under the same seed."""
    cfg = SCHEDULES[name]
    got = run_schedule(tchaos, Transport, tbc, cfg, quiesce_at=quiesce_at)
    want = run_schedule(jchaos, JTransport, jbc, jax_config(cfg),
                        quiesce_at=quiesce_at)
    assert got == want
    assert got[0] or quiesce_at == 2 and name == "bitflip", "no fault"
    again = run_schedule(tchaos, Transport, tbc, cfg, quiesce_at=quiesce_at)
    assert again == got


def test_schedule_injects_every_fault_class_and_seeds_diverge():
    sched, _ = run_schedule(tchaos, Transport, tbc, HOT, rounds=10)
    kinds = {ev[3] for ev in sched}
    for want in ("drop_digest", "drop_frame", "duplicate", "redeliver",
                 "delay", "reorder", "truncate", "peer_down", "drop_push"):
        assert want in kinds, (want, sorted(kinds))
    flips, _ = run_schedule(tchaos, Transport, tbc, SCHEDULES["bitflip"],
                            rounds=4)
    assert {ev[3] for ev in flips} == {"bitflip"}
    other, _ = run_schedule(tchaos, Transport, tbc,
                            dataclasses.replace(HOT, seed=14), rounds=10)
    assert other != sched


def test_quiesce_stops_everything():
    tp = tchaos.ChaosTransport(scripted(Transport, tbc), HOT)
    tp.digests()
    tp.quiesce()
    before = len(tp.schedule)
    for _ in range(4):
        digs, _ = tp.digests()
        frames, _ = tp.pull(sorted(digs))
        assert sorted(digs) == sorted(tp.inner.rows)   # crash healed too
        assert sorted(frames) == sorted(digs)
        assert not tp.unreachable
    assert len(tp.schedule) == before
    for name in ("ChaosConfig", "ChaosTransport", "FaultEvent"):
        assert name in tfleet.__all__
        assert getattr(tfleet, name) is getattr(tchaos, name)


# ---------------------------------------------------------------------------
# survival: the hostile sim in both packages
# ---------------------------------------------------------------------------

def smoke_mix(**kw) -> dict:
    return dict(seed=7, p_drop_digest=0.1, p_drop_frame=0.15,
                p_duplicate=0.2, p_delay=0.1, p_reorder=0.3, p_truncate=0.1,
                p_bitflip=0.1, p_drop_push=0.1, crashes=(("n4", 2, 2),), **kw)


SIMS = {
    # the reference's acceptance scenario (test_chaos.py:146)
    "hostile_socket": (dict(n_nodes=5, n_events=150, m=64, k=3, seed=7), 6,
                       "socket", smoke_mix(), (3, 1)),
    # its reproducibility case (:174)
    "socket_seed9": (dict(n_nodes=5, n_events=120, m=64, k=3, seed=9), 5,
                     "socket", dict(seed=5, p_drop_frame=0.2, p_bitflip=0.2,
                                    p_duplicate=0.2), None),
    # a partition that heals (:195)
    "partition": (dict(n_nodes=5, n_events=120, m=64, k=3, seed=3), 6,
                  "socket", dict(seed=3, p_drop_frame=0.1, p_duplicate=0.15,
                                 partitions=((("n2", "n3"), 1, 4),)), None),
    # an authoritative fabric under chaos (:204)
    "loopback": (dict(n_nodes=6, n_events=120, m=64, k=3, seed=1), 5,
                 "loopback", dict(seed=11, p_drop_digest=0.3,
                                  crashes=((2, 1, 2),)), None),
    # damaged push-back frames refused by live TCP peers
    "push_rejected": (dict(n_nodes=5, n_events=120, m=64, k=3, seed=2), 5,
                      "socket", dict(seed=2, p_bitflip_push=0.5,
                                     p_drop_push=0.2, quiesce_after=3),
                      (2, 2)),
}


@pytest.mark.parametrize("name", sorted(SIMS))
def test_chaos_sim_matches_reference(name):
    sim, rounds, fabric, mix, corrupt_at = SIMS[name]
    tobs = Observer(audit=AuditTrail(store_frames=True))
    jobs = JObserver(audit=JAuditTrail(store_frames=True))
    got = run_gossip_sim(SimConfig(**sim), n_rounds=rounds,
                         gossip_cfg=audit_cfg(tobs), transport=fabric,
                         chaos=tchaos.ChaosConfig(**mix),
                         corrupt_at=corrupt_at, device=CPU)
    want = jrun_gossip_sim(JSimConfig(**sim), n_rounds=rounds,
                           gossip_cfg=audit_cfg(jobs, JPolicy, JGossipConfig),
                           transport=fabric, chaos=jchaos.ChaosConfig(**mix),
                           corrupt_at=corrupt_at)
    for key in RESULT_FIELDS:
        assert getattr(got, key) == getattr(want, key), key
    assert abs(got.mean_predicted_fp - want.mean_predicted_fp) <= \
        FP_RTOL * abs(want.mean_predicted_fp)
    assert got.summary() == want.summary()
    assert got.false_negatives == 0 and got.converged, got.summary()
    assert got.fault_events > 0
    assert got.transport == f"chaos+{fabric}"
    # the realized fault schedule and frame order, record for record
    trail = [(r.peer_id, r.action, no_address(r.detail))
             for r in tobs.audit.chaos_events()]
    jtrail = [(r.peer_id, r.action, no_address(r.detail))
              for r in jobs.audit.chaos_events()]
    assert trail == jtrail and len(trail) == got.fault_events
    kinds = [(r.kind, r.peer_id, r.action, r.verdict, r.peer_crc)
             for r in tobs.audit.records]
    jkinds = [(r.kind, r.peer_id, r.action, r.verdict, r.peer_crc)
              for r in jobs.audit.records]
    assert kinds == jkinds
    rep = tobs.audit.replay_frames(device=CPU)
    assert rep.ok, rep.summary()
    if corrupt_at is not None:
        assert got.corrupted >= 1 and got.repaired >= 1
        assert {"row_corrupt", "row_repaired"} <= {k[0] for k in kinds}


def test_chaos_main_smoke_passes():
    assert tchaos.main(["--smoke", "--device", CPU]) == 0
    assert tchaos.smoke_chaos() == tchaos.ChaosConfig(
        **smoke_mix(quiesce_after=5))


# ---------------------------------------------------------------------------
# self-stabilization: the same flip, detection, repair
# ---------------------------------------------------------------------------

def corrupt_rows() -> dict:
    rng = np.random.default_rng(0)
    rows = {f"p{i}": rng.integers(0, 40, 16) for i in range(5)}
    rows["wide"] = np.arange(16) * 100            # span > 255: promoted
    rows["wrap"] = wrapped(np.full(16, INT32_MAX - 3, np.int64)
                           + np.arange(16))       # near-wrap: promoted
    return rows


@pytest.mark.parametrize("pid", ["p1", "p4", "wide", "wrap"])
@pytest.mark.parametrize("seed", [0, 7])
def test_corrupt_registry_row_flips_reference_cell(pid, seed):
    rows = corrupt_rows()
    treg = TRegistry(8, 16, 3, device=CPU)
    treg.admit_many({p: tclock(r) for p, r in rows.items()})
    jreg = JRegistry(capacity=8, m=16, k=3)
    jreg.admit_many({p: jclock(r) for p, r in rows.items()})
    assert (pid in ("wide", "wrap")) == (treg.slot_of(pid) in treg._wide)
    tchaos.corrupt_registry_row(treg, pid, seed=seed)
    jchaos.corrupt_registry_row(jreg, pid, seed=seed)
    np.testing.assert_array_equal(treg.cells.numpy(), np.asarray(jreg.cells))
    assert treg.check_integrity() == jreg.check_integrity() == [pid]
    diff = treg.cells.numpy()[treg.slot_of(pid)] != wrapped(rows[pid])
    assert diff.sum() == 1
    treg.quarantine_rows([pid])
    assert not treg.row_alive(pid) and pid in treg
    view = treg.classify_all(tclock(np.zeros(16)))
    assert not bool(view.alive[treg.slot_of(pid)])
    treg.update_many({pid: tclock(rows[pid])})
    assert treg.row_alive(pid) and treg.check_integrity() == []
    np.testing.assert_array_equal(
        treg.get(pid).logical_cells().numpy(), wrapped(rows[pid]))


@pytest.mark.parametrize("pid", ["p3", "wide"])
def test_corrupt_registry_row_on_a_cpu_mesh(pid):
    """On 4 row shards the flip lands in the owning shard (the gathered
    ``cells_u8`` is a copy), bumps its version so the memoised replica
    is rebuilt, and matches the unsharded slab's flip."""
    rows = corrupt_rows()
    flat = TRegistry(8, 16, 3, device=CPU)
    flat.admit_many({p: tclock(r) for p, r in rows.items()})
    reg = TRegistry(8, 16, 3, mesh=make_fleet_mesh(4, device=CPU))
    reg.admit_many({p: tclock(r) for p, r in rows.items()})
    parts = tuple(sh.cells_u8 for sh in reg.shards)
    before = ops._gathered_replica(parts, reg.device).clone()
    tchaos.corrupt_registry_row(reg, pid, seed=1)
    tchaos.corrupt_registry_row(flat, pid, seed=1)
    np.testing.assert_array_equal(reg.cells.numpy(), flat.cells.numpy())
    assert reg.check_integrity() == flat.check_integrity() == [pid]
    after = ops._gathered_replica(parts, reg.device)
    if reg.slot_of(pid) in reg._wide:
        assert torch.equal(after, before)      # the host store changed
    else:
        assert int((after != before).sum()) == 1
        np.testing.assert_array_equal(after.numpy(), reg.cells_u8.numpy())


@pytest.mark.parametrize("shards", [None, 4])
def test_session_repairs_corrupted_row_from_peer(shards):
    """Over TCP: corrupt the staging row, run ONE verify_rows session,
    and the row is re-pulled from the peer's server."""
    m, k = 16, 3
    truth = np.arange(m, dtype=np.int64) * 3
    node = ft.ClockNode("peer", m, k)
    node.set_cells(truth)
    server = ft.ClockPeerServer(node).start()
    tp = ft.SocketTransport({"peer": server.address}, timeout=2.0)
    mesh = None if shards is None else make_fleet_mesh(shards, device=CPU)
    reg = TRegistry(4, m, k, mesh=mesh, device=CPU)
    try:
        cfg = GossipConfig(policy=TPolicy(fp_threshold=1.0),
                           straggler_gap=np.inf, verify_rows=True)
        _, rep0 = ft.anti_entropy_session(reg, tclock(np.zeros(m)), tp, cfg)
        assert rep0.corrupted == () and "peer" in reg

        tchaos.corrupt_registry_row(reg, "peer", seed=1)
        _, rep1 = ft.anti_entropy_session(reg, tclock(np.zeros(m)), tp, cfg)
        assert rep1.corrupted == ("peer",)
        assert rep1.repaired == ("peer",)
        assert "corrupted=1 repaired=1" in rep1.summary()
        np.testing.assert_array_equal(
            reg.get("peer").logical_cells().numpy(), truth)
        assert reg.check_integrity() == []
    finally:
        tp.close()
        server.stop()


# ---------------------------------------------------------------------------
# ingest: rejected frames, stale duplicates, the int32 wrap
# ---------------------------------------------------------------------------

def test_rejected_frame_skips_peer_not_round():
    """A fabric serving one damaged frame: the peer lands on
    ``GossipReport.rejected`` with an audit record, the others merge,
    and the reference reports the same."""
    def one_bad(base_cls, clock):
        tp = scripted(base_cls, clock)
        pull = tp.pull

        def bad_pull(peer_ids):
            frames, nbytes = pull(peer_ids)
            if "p0" in frames:
                frames["p0"] = frames["p0"][:9]     # truncated mid-header
            return frames, nbytes

        tp.pull = bad_pull
        return tp

    obs = Observer(audit=AuditTrail())
    tp = one_bad(Transport, tbc)
    reg = TRegistry(8, tp.m, 3, device=CPU)
    merged, report = ft.anti_entropy_session(reg, tclock(np.zeros(tp.m)), tp,
                                             audit_cfg(obs))
    jtp = one_bad(JTransport, jbc)
    jreg = JRegistry(capacity=8, m=jtp.m, k=3)
    jmerged, jreport = jft.anti_entropy_session(
        jreg, jclock(np.zeros(jtp.m)), jtp,
        JGossipConfig(policy=JPolicy(fp_threshold=1.0), straggler_gap=np.inf))
    assert report.rejected == jreport.rejected == ("p0",)
    assert "p0" not in reg and "p0" not in tp.have
    for pid in ("p1", "p2", "p3"):
        assert pid in reg
    assert report.n_accepted == jreport.n_accepted == 3
    assert report.delta_bytes == jreport.delta_bytes
    np.testing.assert_array_equal(merged.logical_cells().numpy(),
                                  np.asarray(jmerged.logical_cells()))
    assert [r.peer_id for r in obs.audit.records
            if r.kind == "frame_rejected"] == ["p0"]
    assert "rejected=1" in report.summary()


def test_duplicate_and_stale_ingest_is_idempotent():
    """§3 merge-on-ingest: re-delivering an OLD frame for a known peer
    never regresses the row, and the have key is the row held, so the
    next round pulls the peer again."""
    m = 16
    old = np.arange(m, dtype=np.int64)
    new = old + 5
    reg = TRegistry(4, m, 3, device=CPU)
    reg.admit("p", tclock(new))

    class Stale(Transport):
        name = "stale"
        authoritative = False

        def digests(self):
            self._begin_round()
            return {"p": wire.digest_of("p", old)}, 8

        def pull(self, peer_ids):
            f = wire.encode_clock(tbc.to_wire(tclock(old)))
            return {"p": f}, len(f)

        def push(self, peer_ids, frame):
            return 0

    tp = Stale()
    cfg = GossipConfig(policy=TPolicy(fp_threshold=1.0), straggler_gap=np.inf,
                       push_back=False)
    for _ in range(2):
        _, rep = ft.anti_entropy_session(reg, tclock(np.zeros(m)), tp, cfg)
        np.testing.assert_array_equal(reg.get("p").logical_cells().numpy(),
                                      new)
        assert tp.have["p"] == (wire.cells_crc(new), m)
        assert rep.delta_bytes > 0             # the stale key re-pulls


def test_registry_promotes_near_wrap_rows_and_unions_exactly():
    m = 16
    lo = np.full(m, INT32_MAX - 3, np.int64)
    hi = lo.copy()
    hi[::2] += 6                                  # wraps on even cells
    reg = TRegistry(4, m, 3, device=CPU)
    reg.admit_many({"lo": tclock(wrapped(lo)), "hi": tclock(wrapped(hi))})
    for pid in ("lo", "hi"):
        assert reg.slot_of(pid) in reg._wide, pid
        got = reg.get(pid).logical_cells().numpy().astype(np.int64)
        want = wrapped(lo if pid == "lo" else hi).astype(np.int64)
        assert (got == want).all()
    assert reg.check_integrity() == []
    mask = np.zeros(4, bool)
    mask[[reg.slot_of("lo"), reg.slot_of("hi")]] = True
    merged = reg.union(mask, tclock(wrapped(lo)))
    np.testing.assert_array_equal(merged.logical_cells().numpy(), wrapped(hi))
    view = reg.classify_all(tclock(wrapped(hi)))
    assert int(view.status[reg.slot_of("lo")]) == fr.ANCESTOR
    assert int(view.status[reg.slot_of("hi")]) == fr.SAME
    assert "wide_overlay" in view.engine          # exact rim, not the pack

    # the broadcast guard: a union row pushed near the wrap stays exact
    reg.admit("p", tclock(np.arange(m)))
    assert reg.slot_of("p") not in reg._wide
    pmask = np.zeros(4, bool)
    pmask[reg.slot_of("p")] = True
    reg.broadcast(pmask, tclock(wrapped(np.full(m, INT32_MAX - 1, np.int64))))
    assert reg.slot_of("p") in reg._wide
    assert reg.check_integrity() == []


def test_near_wrap_peers_gossip_over_sockets():
    """Peers served near the int32 wrap reach the staging registry
    through wire frames, promote to the exact rim, and the session's
    verdicts and union equal the reference's."""
    m, k = 16, 3
    rng = np.random.default_rng(4)
    base = np.full(m, INT32_MAX - 40, np.int64)
    rows = {"a": base + rng.integers(0, 20, m),
            "b": base + rng.integers(20, 80, m),       # crosses the wrap
            "c": rng.integers(0, 30, m)}
    local = base + 10
    servers, addrs, jaddrs, jservers = [], {}, {}, []
    try:
        for pid, row in rows.items():
            node = ft.ClockNode(pid, m, k)
            node.set_cells(row)
            servers.append(ft.ClockPeerServer(node).start())
            addrs[pid] = servers[-1].address
            jnode = jft.ClockNode(pid, m, k)
            jnode.set_cells(row)
            jservers.append(jft.ClockPeerServer(jnode).start())
            jaddrs[pid] = jservers[-1].address
        reg = TRegistry(4, m, k, device=CPU)
        merged, rep = ft.anti_entropy_session(
            reg, tclock(wrapped(local)), ft.SocketTransport(addrs, timeout=2.0),
            GossipConfig(policy=TPolicy(fp_threshold=1.0),
                         straggler_gap=np.inf, merge_forked=True))
        jreg = JRegistry(capacity=4, m=m, k=k)
        jmerged, jrep = jft.anti_entropy_session(
            jreg, jclock(wrapped(local)),
            jft.SocketTransport(jaddrs, timeout=2.0),
            JGossipConfig(policy=JPolicy(fp_threshold=1.0),
                          straggler_gap=np.inf, merge_forked=True))
    finally:
        ft.socket.stop_servers(servers)
        for s in jservers:
            s.stop()
    assert reg.slot_of("a") in reg._wide and reg.slot_of("b") in reg._wide
    np.testing.assert_array_equal(rep.view.status, jrep.view.status)
    np.testing.assert_array_equal(rep.accepted, jrep.accepted)
    np.testing.assert_array_equal(merged.logical_cells().numpy(),
                                  np.asarray(jmerged.logical_cells()))
    np.testing.assert_array_equal(reg.cells.numpy(), np.asarray(jreg.cells))
    assert "wide_overlay" in rep.view.engine
