"""The port's socket transport, delta-pull session and peer launcher
surface against the JAX package's (``tests/test_transport.py``'s socket,
runtime and launch cases), on the CPU.

- wire: the port's ``ClockNode`` snapshot and digest frames, and the
  envelope, byte-identical to the reference's for u8 and int32 windows;
- cross-framework: a port session against JAX ``ClockPeerServer``s and a
  JAX session against port servers give the same-framework reports, and
  both fleets converge (a torch peer and a JAX peer gossip over TCP);
- the reference's socket cases in the port: decisions equal loopback's,
  the second round skips converged peers, damaged or wrong-m pushes are
  refused, the socket sim's counts equal the reference's,
  ``ClockRuntime.gossip`` over sockets, ``parse_peers``, the
  ``fp_threshold`` shim, and a mid-frame staller landing in
  ``unreachable`` within about one timeout.

Every socket here is bounded: transport timeouts of 1-5 s, servers
stopped in ``finally`` or a fixture.  Tolerances: masks, statuses,
merged cells, registry rows and wire bytes identical; fp bit-identical
within the port and within a relative 5e-2 of the reference (values at
or below the 1e-30 clip floor count as equal).
"""
import dataclasses
import socket as pysock
import threading
import time
import warnings

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
from repro.fleet import anti_entropy_session as jsession  # noqa: E402
from repro.fleet.transport import socket as jsock  # noqa: E402
from repro.launch.peers import parse_peers as jparse_peers  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.causal import CausalPolicy as TPolicy  # noqa: E402
from repro_torch.core import clock as tbc  # noqa: E402
from repro_torch.core import wire  # noqa: E402
from repro_torch.core.sim import SimConfig, run_gossip_sim  # noqa: E402
from repro_torch.fleet import ClockRegistry as TRegistry  # noqa: E402
from repro_torch.fleet import GossipConfig  # noqa: E402
from repro_torch.fleet import gossip_round  # noqa: E402
from repro_torch.fleet.transport import anti_entropy_session  # noqa: E402
from repro_torch.fleet.transport import socket as tsock  # noqa: E402
from repro_torch.launch.peers import PeerSpec, parse_peers  # noqa: E402
from repro_torch.runtime.clock_runtime import ClockConfig, ClockRuntime  # noqa: E402

CAP, M, K = 8, 128, 3
FP_RTOL = 5e-2
FP_FLOOR = 1e-30
CPU = "cpu"
I32_MAX = 2 ** 31 - 1

TCFG = GossipConfig(policy=TPolicy(fp_threshold=1.0))
JCFG = JGossipConfig(policy=JPolicy(fp_threshold=1.0))
MASKS = ("accepted", "quarantined", "stragglers", "unconfident")


def assert_fp_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    keep = ~((a == b) | ((np.abs(a) <= FP_FLOOR) & (np.abs(b) <= FP_FLOOR)))
    np.testing.assert_allclose(a[keep], b[keep], rtol=FP_RTOL, atol=0)


def _ticked(c, events):
    for e in events:
        c = jbc.tick(c, jnp.uint32(e >> 32), jnp.uint32(e & 0xFFFFFFFF))
    return c


def fixture_rows(seed: int = 0) -> tuple[dict, np.ndarray]:
    """The reference fixture's rows (every status kind, a laggard and a
    promoted row) as numpy logical cells, and the local clock's."""
    rng = np.random.default_rng(seed)
    local = _ticked(jbc.zeros(M, K), range(30))
    wide = np.zeros(M, np.int64)
    wide[3] = 700                      # span > 255: promoted row
    rows = {
        "anc": _ticked(jbc.zeros(M, K), range(12)),
        "same": local,
        "desc": _ticked(local, range(200, 208)),
        "fork": _ticked(jbc.zeros(M, K), range(900, 912)),
        "lag": _ticked(jbc.zeros(M, K), range(2)),
        "wide": wide,
        "rand": rng.integers(0, 6, M),
    }
    cells = {pid: np.asarray(r.logical_cells() if hasattr(r, "logical_cells")
                             else r, np.int64) for pid, r in rows.items()}
    return cells, np.asarray(local.logical_cells(), np.int64)


def tclock(row) -> tbc.BloomClock:
    return tbc.BloomClock(torch.as_tensor(np.asarray(row, np.int32)),
                          torch.zeros((), dtype=torch.int32), K)


def jclock(row) -> jbc.BloomClock:
    return jbc.BloomClock(jnp.asarray(np.asarray(row), jnp.int32),
                          jnp.zeros((), jnp.int32), K)


class Fleet:
    """One ``ClockPeerServer`` a row, of the port (``mod=tsock``) or of
    the JAX package (``mod=jsock``), on 127.0.0.1."""

    def __init__(self, mod, rows: dict, m: int = M, k: int = K):
        self.nodes, self.servers = {}, []
        try:
            for pid, row in rows.items():
                node = mod.ClockNode(pid, m, k)
                node.set_cells(row)
                self.servers.append(mod.ClockPeerServer(node).start())
                self.nodes[pid] = node
        except BaseException:
            self.stop()
            raise
        self.addresses = {pid: s.address
                          for pid, s in zip(self.nodes, self.servers)}

    def stop(self) -> None:
        tsock.stop_servers(self.servers)


@pytest.fixture
def port_fleet():
    rows, local = fixture_rows()
    fleet = Fleet(tsock, rows)
    yield rows, local, fleet
    fleet.stop()


# ---------------------------------------------------------------------------
# wire: frames and envelopes byte-identical to the reference's
# ---------------------------------------------------------------------------

def node_cells(kind: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    if kind == "u8":
        return rng.integers(40, 290, M)            # window 250 < 256
    if kind == "i32":
        cells = rng.integers(0, 40, M)
        cells[7] = 70_000                          # window past a byte
        return cells
    if kind == "near_wrap":
        return I32_MAX - 300 + rng.integers(0, 200, M)
    if kind == "past_wrap":                        # int64 cells past INT32_MAX
        return I32_MAX + rng.integers(1, 200, M)
    return np.zeros(M, np.int64)


@pytest.mark.parametrize("kind", ["u8", "i32", "near_wrap", "past_wrap",
                                  "zeros"])
def test_clock_node_frames_byte_identical(kind):
    cells = node_cells(kind)
    t, j = tsock.ClockNode("peer-7", M, K), jsock.ClockNode("peer-7", M, K)
    t.set_cells(cells)
    j.set_cells(cells)
    ts, js = t.snapshot(), j.snapshot()
    assert ts["cells"].dtype == js["cells"].dtype
    assert ts["cells"].dtype == (np.int32 if kind == "i32" else np.uint8)
    assert wire.encode_clock(ts) == jsock.wire.encode_clock(js)
    assert (wire.encode_digest(t.digest())
            == jsock.wire.encode_digest(j.digest()))
    assert dataclasses.astuple(t.digest()) == dataclasses.astuple(j.digest())
    # the §3 receive rule on an inbound frame agrees too
    inbound = wire.encode_clock(tbc.to_wire(tclock(np.arange(M) * 3)))
    t.merge_snapshot(wire.decode_clock(inbound))
    j.merge_snapshot(jsock.wire.decode_clock(inbound))
    np.testing.assert_array_equal(t.cells(), j.cells())


def test_envelope_and_protocol_constants_match():
    assert tsock._ENVELOPE.format == jsock._ENVELOPE.format == "!IBB"
    assert tsock.PROTO_VERSION == jsock.PROTO_VERSION == 1
    assert tsock._MAX_PAYLOAD == jsock._MAX_PAYLOAD == 64 * 1024 * 1024
    assert ((tsock.MSG_DIGEST, tsock.MSG_PULL, tsock.MSG_PUSH, tsock.MSG_ACK,
             tsock.MSG_ERR)
            == (jsock.MSG_DIGEST, jsock.MSG_PULL, jsock.MSG_PUSH,
                jsock.MSG_ACK, jsock.MSG_ERR))
    for name in ("ClockNode", "ClockPeerServer", "SocketTransport",
                 "TransportError"):
        assert name in tfleet.__all__ and name in tfleet.transport.__all__
    assert issubclass(tsock.PeerRejected, tfleet.TransportError)


def test_server_refuses_other_protocol_version():
    """A request in another protocol version gets an ERR answer; the
    transport reports a peer that answers in one as unreachable."""
    node = tsock.ClockNode("p", 16, K)
    server = tsock.ClockPeerServer(node).start()
    try:
        with pysock.create_connection(server.address, timeout=2.0) as s:
            s.sendall(tsock._ENVELOPE.pack(0, 9, tsock.MSG_DIGEST))
            kind, reply = tsock._recv_msg(s, time.monotonic() + 2.0)
        assert kind == tsock.MSG_ERR and b"version 9" in reply
        with pysock.create_connection(server.address, timeout=2.0) as s:
            s.sendall(tsock._ENVELOPE.pack(0, 1, 77))
            kind, reply = tsock._recv_msg(s, time.monotonic() + 2.0)
        assert kind == tsock.MSG_ERR and b"unknown message type 77" in reply
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# cross-framework: port sessions against JAX servers and back
# ---------------------------------------------------------------------------

def port_run(addresses, local) -> tuple:
    reg = TRegistry(CAP, M, K, device=CPU)
    tp = tsock.SocketTransport(addresses, timeout=5.0)
    m1, r1 = anti_entropy_session(reg, tclock(local), tp, TCFG)
    m2, r2 = anti_entropy_session(reg, m1, tp, TCFG)
    return (reg.cells.numpy(), [m1.logical_cells().numpy(),
                                m2.logical_cells().numpy()], [r1, r2],
            dict(tp.have), reg.peer_ids())


def jax_run(addresses, local) -> tuple:
    reg = JRegistry(capacity=CAP, m=M, k=K)
    tp = jsock.SocketTransport(addresses, timeout=5.0)
    m1, r1 = jsession(reg, jclock(local), tp, JCFG)
    m2, r2 = jsession(reg, m1, tp, JCFG)
    return (np.asarray(reg.cells), [np.asarray(m1.logical_cells()),
                                    np.asarray(m2.logical_cells())], [r1, r2],
            dict(tp.have), reg.peer_ids())


def same_runs(got: tuple, want: tuple, what: str) -> None:
    cells, merged, reports, have, pids = got
    wcells, wmerged, wreports, whave, wpids = want
    assert pids == wpids, what
    np.testing.assert_array_equal(cells, wcells, err_msg=what)
    for a, b in zip(merged, wmerged):
        np.testing.assert_array_equal(a, b, err_msg=what)
    assert have == whave, what
    for r, w in zip(reports, wreports):
        for mask in MASKS:
            np.testing.assert_array_equal(getattr(r, mask), getattr(w, mask),
                                          err_msg=f"{what}: {mask}")
        np.testing.assert_array_equal(r.view.status, w.view.status)
        assert_fp_close(r.view.fp, np.asarray(w.view.fp))
        assert (r.digest_bytes, r.delta_bytes, r.pushback_bytes) == \
            (w.digest_bytes, w.delta_bytes, w.pushback_bytes), what
        assert r.transport == w.transport == "socket"
        assert r.unreachable == w.unreachable == ()


@pytest.fixture(scope="module")
def same_framework_runs():
    """Two rounds of each package's session against its own servers."""
    rows, local = fixture_rows()
    runs = {}
    for name, mod in (("jax", jsock), ("port", tsock)):
        fleet = Fleet(mod, rows)
        try:
            runs[name] = (port_run if name == "port" else jax_run)(
                fleet.addresses, local)
        finally:
            fleet.stop()
    same_runs(runs["port"], runs["jax"], "port vs JAX, same framework")
    return runs


@pytest.mark.parametrize("serving", ["jax", "port"])
def test_cross_framework_sessions_match_and_converge(serving,
                                                     same_framework_runs):
    """A port session against JAX servers (or a JAX session against port
    servers) gives the same-framework runs' reports, bytes, merged
    cells, registry rows and ``have`` keys; in both the fleet converges:
    the second round pulls nothing and every accepted peer's digest is
    the union's."""
    rows, local = fixture_rows()
    same_fw = same_framework_runs
    fleet = Fleet(jsock if serving == "jax" else tsock, rows)
    try:
        client = port_run if serving == "jax" else jax_run
        got = client(fleet.addresses, local)
        same_runs(got, same_fw["port" if serving == "jax" else "jax"],
                  f"{serving} servers, cross-framework client")
        _, merged, reports, _, _ = got
        assert reports[0].delta_bytes > 0 and reports[1].delta_bytes == 0
        union_crc = wire.cells_crc(merged[-1])
        accepted = {pid for pid in rows
                    if reports[-1].accepted[got[4].index(pid)]}
        assert accepted, "no peer accepted"
        for pid in accepted:
            assert wire.cells_crc(fleet.nodes[pid].cells()) == union_crc, pid
    finally:
        fleet.stop()


# ---------------------------------------------------------------------------
# the reference's socket cases, in the port
# ---------------------------------------------------------------------------

def test_socket_session_matches_loopback_decisions(port_fleet):
    rows, local, fleet = port_fleet
    loop_reg = TRegistry(CAP, M, K, device=CPU)
    loop_reg.admit_many({pid: tclock(r) for pid, r in rows.items()})
    m_ref, r_ref = gossip_round(loop_reg, tclock(local), TCFG)

    sock_reg = TRegistry(CAP, M, K, device=CPU)
    tp = tsock.SocketTransport(fleet.addresses, timeout=5.0)
    m_got, r_got = anti_entropy_session(sock_reg, tclock(local), tp, TCFG)

    assert r_got.transport == "socket"
    assert r_got.digest_bytes > 0 and r_got.delta_bytes > 0
    for pid in rows:
        rs, gs = loop_reg.slot_of(pid), sock_reg.slot_of(pid)
        assert r_ref.view.status[rs] == r_got.view.status[gs], pid
        assert r_ref.view.fp[rs] == r_got.view.fp[gs], pid
        assert r_ref.accepted[rs] == r_got.accepted[gs], pid
        assert r_ref.quarantined[rs] == r_got.quarantined[gs], pid
    np.testing.assert_array_equal(m_got.logical_cells().numpy(),
                                  m_ref.logical_cells().numpy())
    # push-back physically reached the accepted peers' servers
    for pid in rows:
        if r_got.accepted[sock_reg.slot_of(pid)]:
            np.testing.assert_array_equal(
                fleet.nodes[pid].cells(), m_got.logical_cells().numpy(), pid)


def test_socket_second_round_skips_converged_peers(port_fleet):
    rows, local, fleet = port_fleet
    reg = TRegistry(CAP, M, K, device=CPU)
    tp = tsock.SocketTransport(fleet.addresses, timeout=5.0)
    merged, first = anti_entropy_session(reg, tclock(local), tp, TCFG)
    assert first.delta_bytes > 0
    # every have key equals the key its server now advertises
    for pid, node in fleet.nodes.items():
        assert tp.have[pid] == node.digest().key, pid
    merged2, second = anti_entropy_session(reg, merged, tp, TCFG)
    assert second.delta_bytes == 0
    assert second.digest_bytes == first.digest_bytes
    np.testing.assert_array_equal(merged2.logical_cells().numpy(),
                                  merged.logical_cells().numpy())


def test_socket_rejects_corrupted_push(port_fleet):
    rows, local, fleet = port_fleet
    tp = tsock.SocketTransport(fleet.addresses, timeout=5.0)
    frame = bytearray(wire.encode_clock(tbc.to_wire(tclock(local))))
    frame[18] ^= 0xFF
    before = fleet.nodes["anc"].cells()
    with pytest.raises(tsock.PeerRejected, match="CRC32 mismatch"):
        tp.push(["anc"], bytes(frame))
    np.testing.assert_array_equal(fleet.nodes["anc"].cells(), before)


def test_socket_rejects_wrong_m_push(port_fleet):
    rows, local, fleet = port_fleet
    tp = tsock.SocketTransport(fleet.addresses, timeout=5.0)
    wrong = wire.encode_clock(tbc.to_wire(tbc.zeros(32, K)))
    with pytest.raises(tfleet.TransportError, match="m=32"):
        tp.push(["anc"], wrong)


def test_dead_peer_is_skipped_and_reported():
    """A refused connection costs the peer, not the round."""
    rows, local = fixture_rows()
    fleet = Fleet(tsock, {"anc": rows["anc"]})
    spare = pysock.socket()
    spare.bind(("127.0.0.1", 0))
    dead = spare.getsockname()
    spare.close()                      # nobody listens there now
    tp = tsock.SocketTransport({"anc": fleet.addresses["anc"],
                                "dead": dead}, timeout=1.0)
    try:
        reg = TRegistry(CAP, M, K, device=CPU)
        _, rep = anti_entropy_session(reg, tclock(local), tp, TCFG)
        assert rep.unreachable == ("dead",) and "dead" not in reg
        assert rep.n_accepted == 1 and "unreachable=1" in rep.summary()
    finally:
        fleet.stop()


@pytest.mark.parametrize("seed", [3, 11])
def test_gossip_sim_socket_transport_matches_reference(seed):
    cfg = dict(n_nodes=5, n_events=120, m=64, k=3, seed=seed)
    r = run_gossip_sim(SimConfig(**cfg), n_rounds=4, transport="socket",
                       device=CPU)
    j = jrun_gossip_sim(JSimConfig(**cfg), n_rounds=4, transport="socket")
    assert r.transport == j.transport == "socket"
    assert r.false_negatives == 0 and r.within_eq3_band
    assert r.digest_bytes > 0 and r.delta_bytes > 0
    assert r.wire_bytes == r.digest_bytes + r.delta_bytes + r.pushback_bytes
    for key in ("rounds", "false_negatives", "claims", "false_positives",
                "merges", "quarantines", "digest_bytes", "delta_bytes",
                "pushback_bytes", "within_eq3_band", "converged",
                "fault_events", "rejected_frames", "corrupted", "repaired"):
        assert getattr(r, key) == getattr(j, key), key
    assert_fp_close([r.mean_predicted_fp], [j.mean_predicted_fp])


def test_clock_runtime_gossip_over_socket(port_fleet):
    rows, local, fleet = port_fleet
    rt = ClockRuntime(ClockConfig(m=M, k=K, policy=TPolicy(fp_threshold=1.0)),
                      device=CPU)
    rt.clock = tclock(local)
    reg = rt.make_registry(CAP)
    report = rt.gossip(reg, transport=tsock.SocketTransport(fleet.addresses,
                                                            timeout=5.0))
    assert report.transport == "socket"
    assert report.n_accepted > 0
    for pid in rows:
        if report.accepted[reg.slot_of(pid)]:
            assert bool(tbc.ordering(tclock(rows[pid]), rt.clock).a_le_b)


@pytest.mark.parametrize("spec", [
    "a@127.0.0.1:9001, b@[::1]:9002",
    "x@host.example:1,,y@10.0.0.2:65535",
    "nope",
    "a@h:1,a@h:2",
    "a@h:port",
])
def test_peer_spec_parsing_matches_reference(spec):
    try:
        want = [(p.peer_id, p.host, p.port, str(p), p.address)
                for p in jparse_peers(spec)]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_peers(spec)
        assert str(got.value) == str(e)
        return
    got = [(p.peer_id, p.host, p.port, str(p), p.address)
           for p in parse_peers(spec)]
    assert got == want
    if spec.startswith("a@127"):
        assert parse_peers(spec)[1] == PeerSpec("b", "::1", 9002)


def test_gossip_config_scalar_shim_warns_once_per_construction():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg = GossipConfig()                      # defaults: silent
        assert not caught
        legacy = GossipConfig(fp_threshold=0.5)   # explicit scalar: warns
    assert [w.category for w in caught] == [DeprecationWarning]
    assert cfg.fp_gate == 1e-4 and legacy.fp_gate == 0.5
    assert dataclasses.replace(TCFG, straggler_gap=1.0).fp_gate == 1.0
    assert [f.name for f in dataclasses.fields(GossipConfig)] == \
        [f.name for f in dataclasses.fields(JGossipConfig)]


# ---------------------------------------------------------------------------
# liveness: mid-frame stallers cannot pin a session
# ---------------------------------------------------------------------------

def hostile_listener(behavior):
    """TCP listener that accepts, reads the request, then misbehaves."""
    srv = pysock.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    srv.settimeout(0.2)
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except (pysock.timeout, OSError):
                continue
            with conn:
                try:
                    conn.recv(64)
                    behavior(conn, stop)
                except OSError:
                    pass

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    return srv, stop, th


@pytest.mark.parametrize("mode", ["stall", "trickle"])
def test_midframe_staller_lands_in_unreachable(mode):
    def stall(conn, stop):
        conn.sendall(b"\x00\x00")                 # 2 of 6 envelope bytes
        stop.wait(8.0)

    def trickle(conn, stop):
        for byte in b"\x00\x00\x00\x20\x01\x01" + b"\x00" * 32:
            if stop.wait(0.3):
                return
            conn.sendall(bytes([byte]))

    srv, stop, th = hostile_listener(stall if mode == "stall" else trickle)
    node = tsock.ClockNode("good", 16, K)
    node.set_cells(np.arange(16))
    server = tsock.ClockPeerServer(node).start()
    tp = tsock.SocketTransport({"good": server.address,
                                "bad": srv.getsockname()}, timeout=1.0)
    reg = TRegistry(4, 16, K, device=CPU)
    try:
        t0 = time.monotonic()
        _, report = anti_entropy_session(
            reg, tbc.zeros(16, K), tp,
            GossipConfig(policy=TPolicy(fp_threshold=1.0),
                         straggler_gap=np.inf))
        elapsed = time.monotonic() - t0
        assert report.unreachable == ("bad",)
        assert "time" in tp.unreachable["bad"].lower()
        assert "good" in reg and report.n_accepted == 1
        assert elapsed < 5.0, f"session pinned for {elapsed:.1f}s"
    finally:
        stop.set()
        tp.close()
        server.stop()
        srv.close()
        th.join(timeout=2.0)
    assert not th.is_alive()
