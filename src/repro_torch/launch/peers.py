"""Process-level gossip peers: specs, a serving loop, and a smoke driver.

``PeerSpec`` / ``parse_peers`` turn ``"id@host:port,..."`` strings into
socket-transport peer tables — the launch-config surface for wiring a
trainer or serving replica into a multi-process gossip fleet.

As a module this is also the multi-process smoke driver:

    python -m repro_torch.launch.peers --smoke 3

spawns ``N-1`` real child processes, each serving its own clock over a
``ClockPeerServer`` on localhost TCP, then drives anti-entropy sessions
from the leader over a ``SocketTransport``.  The children's clocks are
constructed as strict causal prefixes of the leader's, so the paper's
§3 guarantee makes any quarantine a false negative; the driver asserts
zero of them, asserts the fleet converges (every peer's digest CRC
equals the merged union's), and asserts the second round's delta phase
is empty (converged peers cost digest bytes only).  Exit code 0 on
success.  The leader ticks its clock and holds its registry on
``--device`` (the card unless ``--device cpu``); every child serves a
host numpy ``ClockNode`` and computes its prefix clock on the CPU
(the driver passes it ``--device cpu``), which gives the same integer
cells as the card's tick.

Child mode (spawned by the driver, or by hand for ad-hoc fleets):

    python -m repro_torch.launch.peers --serve node1@127.0.0.1:0 \\
        --m 128 --k 3 --tick-prefix 40 --port-file node1.port --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

__all__ = ["PeerSpec", "parse_peers", "transport_from_specs"]


@dataclasses.dataclass(frozen=True)
class PeerSpec:
    peer_id: str
    host: str
    port: int

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    def __str__(self) -> str:
        return f"{self.peer_id}@{self.host}:{self.port}"


def parse_peers(spec: str) -> list[PeerSpec]:
    """Parse ``"id@host:port,id@host:port,..."`` into PeerSpecs."""
    out = []
    for part in filter(None, (s.strip() for s in spec.split(","))):
        try:
            pid, addr = part.split("@", 1)
            host, port = addr.rsplit(":", 1)
            # bracketed IPv6 ("[::1]:9002"): strip the brackets so the
            # host is directly connectable by socket.create_connection
            if host.startswith("[") and host.endswith("]"):
                host = host[1:-1]
            out.append(PeerSpec(pid, host, int(port)))
        except ValueError as e:
            raise ValueError(
                f"bad peer spec {part!r} (want id@host:port)") from e
    ids = [p.peer_id for p in out]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate peer ids in {spec!r}")
    return out


def transport_from_specs(specs, exclude: str | None = None,
                         timeout: float = 5.0):
    """SocketTransport over the given peers (minus ``exclude``, the
    caller's own id when the spec string lists the whole fleet)."""
    from repro_torch.fleet.transport import SocketTransport
    return SocketTransport(
        {p.peer_id: p.address for p in specs if p.peer_id != exclude},
        timeout=timeout)


def _ticked_clock(m: int, k: int, n_events: int, device):
    """Deterministic event prefix: every process ticking ``n`` events
    gets a clock that is a causal prefix of any process ticking more
    (on any device: the tick's cells are integers)."""
    from repro_torch.core import clock as bc
    c = bc.zeros(m, k, device=device)
    for e in range(n_events):
        c = bc.tick(c, e >> 32, e & 0xFFFFFFFF)
    return c


def _serve(args) -> int:
    from repro_torch.device import resolve_device
    from repro_torch.fleet.transport import ClockNode, ClockPeerServer
    spec = parse_peers(args.serve)[0]
    node = ClockNode(spec.peer_id, args.m, args.k)
    if args.tick_prefix:
        clock = _ticked_clock(args.m, args.k, args.tick_prefix,
                              resolve_device(args.device))
        node.set_cells(clock.logical_cells().cpu().numpy())
    server = ClockPeerServer(node, spec.host, spec.port).start()
    host, port = server.address
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{host}:{port}\n")
        os.replace(tmp, args.port_file)      # atomic: readers never see half
    print(f"[peer {spec.peer_id}] serving on {host}:{port} "
          f"(prefix={args.tick_prefix})", flush=True)
    try:
        while True:                          # until the driver kills us
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def _wait_port_file(path: str, child: subprocess.Popen,
                    timeout: float = 90.0) -> tuple[str, int]:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                host, port = f.read().strip().rsplit(":", 1)
            return host, int(port)
        if child.poll() is not None:
            raise RuntimeError(f"peer exited with code {child.returncode} "
                               f"before writing {path}")
        time.sleep(0.1)
    raise TimeoutError(f"peer never wrote {path}")


def _check_trace(obs, trace_dir: str, rounds: int, replay_policy,
                 device) -> list:
    """Post-run observability assertions for the smoke driver: the trace
    parses, every round produced one complete session span with its
    phase children, the Chrome export writes, and the audit trail's
    frame replay matches the live verdicts bit-for-bit."""
    import json

    from repro_torch.obs import export as obs_export

    failures = []
    obs.flush()
    spans = obs_export.load_spans(os.path.join(trace_dir, "trace.jsonl"))
    sessions = [s for s in spans if s["name"] == "gossip.session"]
    if len(sessions) != rounds:
        failures.append(
            f"trace has {len(sessions)} gossip.session spans, "
            f"expected one per round ({rounds})")
    for sess in sessions:
        kids = {s["name"] for s in spans if s["parent"] == sess["sid"]}
        missing = {"gossip.digest", "gossip.pull",
                   "gossip.classify"} - kids
        if missing:
            failures.append(
                f"session span {sess['sid']} missing phase children "
                f"{sorted(missing)}")
    names = {s["name"] for s in spans}
    for phase in ("gossip.digest", "gossip.pull", "gossip.classify",
                  "gossip.union", "gossip.push"):
        if phase not in names:
            failures.append(f"trace never recorded a {phase} span")
    chrome_path = os.path.join(trace_dir, "trace.chrome.json")
    with open(chrome_path, "w") as f:
        json.dump(obs_export.to_chrome(spans), f)
    replay = obs.audit.replay_frames(policy=replay_policy, device=device)
    if replay.checked == 0 or not replay.ok:
        failures.append(f"audit frame replay failed: {replay.summary()}")
    if not failures:
        print(f"[leader] trace OK: {len(spans)} spans, "
              f"{len(sessions)} sessions, chrome export at {chrome_path}; "
              f"audit {replay.summary()}", flush=True)
    return failures


def _child_env() -> dict:
    """The environment of a child process: this one's, with the port's
    ``src/`` directory first on ``PYTHONPATH`` so ``-m`` finds it."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    return {**os.environ,
            "PYTHONPATH": src + (os.pathsep + path if path else "")}


def _smoke(args) -> int:
    from repro_torch.causal import CausalPolicy
    from repro_torch.core import wire
    from repro_torch.device import resolve_device
    from repro_torch.fleet.gossip import GossipConfig
    from repro_torch.fleet.registry import ClockRegistry
    from repro_torch.fleet.transport import SocketTransport
    from repro_torch.fleet.transport.session import anti_entropy_session
    from repro_torch.obs import Observer

    n, m, k, events = args.smoke, args.m, args.k, args.events
    device = resolve_device(args.device)
    children, peers = [], {}
    tmpdir = tempfile.mkdtemp(prefix="gossip-peers-")
    env = _child_env()
    try:
        for i in range(1, n):
            pid = f"node{i}"
            port_file = os.path.join(tmpdir, f"{pid}.port")
            # strict prefixes of the leader's event sequence: every
            # peer is a true ancestor, so quarantine == false negative
            prefix = events * (n - i) // n
            children.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.peers",
                 "--serve", f"{pid}@127.0.0.1:0",
                 "--m", str(m), "--k", str(k),
                 "--tick-prefix", str(prefix), "--port-file", port_file,
                 "--device", "cpu"],
                env=env))
            peers[pid] = (port_file, children[-1])
        addresses = {pid: _wait_port_file(path, child)
                     for pid, (path, child) in peers.items()}
        print(f"[leader] {n - 1} peers up: "
              + " ".join(f"{pid}@{h}:{p}"
                         for pid, (h, p) in addresses.items()), flush=True)

        leader = _ticked_clock(m, k, events, device)
        policy = CausalPolicy(fp_threshold=1.0)
        obs = None
        if args.trace_dir:
            obs = Observer.to_dir(args.trace_dir)
            policy = dataclasses.replace(policy, observer=obs)
        registry = ClockRegistry(capacity=max(8, n), m=m, k=k,
                                 policy=policy, device=device)
        transport = SocketTransport(addresses, timeout=10.0)
        cfg = GossipConfig(policy=policy, straggler_gap=np.inf)

        reports = []
        merged = leader
        for r in range(args.rounds):
            merged, report = anti_entropy_session(
                registry, merged, transport, cfg)
            reports.append(report)
            print(f"[leader] round {r}: {report.summary()}", flush=True)

        failures = []
        if any(int(rep.quarantined.sum()) for rep in reports):
            failures.append(
                "false negative: a causally-ordered peer was quarantined")
        if int(reports[0].n_accepted) != n - 1:
            failures.append(
                f"round 0 accepted {reports[0].n_accepted}/{n - 1} peers")
        if reports[1].delta_bytes != 0:
            failures.append(
                f"round 1 re-pulled {reports[1].delta_bytes}B from "
                "converged peers (digest/delta skip broken)")
        digests, _ = transport.digests()
        union_crc = wire.cells_crc(merged.logical_cells().cpu().numpy())
        stragglers = {pid: d.crc for pid, d in digests.items()
                      if d.crc != union_crc}
        if stragglers:
            failures.append(f"fleet did not converge: {sorted(stragglers)} "
                            "disagree with the union")
        if obs is not None:
            failures.extend(_check_trace(
                obs, args.trace_dir, args.rounds,
                CausalPolicy(fp_threshold=1.0), device))
            obs.close()
        if failures:
            for f in failures:
                print(f"[leader] FAIL: {f}", flush=True)
            return 1
        wire_total = sum(rep.wire_bytes for rep in reports)
        print(f"[leader] OK: {n} processes converged in {args.rounds} "
              f"rounds, 0 false negatives, {wire_total}B measured on the "
              "wire", flush=True)
        return 0
    finally:
        for child in children:
            child.terminate()
        for child in children:
            try:
                child.wait(timeout=10)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
        shutil.rmtree(tmpdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--serve", type=str, default=None,
                    help="child mode: serve one peer, id@host:port")
    ap.add_argument("--smoke", type=int, default=None, metavar="N",
                    help="driver mode: spawn N-1 peer processes and run "
                         "anti-entropy sessions from the leader")
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--events", type=int, default=48,
                    help="leader event count (children tick prefixes)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--tick-prefix", type=int, default=0,
                    help="child mode: tick this causal event prefix")
    ap.add_argument("--port-file", type=str, default=None,
                    help="child mode: write the bound host:port here")
    ap.add_argument("--device", type=str, default=None,
                    help="where the clock ticks and the leader's registry "
                         "lives (default: the card)")
    ap.add_argument("--trace-dir", type=str, default=None,
                    help="driver mode: record spans/metrics/audit under "
                         "this directory and assert the trace is complete "
                         "(trace.jsonl, trace.chrome.json, metrics.json, "
                         "audit.jsonl)")
    args = ap.parse_args(argv)
    if (args.serve is None) == (args.smoke is None):
        ap.error("pick exactly one of --serve / --smoke")
    if args.smoke is not None and args.rounds < 2:
        ap.error("--smoke needs --rounds >= 2 (round 1 asserts the "
                 "converged fleet's delta phase is empty)")
    return _serve(args) if args.serve else _smoke(args)


if __name__ == "__main__":
    sys.exit(main())
