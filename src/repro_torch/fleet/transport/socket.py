"""SocketTransport: anti-entropy over TCP between real processes.

The multi-host deployment of the gossip fabric.  Every participating
process runs a :class:`ClockPeerServer` — a tiny threaded TCP server
answering three requests about ONE node's clock — and a session on any
node reaches its peers through a :class:`SocketTransport` holding their
addresses.  All clock payloads are ``core.wire`` frames (§4 u8
residuals + base, versioned header, CRC trailer), so a truncated or
corrupted byte stream is rejected at decode, never merged.

Message envelope (both directions):

    bytes 0-3   payload length, u32
    byte  4     protocol version (1)
    byte  5     message type
    ...         payload

Types: ``DIGEST`` (empty -> digest frame), ``PULL`` (empty -> clock
frame), ``PUSH`` (clock frame -> 1-byte ack; the server merges the
union into its node, the §3 receive rule), ``ERR`` (utf-8 reason).

:class:`ClockNode` is the host-side clock state a server exposes: plain
numpy + a lock, never torch, so server threads do no device work to
answer a request and never touch a CUDA tensor.  Sessions stay
pull-driven and idempotent — a node that crashes and restarts
re-converges from digests alone.
"""
from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core import wire
from repro_torch.fleet.transport.base import Transport

__all__ = ["ClockNode", "ClockPeerServer", "PeerRejected",
           "SocketTransport", "TransportError", "stop_servers"]

PROTO_VERSION = 1
MSG_DIGEST, MSG_PULL, MSG_PUSH, MSG_ACK, MSG_ERR = 1, 2, 3, 4, 255

_ENVELOPE = struct.Struct("!IBB")
_MAX_PAYLOAD = 64 * 1024 * 1024


class TransportError(RuntimeError):
    """A peer answered with an error or spoke a different protocol."""


class PeerRejected(TransportError):
    """The peer is ALIVE and explicitly refused the request (an
    ``MSG_ERR`` answer — e.g. a corrupted or wrong-shape frame we
    pushed).  Never treated as unreachability: the frame is our bug,
    so sessions let it propagate instead of skip-and-report."""


def _recv_exact(sock: socket.socket, n: int,
                deadline: float | None = None) -> bytes:
    """Read exactly ``n`` bytes, bounded by an absolute ``deadline``.

    A per-recv socket timeout alone does NOT bound a whole message: a
    peer that accepts the connection and then trickles one byte per
    almost-timeout (or stalls mid-frame after the header) resets the
    clock on every chunk, so the caller could block for ~n × timeout.
    With a deadline (``time.monotonic()`` instant), the remaining budget
    shrinks as chunks arrive and a mid-frame stall raises
    ``socket.timeout`` — an ``OSError`` the transport's skip-and-report
    path turns into an ``unreachable`` entry, never a dead round.
    """
    buf = bytearray()
    while len(buf) < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout(
                    f"message deadline exhausted mid-frame "
                    f"({len(buf)}/{n} bytes)")
            sock.settimeout(remaining)
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TransportError(
                f"connection closed mid-message ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def _send_msg(sock: socket.socket, msg_type: int, payload: bytes = b"") -> None:
    sock.sendall(_ENVELOPE.pack(len(payload), PROTO_VERSION, msg_type)
                 + payload)


def _recv_msg(sock: socket.socket,
              deadline: float | None = None) -> tuple[int, bytes]:
    length, version, msg_type = _ENVELOPE.unpack(
        _recv_exact(sock, _ENVELOPE.size, deadline))
    if version != PROTO_VERSION:
        raise TransportError(
            f"peer speaks protocol version {version}, "
            f"this build speaks {PROTO_VERSION}")
    if length > _MAX_PAYLOAD:
        raise TransportError(f"refusing {length}-byte payload "
                             f"(cap {_MAX_PAYLOAD})")
    return msg_type, _recv_exact(sock, length, deadline)


class ClockNode:
    """One process's servable clock state: numpy cells + a lock.

    The owning process mutates it (``set_cells`` from its runtime clock,
    or inbound ``merge_snapshot`` applied by its server thread); any
    peer's session reads it through digest / snapshot requests.
    """

    def __init__(self, peer_id: str, m: int, k: int = 4):
        self.peer_id = str(peer_id)
        self.m = int(m)
        self.k = int(k)
        self._cells = np.zeros(m, np.int64)      # logical cells, base 0
        self._lock = threading.Lock()

    def set_cells(self, cells) -> None:
        cells = np.asarray(cells, np.int64)
        assert cells.shape == (self.m,), (cells.shape, self.m)
        with self._lock:
            self._cells = cells.copy()

    def cells(self) -> np.ndarray:
        with self._lock:
            return self._cells.copy()

    def merge_snapshot(self, snap: dict) -> None:
        """§3 receive rule: element-wise max with an inbound wire row."""
        inbound = (np.asarray(snap["cells"], np.int64)
                   + int(snap["base"]))
        if inbound.shape != (self.m,):
            raise wire.WireFormatError(
                f"frame carries m={inbound.shape[0]} cells, "
                f"node {self.peer_id!r} has m={self.m}")
        with self._lock:
            np.maximum(self._cells, inbound, out=self._cells)

    def snapshot(self) -> dict:
        """§4 wire form of the current cells (u8 residuals when the
        window fits a byte, int32 otherwise) — ``core.clock.to_wire``
        semantics without touching a device."""
        cells = self.cells()
        base = int(cells.min()) if cells.size else 0
        resid = cells - base
        if resid.max(initial=0) <= 255:
            out = resid.astype(np.uint8)
        else:
            out = resid.astype(np.int32)
        return {"cells": out, "base": base, "k": self.k}

    def digest(self) -> wire.ClockDigest:
        return wire.digest_of(self.peer_id, self.cells(), 0, self.k)


class _Handler(socketserver.BaseRequestHandler):
    #: per-request budget: a client that connects and stalls mid-frame
    #: (or never sends) releases its daemon thread instead of pinning it
    request_timeout = 30.0

    def handle(self):
        node: ClockNode = self.server.node    # type: ignore[attr-defined]
        try:
            self.request.settimeout(self.request_timeout)
            msg_type, payload = _recv_msg(
                self.request, time.monotonic() + self.request_timeout)
            if msg_type == MSG_DIGEST:
                _send_msg(self.request, MSG_DIGEST,
                          wire.encode_digest(node.digest()))
            elif msg_type == MSG_PULL:
                _send_msg(self.request, MSG_PULL,
                          wire.encode_clock(node.snapshot()))
            elif msg_type == MSG_PUSH:
                node.merge_snapshot(wire.decode_clock(payload))
                _send_msg(self.request, MSG_ACK, b"\x01")
            else:
                _send_msg(self.request, MSG_ERR,
                          f"unknown message type {msg_type}".encode())
        except socket.timeout:
            pass          # stalled client: drop it, free the thread
        except (wire.WireFormatError, TransportError) as e:
            try:
                _send_msg(self.request, MSG_ERR, str(e).encode())
            except OSError:
                pass


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ClockPeerServer:
    """Threaded TCP server exposing one ``ClockNode`` to the fleet."""

    def __init__(self, node: ClockNode, host: str = "127.0.0.1",
                 port: int = 0):
        self.node = node
        self._server = _Server((host, port), _Handler)
        self._server.node = node              # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"clock-peer-{node.peer_id}")

    @property
    def address(self) -> tuple[str, int]:
        return self._server.server_address[:2]

    def start(self) -> "ClockPeerServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def stop_servers(servers) -> None:
    """Stop many servers at once: each ``stop`` waits up to one poll
    interval (0.5 s) for its serving thread to notice, so a fleet of
    them waits together instead of in turn."""
    servers = list(servers)
    if not servers:
        return
    with ThreadPoolExecutor(max_workers=min(len(servers), 64)) as ex:
        for fut in [ex.submit(s.stop) for s in servers]:
            fut.result()


class SocketTransport(Transport):
    """Reach a fleet of ``ClockPeerServer`` processes over TCP.

    ``peers`` maps peer_id -> (host, port).  Connections are
    per-request (the payloads are one frame each); ``timeout`` guards
    every socket operation so a hung peer cannot stall the session.

    Unreachable peers are **skipped and reported**, not fatal: a
    connection-level failure on one peer (connect refused, timeout,
    closed mid-message, version/type confusion) records it (with the
    error) in ``self.unreachable`` and the phase continues with the
    remaining peers — a dead peer costs its timeout, never the round.
    An explicit ``MSG_ERR`` rejection (:class:`PeerRejected` — the peer
    is alive and says OUR frame is bad) still raises.
    ``unreachable`` resets at the next ``digests()`` call, so each
    session sees only its own round's skips; the session protocol turns
    the entries into ``peer_unreachable`` audit/metric events and
    surfaces them on ``GossipReport.unreachable``.
    """

    name = "socket"
    authoritative = False

    def __init__(self, peers: dict, timeout: float = 5.0):
        super().__init__()
        self.peers = {str(pid): tuple(addr) for pid, addr in peers.items()}
        self.timeout = timeout

    def _mark_unreachable(self, pid: str, err: Exception) -> None:
        self.unreachable[pid] = f"{type(err).__name__}: {err}"

    def _request(self, pid: str, msg_type: int,
                 payload: bytes = b"") -> bytes:
        host, port = self.peers[pid]
        # one absolute deadline for the WHOLE reply: a peer that accepts
        # then stalls (or trickles) mid-frame times out within ~timeout
        # total, not per-recv-chunk
        deadline = time.monotonic() + self.timeout
        with socket.create_connection((host, port),
                                      timeout=self.timeout) as sock:
            _send_msg(sock, msg_type, payload)
            kind, reply = _recv_msg(sock, deadline)
        if kind == MSG_ERR:
            raise PeerRejected(
                f"peer {pid!r} at {host}:{port} rejected the request: "
                f"{reply.decode(errors='replace')}")
        if kind != msg_type and not (msg_type == MSG_PUSH
                                     and kind == MSG_ACK):
            raise TransportError(
                f"peer {pid!r} answered type {kind} to a {msg_type} request")
        return reply

    def digests(self) -> tuple[dict[str, wire.ClockDigest], int]:
        self._begin_round()        # fresh skip list per session round
        digs, nbytes = {}, 0
        for pid in self.peers:
            try:
                reply = self._request(pid, MSG_DIGEST)
                digs[pid] = wire.decode_digest(reply)
                nbytes += len(reply)
            except PeerRejected:
                raise
            except (OSError, wire.WireFormatError, TransportError) as e:
                self._mark_unreachable(pid, e)
        return digs, nbytes

    def pull(self, peer_ids) -> tuple[dict[str, bytes], int]:
        frames, nbytes = {}, 0
        for pid in peer_ids:
            if pid in self.unreachable:
                continue
            try:
                frame = self._request(pid, MSG_PULL)
                frames[pid] = frame
                nbytes += len(frame)
            except PeerRejected:
                raise
            except (OSError, TransportError) as e:
                self._mark_unreachable(pid, e)
        return frames, nbytes

    def push(self, peer_ids, frame: bytes) -> int:
        sent = 0
        for pid in peer_ids:
            if pid in self.unreachable:
                continue
            try:
                self._request(pid, MSG_PUSH, frame)
                sent += len(frame)     # counted only on ack'd delivery
            except PeerRejected:
                raise
            except (OSError, TransportError) as e:
                self._mark_unreachable(pid, e)
        return sent
