"""The Transport interface anti-entropy sessions are parameterized by.

A transport answers three questions for one node's gossip session:

- ``digests()``   — who are my peers and what is each one's content key;
- ``pull(ids)``   — encoded §4 wire frames for the peers whose digest
  no longer matches what this node ingested;
- ``push(ids, frame)`` — ship the merged union row to accepted peers.

Every method returns MEASURED byte counts.  An ``authoritative``
transport (loopback, mesh-collective) holds the peer rows in the
session's own registry slab, so there is nothing to pull.  The socket
transport is not: the session's registry is a staging replica of
remote processes, kept in sync by digest and delta pull.
"""
from __future__ import annotations

import abc

from repro_torch.core import wire

__all__ = ["Transport"]


class Transport(abc.ABC):
    """Peer fabric one anti-entropy session runs over."""

    #: short name recorded in ``GossipReport.transport``
    name: str = "abstract"

    #: True when the session registry IS the peer state (no delta phase)
    authoritative: bool = False

    def __init__(self) -> None:
        # content keys (``ClockDigest.key``) of the rows this node holds
        # per peer: the session pulls only peers whose advertised key
        # differs, so an unchanged fleet costs digest bytes only
        self.have: dict = {}
        # peer_id -> error string for peers this round could not reach;
        # the session audits them and reports them on the round
        self.unreachable: dict = {}

    def _begin_round(self) -> None:
        """Reset per-round skip state (every ``digests()`` calls this)."""
        self.unreachable = {}

    @abc.abstractmethod
    def digests(self) -> tuple[dict[str, wire.ClockDigest], int]:
        """(peer_id -> digest, measured inbound digest bytes)."""

    @abc.abstractmethod
    def pull(self, peer_ids) -> tuple[dict[str, bytes], int]:
        """(peer_id -> encoded clock frame, measured inbound bytes)."""

    @abc.abstractmethod
    def push(self, peer_ids, frame: bytes) -> int:
        """Ship the merged-union frame to every peer; returns measured
        outbound bytes."""

    def close(self) -> None:
        """Release sockets/handles (no-op for in-process transports)."""
