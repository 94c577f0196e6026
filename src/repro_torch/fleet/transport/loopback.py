"""LoopbackTransport: the local registry slab IS the fleet.

Peer rows are already in the session registry, so the digest and delta
phases carry zero bytes.  Push-back is the registry broadcast the
session performs; this transport only measures what the outbound half
would cost on a real wire (one encoded §4 frame per accepted peer).
"""
from __future__ import annotations

from repro_torch.core import wire
from repro_torch.fleet.transport.base import Transport

__all__ = ["LoopbackTransport"]


class LoopbackTransport(Transport):
    name = "loopback"
    authoritative = True

    def __init__(self, registry):
        super().__init__()
        self.registry = registry

    def digests(self) -> tuple[dict[str, wire.ClockDigest], int]:
        self._begin_round()
        return {}, 0

    def pull(self, peer_ids) -> tuple[dict[str, bytes], int]:
        return {}, 0

    def push(self, peer_ids, frame: bytes) -> int:
        return len(frame) * len(peer_ids)
