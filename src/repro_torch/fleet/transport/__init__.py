"""Pluggable gossip transport fabric: one session protocol
(``anti_entropy_session``: digest exchange → delta pull of §4 wire
rows → classify → union merge → push-back) over a :class:`Transport`:

- :class:`LoopbackTransport`        the local registry slab is the fleet;
- :class:`MeshCollectiveTransport`  a mesh-sharded registry exchanges
  digest shards over a ring between its devices; rows never leave them;
- :class:`SocketTransport`          real processes exchanging
  length-prefixed, CRC-checked ``core.wire`` frames over TCP
  (:class:`ClockPeerServer` / :class:`ClockNode` are the serving side).

Every report byte count is measured from the frames that moved.
"""
from repro_torch.fleet.transport.base import Transport
from repro_torch.fleet.transport.loopback import LoopbackTransport
from repro_torch.fleet.transport.mesh import MeshCollectiveTransport
from repro_torch.fleet.transport.session import anti_entropy_session
from repro_torch.fleet.transport.socket import (
    ClockNode,
    ClockPeerServer,
    SocketTransport,
    TransportError,
)

__all__ = [
    "Transport",
    "LoopbackTransport",
    "MeshCollectiveTransport",
    "SocketTransport",
    "ClockNode",
    "ClockPeerServer",
    "TransportError",
    "anti_entropy_session",
]
