"""Pluggable gossip transport fabric: one session protocol
(``anti_entropy_session``) over a :class:`Transport`.  The port has the
:class:`LoopbackTransport` (the local registry slab is the fleet) and
the :class:`MeshCollectiveTransport` (a mesh-sharded registry exchanges
digest shards over a ring between its devices; rows never leave them)."""
from repro_torch.fleet.transport.base import Transport
from repro_torch.fleet.transport.loopback import LoopbackTransport
from repro_torch.fleet.transport.mesh import MeshCollectiveTransport
from repro_torch.fleet.transport.session import anti_entropy_session

__all__ = ["Transport", "LoopbackTransport", "MeshCollectiveTransport",
           "anti_entropy_session"]
