"""Pluggable gossip transport fabric: one session protocol
(``anti_entropy_session``) over a :class:`Transport`.  The port has the
:class:`LoopbackTransport` (the local registry slab is the fleet)."""
from repro_torch.fleet.transport.base import Transport
from repro_torch.fleet.transport.loopback import LoopbackTransport
from repro_torch.fleet.transport.session import anti_entropy_session

__all__ = ["Transport", "LoopbackTransport", "anti_entropy_session"]
