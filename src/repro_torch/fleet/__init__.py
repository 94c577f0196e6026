"""Fleet causality subsystem: bulk bloom-clock tracking for whole fleets.

- ``registry``  — fixed-capacity slab of peer clocks with batched
  admit/evict/update and a one-kernel-call ``classify_all``;
- ``gossip``    — anti-entropy round config/report + the loopback round;
- ``transport`` — the session protocol over the loopback transport;
- ``monitor``   — the Eq. 3 band check.
"""
from repro_torch.fleet.registry import (
    ANCESTOR,
    DEAD,
    DESCENDANT,
    FORKED,
    SAME,
    STATUS_NAMES,
    ClockRegistry,
    FleetView,
    view_from_classify,
)
from repro_torch.fleet.gossip import GossipConfig, GossipReport, gossip_round
from repro_torch.fleet.transport import (
    LoopbackTransport,
    Transport,
    anti_entropy_session,
)

__all__ = [
    "ClockRegistry",
    "FleetView",
    "view_from_classify",
    "GossipConfig",
    "GossipReport",
    "gossip_round",
    "anti_entropy_session",
    "Transport",
    "LoopbackTransport",
    "ANCESTOR",
    "SAME",
    "DESCENDANT",
    "FORKED",
    "DEAD",
    "STATUS_NAMES",
]
