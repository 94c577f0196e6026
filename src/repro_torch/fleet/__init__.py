"""Fleet causality subsystem: bulk bloom-clock tracking for whole fleets.

- ``registry``  — fixed-capacity slab of peer clocks with batched
  admit/evict/update, a one-kernel-call ``classify_all`` and
  ``all_pairs``, on one device or row-sharded over a fleet mesh;
- ``gossip``    — anti-entropy round config/report + the loopback round;
- ``transport`` — the session protocol (digest → delta → classify →
  union → push-back) over the loopback, mesh-collective and TCP socket
  transports;
- ``chaos``     — seeded, replayable fault injection (``ChaosTransport``
  wraps any fabric: drops, duplicates, reorders, damaged frames,
  mid-session crashes, healing partitions);
- ``monitor``   — fleet health (fork components, stragglers, the fp
  profile) from one all-pairs call, ``watch`` and the Eq. 3 band check.
"""
from repro_torch.fleet.chaos import ChaosConfig, ChaosTransport, FaultEvent
from repro_torch.fleet.registry import (
    ANCESTOR,
    DEAD,
    DESCENDANT,
    FORKED,
    SAME,
    STATUS_NAMES,
    ClockRegistry,
    EvictedRow,
    FleetView,
    view_from_classify,
)
from repro_torch.fleet.gossip import GossipConfig, GossipReport, gossip_round
from repro_torch.fleet.monitor import (
    FleetHealth,
    fleet_health,
    fork_components,
    record_health,
    watch,
)
from repro_torch.fleet.transport import (
    ClockNode,
    ClockPeerServer,
    LoopbackTransport,
    MeshCollectiveTransport,
    SocketTransport,
    Transport,
    TransportError,
    anti_entropy_session,
)

__all__ = [
    "ClockRegistry",
    "EvictedRow",
    "FleetView",
    "view_from_classify",
    "GossipConfig",
    "GossipReport",
    "gossip_round",
    "anti_entropy_session",
    "Transport",
    "LoopbackTransport",
    "MeshCollectiveTransport",
    "SocketTransport",
    "ClockNode",
    "ClockPeerServer",
    "TransportError",
    "ChaosConfig",
    "ChaosTransport",
    "FaultEvent",
    "ANCESTOR",
    "SAME",
    "DESCENDANT",
    "FORKED",
    "DEAD",
    "STATUS_NAMES",
    "FleetHealth",
    "fleet_health",
    "fork_components",
    "record_health",
    "watch",
]
