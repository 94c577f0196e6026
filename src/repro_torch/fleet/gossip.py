"""Anti-entropy gossip: config, report, and the loopback round.

One round = what a node does when it wakes up and reconciles with its
view of the fleet.  The protocol (digest exchange → classify via the
``CausalEngine`` → delta pull of §4 wire rows → union merge →
push-back) lives in ``fleet.transport.session`` and is parameterized
by a ``Transport`` (loopback, mesh-collective or socket); this module's
``gossip_round`` runs it over the loopback transport, where the local
registry slab is the fleet.

The round's policy, on [N] host vectors: FORKED peers are quarantined;
stragglers (clock-sum gap above ``straggler_gap`` below the alive
median) are skipped this round; remaining comparable peers whose Eq. 3
fp passes the policy gate are merged in ONE batched union (paper §3
receive rule fleet-wide).  ``GossipReport`` records measured frame
bytes.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import numpy as np

from repro_torch.causal import CausalPolicy
from repro_torch.core import clock as bc
from repro_torch.fleet import registry as reg

__all__ = ["GossipConfig", "GossipReport", "gossip_round"]

_FP_DEFAULT = 1e-4


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    # DEPRECATED: pass ``policy=CausalPolicy(fp_threshold=...)`` instead;
    # it still wins when no policy is set, and warns on explicit use
    fp_threshold: Optional[float] = None
    straggler_gap: float = 64.0   # clock-sum ticks below alive median
    push_back: bool = True        # write the union into accepted rows
    # the one source of truth for the Eq. 3 gate when set
    policy: Optional[CausalPolicy] = None
    # instrumentation override; sessions fall back to ``policy.observer``
    # and then the registry's policy when None
    observer: Any = None
    # verify every alive registry row against its recorded CRC at the
    # top of each session and quarantine the corrupted ones; on a
    # non-authoritative fabric the delta phase then re-pulls them
    verify_rows: bool = False
    # paper §3 pure receive rule: merge FORKED (concurrent) peers too
    # instead of quarantining them, so a fleet whose nodes legitimately
    # tick concurrently can reconverge
    merge_forked: bool = False

    def __post_init__(self):
        if self.fp_threshold is not None:
            warnings.warn(
                "GossipConfig.fp_threshold is deprecated; pass "
                "policy=CausalPolicy(fp_threshold=...) — the policy is "
                "the one source of truth for the Eq. 3 gate",
                DeprecationWarning, stacklevel=3)

    @property
    def fp_gate(self) -> float:
        if self.policy is not None:
            return self.policy.fp_threshold
        return _FP_DEFAULT if self.fp_threshold is None else self.fp_threshold


@dataclasses.dataclass
class GossipReport:
    """Outcome masks of one round (numpy, [capacity]) + measured wire."""

    accepted: np.ndarray          # merged this round
    quarantined: np.ndarray       # FORKED -> excluded until resolved
    stragglers: np.ndarray        # skipped this round (not quarantined)
    unconfident: np.ndarray       # comparable but fp above threshold
    view: reg.FleetView           # the classification the round acted on
    pushback_bytes: int = 0       # MEASURED outbound frame bytes (§4 form)
    digest_bytes: int = 0         # MEASURED inbound digest-exchange bytes
    delta_bytes: int = 0          # MEASURED inbound delta-frame bytes
    transport: str = "loopback"   # fabric the session ran over
    shards: int = 1               # row shards the registry slab spans
    unreachable: tuple = ()       # peers skipped mid-session
    rejected: tuple = ()          # peers whose pulled frame failed decode
    corrupted: tuple = ()         # rows that failed the CRC integrity check
    repaired: tuple = ()          # corrupted rows re-pulled this session

    @property
    def n_accepted(self) -> int:
        return int(self.accepted.sum())

    @property
    def wire_bytes(self) -> int:
        """Total measured bytes this round moved over the fabric."""
        return self.digest_bytes + self.delta_bytes + self.pushback_bytes

    def summary(self) -> str:
        return (
            f"accepted={int(self.accepted.sum())} "
            f"quarantined={int(self.quarantined.sum())} "
            f"stragglers={int(self.stragglers.sum())} "
            f"unconfident={int(self.unconfident.sum())} "
            f"alive={int(self.view.alive.sum())} "
            f"wire={self.wire_bytes}B[{self.transport}]"
            + (f" unreachable={len(self.unreachable)}"
               if self.unreachable else "")
            + (f" rejected={len(self.rejected)}" if self.rejected else "")
            + (f" corrupted={len(self.corrupted)}"
               f" repaired={len(self.repaired)}" if self.corrupted else "")
        )


def gossip_round(
    registry: reg.ClockRegistry,
    local: bc.BloomClock,
    cfg: GossipConfig = GossipConfig(),
) -> tuple[bc.BloomClock, GossipReport]:
    """One anti-entropy round over the LOCAL registry slab (loopback).
    Returns (merged local clock, report)."""
    from repro_torch.fleet.transport import LoopbackTransport
    from repro_torch.fleet.transport.session import anti_entropy_session
    return anti_entropy_session(registry, local, LoopbackTransport(registry),
                                cfg)
