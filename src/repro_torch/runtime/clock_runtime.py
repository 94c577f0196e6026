"""ClockRuntime: one process's bloom clock and the decisions taken from it.

Events tick the clock (``tick*``); the pairwise receive path (``lineage``
/ ``admit_merge``) runs through the fused merge+compare kernel, one
kernel call and one wait for the card per message; fleet paths go
through a ``fleet.ClockRegistry`` (``classify_fleet``, ``gossip``).
All decisions are O(m), independent of fleet size.  ``causal`` is a
``CausalEngine`` over the runtime's policy, for batched callers
(``ServingEngine.adopt_many`` classifies a batch of session clocks
through it), and ``obs`` its observer.

The runtime lives on one device: the card unless ``device="cpu"`` is
given.  Every method that takes a foreign clock (one decoded from a
manifest or a wire frame, another runtime's) moves it onto that device
once, first (``_local``).  ``classify_checkpoints`` lineage-checks a
whole ``checkpoint.CheckpointManager`` directory in one one-vs-many
call over its manifests' clocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.causal import CausalEngine, CausalPolicy
from repro_torch.core import clock as bc
from repro_torch.core import history as hist
from repro_torch.core.hashing import stable_event_id
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

__all__ = ["ClockConfig", "ClockRuntime", "LineageStatus", "CheckpointLineage"]


@dataclasses.dataclass(frozen=True)
class ClockConfig:
    m: int = 1024            # cells — 4KB/clock on the wire (int32)
    k: int = 4               # probes/event
    fp_threshold: float = 1e-4
    history_window: int = 32
    straggler_gap: float = 64.0  # clock-sum ticks
    # full causality policy; None derives one from fp_threshold.  When
    # set, its fp_threshold is the one the runtime gates on.
    policy: Optional[CausalPolicy] = None

    def causal_policy(self) -> CausalPolicy:
        return (self.policy if self.policy is not None
                else CausalPolicy(fp_threshold=self.fp_threshold))


def _to_host(tensors: dict) -> dict:
    """numpy arrays of ``tensors`` after one wait for the card: each is
    copied without blocking into pinned host memory, then the stream is
    synchronised once (the reference's single ``jax.device_get``)."""
    first = next(iter(tensors.values()))
    if not first.is_cuda:
        return {key: t.numpy() for key, t in tensors.items()}
    out = {}
    for key, t in tensors.items():
        out[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out[key].copy_(t, non_blocking=True)
    torch.cuda.current_stream(first.device).synchronize()
    return {key: t.numpy() for key, t in out.items()}


class LineageStatus:
    ANCESTOR = "ancestor"        # other ≼ mine: other is in my past (safe)
    SAME = "same"
    DESCENDANT = "descendant"    # mine ≼ other: other is ahead of me
    FORKED = "forked"            # concurrent: split brain / missed sync


@dataclasses.dataclass
class CheckpointLineage:
    """One ``CausalEngine.classify`` call over a checkpoint directory.

    Entries are sorted by step; ``safe`` mirrors ``admit_restore``'s
    decision rule per checkpoint.
    """

    steps: np.ndarray            # int64 [S]
    status: list                 # LineageStatus string per step
    fp: np.ndarray               # float32 [S] Eq. 3 fp of the claim
    safe: np.ndarray             # bool [S] restorable without forking

    def latest_safe(self) -> Optional[int]:
        idx = np.flatnonzero(self.safe)
        return int(self.steps[idx[-1]]) if idx.size else None

    def summary(self) -> str:
        return " ".join(
            f"step_{s}:{st}{'' if ok else '(unsafe)'}"
            for s, st, ok in zip(self.steps, self.status, self.safe))


class ClockRuntime:
    def __init__(self, cfg: ClockConfig, run_id: str = "run0",
                 observer=None, device=None):
        self.cfg = cfg
        self.run_id = run_id
        self.device = resolve_device(device)
        self.policy = cfg.causal_policy()
        if observer is not None:
            # the engine below, every make_registry() slab and every
            # gossip() session inherit the observer through the policy
            self.policy = dataclasses.replace(self.policy, observer=observer)
        self.causal = CausalEngine(self.policy)
        self.obs = self.causal.obs
        self.clock = bc.zeros(cfg.m, cfg.k, device=self.device)
        self.history = hist.init(cfg.history_window, cfg.m, cfg.k,
                                 device=self.device)

    # ---- events ----
    def tick(self, *parts) -> None:
        hi, lo = stable_event_id(self.run_id, *parts)
        self.clock = bc.tick(self.clock, hi, lo)
        self.history = hist.push(self.history, self.clock)

    def tick_step(self, step: int) -> None:
        self.tick("step", step)

    def tick_batch(self, step: int) -> None:
        self.tick("batch", step)

    def tick_checkpoint(self, step: int) -> None:
        self.tick("ckpt", step)

    def tick_scale_event(self, epoch: int, n_members: int) -> None:
        self.tick("scale", epoch, n_members)

    # ---- comparisons ----
    def _local(self, other: bc.BloomClock) -> bc.BloomClock:
        """``other`` on this runtime's device (itself when it is there)."""
        if other.cells.device == self.clock.cells.device:
            return other
        return bc.BloomClock(cells=other.cells.to(self.device),
                             base=other.base.to(self.device), k=other.k)

    def _classify(self, other: bc.BloomClock):
        """Fused receive-path compare: ONE kernel call (merged cells,
        dominance flags, sums, Eq. 3 fp) and ONE wait for the card.

        Returns (status, fp, merged_cells [m] int32 numpy array).
        """
        a = self._local(other).logical_cells().to(torch.int32)
        r = ops.merge_compare(a.reshape(1, -1).contiguous(),
                              self.clock.logical_cells().reshape(1, -1)
                              .to(torch.int32).contiguous())
        h = _to_host({key: r[key] for key in ("merged", "a_le_b", "b_le_a",
                                               "fp_a_before_b",
                                               "fp_b_before_a")})
        a_le_b = bool(h["a_le_b"][0])     # other ≼ mine
        b_le_a = bool(h["b_le_a"][0])     # mine ≼ other
        if a_le_b and b_le_a:
            return LineageStatus.SAME, 0.0, h["merged"][0]
        if a_le_b:
            return LineageStatus.ANCESTOR, float(h["fp_a_before_b"][0]), h["merged"][0]
        if b_le_a:
            return LineageStatus.DESCENDANT, float(h["fp_b_before_a"][0]), h["merged"][0]
        # exact — no false negatives (§3)
        return LineageStatus.FORKED, 0.0, h["merged"][0]

    def lineage(self, other: bc.BloomClock) -> tuple[str, float]:
        """Classify another clock against ours + Eq. 3 confidence."""
        status, fp, _ = self._classify(other)
        return status, fp

    def classify_fleet(self, registry):
        """Classify every peer in a ``fleet.ClockRegistry`` against our
        clock in one kernel call (see ``registry.classify_all``)."""
        return registry.classify_all(self.clock)

    def make_registry(self, capacity: int, *, mesh=None,
                      axis: str | None = None):
        """Fleet registry sized to this runtime's clock config, carrying
        its CausalPolicy: on the runtime's device, or sharded over a
        mesh (``launch.mesh.make_fleet_mesh``), where ``classify_fleet``
        runs once a row shard with results bit-identical to one slab."""
        from repro_torch.fleet.registry import ClockRegistry
        from repro_torch.sharding import FLEET_AXIS
        return ClockRegistry(capacity, m=self.cfg.m, k=self.cfg.k, mesh=mesh,
                             axis=FLEET_AXIS if axis is None else axis,
                             policy=self.policy, device=self.device)

    def gossip(self, registry, cfg=None, transport=None):
        """One anti-entropy session (loopback over ``registry`` unless a
        transport is given, e.g. a ``SocketTransport`` whose delta pull
        fills ``registry``); the merged union becomes the runtime clock.
        The session gates on this runtime's policy unless ``cfg`` is
        given."""
        from repro_torch.fleet.gossip import GossipConfig
        from repro_torch.fleet.transport import LoopbackTransport
        from repro_torch.fleet.transport.session import anti_entropy_session
        if cfg is None:
            cfg = GossipConfig(policy=self.policy,
                               straggler_gap=self.cfg.straggler_gap)
        if transport is None:
            transport = LoopbackTransport(registry)
        merged, report = anti_entropy_session(
            registry, self.clock, transport, cfg)
        self.clock = merged
        return report

    def refined_fp(self, other: bc.BloomClock) -> float:
        """§3 history refinement: fp against the closest dominating stored
        timestamp instead of the newest."""
        fp, _ = hist.best_predecessor_fp(self.history, self._local(other))
        return float(fp)

    def admit_restore(self, ckpt_clock: bc.BloomClock) -> tuple[bool, str, float]:
        """Is restoring from this checkpoint causally safe?"""
        ckpt_clock = self._local(ckpt_clock)   # once, for both reads
        status, fp = self.lineage(ckpt_clock)
        if status == LineageStatus.FORKED:
            return False, status, fp
        if status == LineageStatus.ANCESTOR:
            fp = min(fp, self.refined_fp(ckpt_clock))
            return (fp <= self.policy.fp_threshold
                    or float(bc.clock_sum(self.clock)) == 0.0), status, fp
        return True, status, fp

    def classify_checkpoints(self, manager) -> CheckpointLineage:
        """Classify a WHOLE checkpoint directory against the live clock
        in one ``causal.classify`` call (manifests only — no state
        tensors are read): the stacked int32 rows go through the i32
        one-vs-many kernel, then ``admit_restore``'s decision rule.
        ANCESTOR candidates that miss the fp gate get the §3 history
        refinement (there are usually zero or one)."""
        entries = manager.clock_manifests()
        steps = np.asarray([s for s, _ in entries], np.int64)
        if not entries:
            return CheckpointLineage(
                steps=steps, status=[],
                fp=np.zeros(0, np.float32), safe=np.zeros(0, bool))
        clocks = [self.clock_from_snapshot(man["clock"], device=self.device)
                  for _, man in entries]
        stacked = torch.stack(
            [c.logical_cells().to(torch.int32) for c in clocks])
        res = self.causal.classify(self.clock, stacked).to_host()
        p_le_q, q_le_p = res.after(), res.before()
        thr = self.policy.fp_threshold
        live_empty = float(bc.clock_sum(self.clock)) == 0.0
        status, fp, safe = [], [], []
        for i in range(len(entries)):
            if p_le_q[i] and q_le_p[i]:
                st, f, ok = LineageStatus.SAME, 0.0, True
            elif p_le_q[i]:
                st, f = LineageStatus.ANCESTOR, float(res.fp_p_before_q[i])
                if f > thr and not live_empty:
                    f = min(f, self.refined_fp(clocks[i]))
                ok = f <= thr or live_empty
            elif q_le_p[i]:
                st, f, ok = (LineageStatus.DESCENDANT,
                             float(res.fp_q_before_p[i]), True)
            else:
                st, f, ok = LineageStatus.FORKED, 0.0, False
            status.append(st)
            fp.append(f)
            safe.append(ok)
        return CheckpointLineage(
            steps=steps, status=status,
            fp=np.asarray(fp, np.float32), safe=np.asarray(safe, bool))

    def admit_restore_latest(self, manager) -> tuple[Optional[int], CheckpointLineage]:
        """Newest causally-safe checkpoint step in the directory (or
        None), plus the full per-checkpoint lineage."""
        lineage = self.classify_checkpoints(manager)
        return lineage.latest_safe(), lineage

    def admit_merge(self, peer_clock: bc.BloomClock) -> tuple[bool, str, float]:
        """Async outer-loop guard: merge a peer's update?

        Comparable (either direction) with confident fp -> merge + clock
        max; concurrent -> quarantine.  The merged cells come from the
        same fused kernel call as the decision.
        """
        status, fp, merged = self._classify(peer_clock)
        ok = status != LineageStatus.FORKED and fp <= self.policy.fp_threshold
        if ok:
            self.clock = bc.compress(bc.BloomClock(
                cells=torch.as_tensor(merged, device=self.device),
                base=torch.zeros((), dtype=torch.int32, device=self.device),
                k=self.clock.k))
        return ok, status, fp

    # ---- straggler policy ----
    def straggler_mask(self, peer_sums: np.ndarray) -> np.ndarray:
        """True for peers to SKIP this round (too far behind the median)."""
        med = np.median(peer_sums)
        return (med - np.asarray(peer_sums)) > self.cfg.straggler_gap

    # ---- wire format ----
    def snapshot(self) -> dict:
        """Wire/persist form: §4 compression + u8 residual quantization
        when the window fits a byte (see ``core.clock.to_wire``)."""
        return bc.to_wire(self.clock)

    @staticmethod
    def clock_from_snapshot(snap: dict, device=None) -> bc.BloomClock:
        """A clock from a ``snapshot`` dict (a manifest's ``clock``) or a
        wire frame, on ``device`` (None: the CPU, as
        ``core.clock.from_wire``); the runtime's methods move it to
        their device."""
        return bc.from_wire(snap, device=device)
