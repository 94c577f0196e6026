"""Async multi-pod training (DiLoCo-style local SGD) with clock-guarded
merges.

Topology: P pods each run H local steps on their own data shard (no
cross-pod traffic), then an *outer* step averages pod deltas under a
Nesterov outer optimizer.  Pods are unreliable: they can straggle (skip
rounds) or fork (restart from a stale checkpoint and miss outer syncs).
The coordinator decides WHOSE deltas to merge purely from bloom clocks:

  - every pod ticks per local step and per outer sync it participates in;
  - at sync, a pod's clock must be COMPARABLE with the coordinator's
    (within the Eq. 3 fp threshold).  A forked pod has ticked events the
    coordinator never saw (and vice versa) -> clocks concurrent -> its
    delta is quarantined, with O(m) state independent of pod count;
  - stragglers are skipped by clock-sum gap, no barrier.

The pod fleet is simulated in one process, as in the JAX package; the
decision logic is the reference's.  Pods' params are dicts of tensors on
the coordinator's device, and every pod clock lives there too: a round's
classification is one packed one-vs-many kernel call over the registry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import clock as bc
from repro_torch.fleet.registry import ANCESTOR, DESCENDANT, FORKED, SAME, ClockRegistry
from repro_torch.runtime.clock_runtime import ClockConfig, ClockRuntime, LineageStatus

__all__ = ["AsyncConfig", "PodState", "AsyncCoordinator", "run_pod_round"]


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    n_pods: int = 4
    local_steps: int = 8          # H
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    grad_compress: bool = True    # bf16 delta exchange + error feedback


@dataclasses.dataclass
class PodState:
    pod_id: int
    params: dict
    clock: ClockRuntime
    err_feedback: Optional[dict] = None   # compression residual
    alive: bool = True


def _compress_delta(delta: dict, err: Optional[dict]):
    """bf16 wire compression with error feedback (residual carried fwd).
    Both packages round to nearest even, so the wire values are the
    reference's."""
    if err is None:
        err = {k: torch.zeros_like(d, dtype=torch.float32)
               for k, d in delta.items()}
    full = {k: d.to(torch.float32) + err[k] for k, d in delta.items()}
    wire = {k: x.to(torch.bfloat16) for k, x in full.items()}
    new_err = {k: full[k] - wire[k].to(torch.float32) for k in full}
    return wire, new_err


class AsyncCoordinator:
    """Holds the global params + outer optimizer + its own clock, on
    ``device`` (None = the card)."""

    def __init__(self, params: dict, a_cfg: AsyncConfig, c_cfg: ClockConfig,
                 run_id: str = "async0", device=None):
        self.cfg = a_cfg
        self.clock = ClockRuntime(c_cfg, run_id=run_id, device=device)
        self.device = self.clock.device
        self.params = {k: v.to(self.device, torch.float32)
                       for k, v in params.items()}
        self.momentum = {k: torch.zeros_like(v) for k, v in self.params.items()}
        # fleet registry: one slab row per pod clock; all per-round
        # classification happens in ONE kernel call against it, under
        # the runtime's CausalPolicy
        self.registry = ClockRegistry(
            capacity=max(16, 4 * a_cfg.n_pods), m=c_cfg.m, k=c_cfg.k,
            policy=self.clock.policy, device=self.device)
        self.run_id = run_id
        self.round = 0
        self.log: list = []

    def add_pods(self, pod_ids: list, c_cfg: ClockConfig) -> list:
        """Elastic membership commit: one scale event for the whole epoch,
        then every (new and existing-via-next-sync) member inherits the
        coordinator's causal history.  Committing per pod would make pod
        i concurrent with pods spawned after it."""
        self.clock.tick_scale_event(self.round, len(pod_ids))
        pods = []
        for pid in pod_ids:
            rt = ClockRuntime(c_cfg, run_id=self.run_id, device=self.device)
            rt.clock = bc.merge(rt.clock, self.clock.clock)
            pods.append(PodState(pod_id=pid, params=dict(self.params), clock=rt))
        self.registry.admit_many({p.pod_id: p.clock.clock for p in pods})
        return pods

    def spawn_pod(self, pod_id: int, c_cfg: ClockConfig) -> PodState:
        return self.add_pods([pod_id], c_cfg)[0]

    def outer_step(self, pods: list, deltas: dict) -> dict:
        """One outer sync. deltas: {pod_id: delta dict}.

        Returns per-pod decisions {pod_id: (merged, status, fp)}.

        The causal gating is fleet-batched: pod clocks are scattered
        into the registry and classified against the coordinator's clock
        by one packed one-vs-many kernel call; per-pod work is host
        bookkeeping.
        """
        decisions = {}
        # retired pods free their slots: elastic churn through arbitrarily
        # many pod ids must not exhaust the fixed-capacity registry
        current = {p.pod_id for p in pods}
        self.registry.evict_many(
            [pid for pid in self.registry.peer_ids() if pid not in current])
        known = {p.pod_id: p for p in pods if p.pod_id in self.registry}
        late = [p for p in pods if p.pod_id not in self.registry]
        if late:   # pods spawned outside add_pods (elastic joins)
            self.registry.admit_many({p.pod_id: p.clock.clock for p in late})
            known.update({p.pod_id: p for p in late})
        self.registry.update_many(
            {pid: p.clock.clock for pid, p in known.items()})
        view = self.clock.classify_fleet(self.registry)

        # straggler skip by clock-sum gap, over the participating pods
        slot = {pid: self.registry.slot_of(pid) for pid in known}
        sums = np.array([float(view.sums[slot[p.pod_id]]) for p in pods])
        skip = self.clock.straggler_mask(sums)

        accepted = []
        accept_mask = np.zeros(self.registry.capacity, bool)
        for i, pod in enumerate(pods):
            if pod.pod_id not in deltas or not pod.alive:
                decisions[pod.pod_id] = (False, "dead", 0.0)
                continue
            # fork detection first: a forked pod's delta is never safe, no
            # matter how fresh it looks
            s = slot[pod.pod_id]
            status_code = int(view.status[s])
            fp = float(view.fp[s])
            if status_code == FORKED:
                decisions[pod.pod_id] = (False, LineageStatus.FORKED, fp)
                continue
            if skip[i]:
                decisions[pod.pod_id] = (False, "straggler", 0.0)
                continue
            status = {ANCESTOR: LineageStatus.ANCESTOR,
                      SAME: LineageStatus.SAME,
                      DESCENDANT: LineageStatus.DESCENDANT}[status_code]
            decisions[pod.pod_id] = (True, status, fp)
            accepted.append(pod.pod_id)
            accept_mask[s] = True

        if accepted:
            mu, lr = self.cfg.outer_momentum, self.cfg.outer_lr
            for k in self.params:
                avg = sum(deltas[p][k].to(self.device, torch.float32)
                          for p in accepted) / len(accepted)
                self.momentum[k] = mu * self.momentum[k] + avg
                self.params[k] = self.params[k] + lr * (
                    mu * self.momentum[k] + avg)  # nesterov

        # commit: the coordinator ABSORBS accepted pods' clocks (paper §3
        # receive rule — merge by max, batched into one slab reduction),
        # ticks the round, and publishes the union, so a skipped
        # straggler catches up on resync
        if accept_mask.any():
            self.clock.clock = self.registry.union(accept_mask, self.clock.clock)
        self.clock.tick("outer", self.round)
        self.clock.clock = bc.compress(self.clock.clock)
        # every accepted pod is ≼ the pre-tick union, so merging with the
        # published clock just yields the published clock: assign it.
        self.registry.broadcast(accept_mask, self.clock.clock)
        for pod in pods:
            if decisions[pod.pod_id][0]:
                pod.clock.clock = self.clock.clock
                pod.params = dict(self.params)
        self.round += 1
        self.log.append({p: d for p, d in decisions.items()})
        return decisions


def run_pod_round(pod: PodState, train_step: Callable, data_fn: Callable,
                  a_cfg: AsyncConfig, base_step: int):
    """H local steps on a pod; returns (delta, pod) with clocks ticked.
    ``train_step(params, batch) -> (params, loss)``."""
    start = {k: v.to(torch.float32, copy=True) for k, v in pod.params.items()}
    params = pod.params
    for h in range(a_cfg.local_steps):
        step_id = base_step + h
        batch = data_fn(pod.pod_id, step_id)
        params, _ = train_step(params, batch)
        pod.clock.tick("pod", pod.pod_id, "step", step_id)
    pod.params = params
    delta = {k: p.to(torch.float32) - start[k] for k, p in params.items()}
    if a_cfg.grad_compress:
        delta, pod.err_feedback = _compress_delta(delta, pod.err_feedback)
    return delta, pod
