"""Batched serving engine with bloom-clock session stamping.

Continuous-batching-lite: requests join a fixed-width slot table; each
engine step decodes one token for every active slot.  Clock integration:

  - the engine ticks per admitted request and per emitted token batch
    (the tick kernel, B = 1);
  - each session carries its own clock; on migration between replicas the
    destination verifies ``session.clock ≼ replica.clock`` (the session's
    KV snapshot is from this replica's causal past) before adopting it,
    through the fused merge+compare kernel (``can_adopt``);
  - live session clocks sit in a ``fleet.ClockRegistry`` slab, and bulk
    migration (``adopt_many``) classifies a whole batch of incoming
    sessions with ONE one-vs-many kernel call on their stacked int32
    cells.

The engine runs on one device, the card unless ``device="cpu"``: the
model is built there once (``models.transformer.build``: weights cast
to the compute dtype once), and prefill and decode run eagerly (no
``jit``; the caches are updated in place).  Greedy sampling
(``temperature <= 0``) is argmax, token for token the JAX package's.
Sampling at a temperature draws from a ``torch.Generator`` seeded from
``(seed, step)``: the JAX package's ``jax.random.categorical`` bits
cannot be reproduced, so those tokens differ from its tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import clock as bc
from repro_torch.core import wire
from repro_torch.core.hashing import stable_event_id
from repro_torch.device import resolve_device
from repro_torch.fleet.registry import ClockRegistry
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.clock_runtime import ClockConfig, ClockRuntime

__all__ = ["ServeConfig", "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 512
    temperature: float = 0.0    # 0 = greedy
    seed: int = 0


def _sample_seed(seed: int, step: int) -> int:
    """The generator seed of one sampling step: 32 mixed bits of
    ``(seed, step)`` (the CPU generator keeps only a seed's low 32)."""
    return stable_event_id("sample", seed, step)[1]


class ServingEngine:
    def __init__(self, params, cfg: ModelConfig, s_cfg: ServeConfig,
                 c_cfg: ClockConfig, replica_id: str = "replica0",
                 device=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.s_cfg = s_cfg
        self.model = T.build(params, cfg, self.device)
        self.clock = ClockRuntime(c_cfg, run_id="serve", device=self.device)
        self.replica_id = replica_id
        self._admitted = 0
        # fleet registry of live session clocks: migration audits and
        # fleet dashboards classify all of them in one device call.
        # Bounded: when full, the oldest tracked session is evicted
        # (FIFO) so a long-running engine never crashes on admission;
        # callers can release() finished sessions to free slots early.
        self.sessions = ClockRegistry(
            capacity=max(16, 8 * s_cfg.max_batch), m=c_cfg.m, k=c_cfg.k,
            policy=self.clock.policy, device=self.device)
        self._session_order: list = []
        self._session_seq = 0
        # instrumentation rides the clock policy (see repro_torch.obs)
        self.obs = self.clock.obs

    def _audit_adopt(self, sid, session: dict, verdict: str, ok: bool,
                     fp: float, engine: str) -> None:
        """Audit one migration verdict the engine acted on."""
        obs = self.obs
        if not obs.audit:
            return
        local_cells = self.clock.clock.logical_cells().cpu().numpy()
        peer_cells = session["clock"].clock.logical_cells().cpu().numpy()
        frames = {}
        if obs.audit.store_frames:
            frames = {
                "local_frame": wire.encode_clock(bc.to_wire(self.clock.clock)),
                "peer_frame": wire.encode_clock(
                    bc.to_wire(session["clock"].clock)),
            }
        obs.audit.record(
            "verdict", sid,
            verdict=verdict,
            action="adopt" if ok else "reject",
            fp=fp,
            threshold=float(self.clock.policy.fp_threshold),
            engine=engine,
            local_crc=wire.cells_crc(local_cells),
            peer_crc=wire.cells_crc(peer_cells),
            local_sum=float(local_cells.sum()),
            peer_sum=float(peer_cells.sum()),
            transport="serving",
            **frames)
        obs.metrics.counter(
            "serving_adoptions",
            outcome="adopted" if ok else "rejected").inc()

    def _register_session(self, sid, clock) -> None:
        if sid not in self.sessions:
            while len(self.sessions) >= self.sessions.capacity:
                self.sessions.evict(self._session_order.pop(0))
            self._session_order.append(sid)
        self.sessions.admit(sid, clock)

    def release(self, session: dict) -> None:
        """Drop a finished session's clock from the registry."""
        sid = session.get("sid")
        if sid is not None and sid in self.sessions:
            self.sessions.evict(sid)
            self._session_order.remove(sid)

    # ---- session admission ----
    def admit(self, prompts: torch.Tensor) -> dict:
        """prompts [B, S] int -> session dict with caches + session clock."""
        prompts = torch.as_tensor(prompts).to(self.device)
        B = prompts.shape[0]
        logits, caches = T.prefill(self.model, self.cfg, prompts,
                                   buf_len=self.s_cfg.max_seq)
        for i in range(B):
            self.clock.tick("admit", self.replica_id, self._admitted + i)
        self._admitted += B
        sess_clock = ClockRuntime(self.clock.cfg, run_id="serve",
                                  device=self.device)
        sess_clock.clock = bc.merge(sess_clock.clock, self.clock.clock)
        sid = f"{self.replica_id}/s{self._session_seq}"
        self._session_seq += 1
        self._register_session(sid, sess_clock.clock)
        return {
            "sid": sid,
            "caches": caches,
            "last_logits": logits,
            "pos": prompts.shape[1],
            "tokens": [prompts],
            "clock": sess_clock,
            "done": np.zeros(B, bool),
        }

    # ---- decode loop ----
    def _sample(self, logits: torch.Tensor, step: int) -> torch.Tensor:
        if self.s_cfg.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # Gumbel-max, the method of jax.random.categorical, on torch bits
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_sample_seed(self.s_cfg.seed, step))
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(
            u.clamp_(min=torch.finfo(torch.float32).tiny)))
        scaled = logits.float() / self.s_cfg.temperature
        return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)

    def generate(self, session: dict, n_tokens: int) -> torch.Tensor:
        """Decode n tokens for every slot; ticks clocks per emitted batch."""
        out = []
        tok = self._sample(session["last_logits"], 0)
        for t in range(n_tokens):
            out.append(tok)
            logits, session["caches"] = T.decode_step(
                self.model, self.cfg, session["caches"], tok, session["pos"])
            session["pos"] += 1
            self.clock.tick("tokens", self.replica_id, session["pos"])
            session["clock"].clock = bc.merge(session["clock"].clock,
                                              self.clock.clock)
            tok = self._sample(logits, t + 1)
            session["last_logits"] = logits
        if session.get("sid") in self.sessions:
            self.sessions.update(session["sid"], session["clock"].clock)
        return torch.stack(out, dim=1)  # [B, n_tokens]

    # ---- migration ----
    def can_adopt(self, session: dict) -> tuple[bool, str, float]:
        """Clock-gated session migration (see module docstring)."""
        status, fp = self.clock.lineage(session["clock"].clock)
        ok = (status in ("ancestor", "same")
              and fp <= self.clock.policy.fp_threshold)
        return ok, status, fp

    def adopt(self, session: dict) -> bool:
        """Single-session migration: the batched classify path with a
        batch of one, so the audit record carries the real dispatch
        engine and the merge shares the wrap-safe bulk reduction."""
        return bool(self.adopt_many([session])[0])

    def adopt_many(self, sessions: list) -> np.ndarray:
        """Clock-gated BULK migration: classify every incoming session
        against the replica clock with ONE ``causal.classify`` call,
        adopt the safe ones, merge their clocks in one reduction.

        Returns the bool accept mask (aligned with ``sessions``).
        """
        if not sessions:
            return np.zeros(0, bool)
        cells = torch.stack([
            s["clock"].clock.logical_cells().to(device=self.device,
                                                dtype=torch.int32)
            for s in sessions])
        res = self.clock.causal.classify(self.clock.clock, cells).to_host()
        # session ≼ replica (its KV snapshot is from our causal past)
        # with Eq.-3 confidence — same rule as can_adopt, batched
        ok = res.after() & (res.fp_after() <= self.clock.policy.fp_threshold)
        if self.obs.audit:
            equal = res.after() & res.before()
            for i, s in enumerate(sessions):
                verdict = ("same" if equal[i]
                           else "ancestor" if res.after()[i]
                           else "descendant" if res.before()[i]
                           else "forked")
                self._audit_adopt(
                    s.get("sid") or f"migrating/{i}", s, verdict,
                    bool(ok[i]), float(res.fp_after()[i]),
                    res.engine or "i32")
        if ok.any():
            # wrap-safe bulk merge: fold core.clock.merge's wrap-
            # subtraction form (local + relu(peer - local), exact on the
            # mod-2^32 circle) across accepted rows — a plain maximum
            # would zero a near-wrap local clock against sane peers
            local = self.clock.clock.logical_cells().to(torch.int32)
            accept = torch.as_tensor(ok, device=self.device)[:, None]
            gain = torch.where(accept, torch.clamp(cells - local, min=0), 0)
            self.clock.clock = bc.compress(bc.BloomClock(
                cells=local + gain.amax(0),
                base=torch.zeros((), dtype=torch.int32, device=self.device),
                k=self.clock.clock.k))
            for i, s in enumerate(sessions):
                if ok[i]:
                    sid = s.get("sid") or f"migrated/s{self._session_seq}"
                    s["sid"] = sid
                    self._session_seq += 1
                    self._register_session(sid, s["clock"].clock)
        return ok
