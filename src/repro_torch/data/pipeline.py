"""Deterministic synthetic token pipeline with bloom-clock batch stamping.

Batches come from a counter-based numpy RNG, the JAX package's code
unchanged, so batch ``i`` is identical in both packages (and across
restarts and rescales) for every ``(seed, step, host_id, n_hosts)``.
Every global batch carries a 64-bit event id derived from (run_id,
step); the trainer ticks its bloom clock with it, so a stale or forked
data cursor shows up as clock incomparability.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hashing import stable_event_id
from repro_torch.device import resolve_device

__all__ = ["DataConfig", "SyntheticLM", "batch_event_id"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    run_id: str = "run0"
    seed: int = 1234
    # structured synthetic stream: repeated n-gram process so the model has
    # something learnable (the loss visibly decreases)
    ngram: int = 3


def batch_event_id(run_id: str, step: int) -> tuple[int, int]:
    """(hi, lo) uint32 event id for the bloom clock tick of batch ``step``."""
    return stable_event_id("batch", run_id, step)


class SyntheticLM:
    """Counter-based synthetic LM stream.

    ``batch(step)`` -> dict(tokens, labels [B, S] int32).  Tokens follow
    a deterministic mixture: token_t = f(token_{t-1}) with noise, so
    cross-entropy is reducible and training curves are meaningful.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed random transition table: next = table[prev] (+ noise)
        self._table = rng.integers(0, cfg.vocab, size=cfg.vocab, dtype=np.int64)

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1,
              device=None) -> dict:
        """Batch ``step`` (this host's share) as int32 tensors on
        ``device`` (None = the card)."""
        cfg = self.cfg
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        local_b = cfg.global_batch // n_hosts
        rng = np.random.default_rng(
            (cfg.seed, step, host_id)
        )  # counter-based: (seed, step, host) fully determines the batch
        toks = np.empty((local_b, cfg.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=local_b)
        noise = rng.random((local_b, cfg.seq_len)) < 0.1
        rands = rng.integers(0, cfg.vocab, size=(local_b, cfg.seq_len))
        for t in range(cfg.seq_len):
            nxt = self._table[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rands[:, t], nxt)
        dev = resolve_device(device)
        return {
            "tokens": torch.as_tensor(toks[:, :-1].astype(np.int32), device=dev),
            "labels": torch.as_tensor(toks[:, 1:].astype(np.int32), device=dev),
        }

    def event_id(self, step: int) -> tuple[int, int]:
        return batch_event_id(self.cfg.run_id, step)
