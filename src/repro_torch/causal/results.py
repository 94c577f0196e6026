"""Typed results of the causality API: compare two timestamps, get a
partial order plus an Eq. 3 false-positive rate.

Plain dataclasses over tensors (or numpy arrays after ``to_host``);
accessors never re-derive flags, so values stay those the kernels
produced, and every consumer applies the Eq. 3 gate through
``.confident(threshold)``.  ``ComparisonMatrix`` also answers the
reference's result-dict keys (``res["a_le_b"]``, ``.items()``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["Comparison", "ComparisonMatrix", "ClassifyResult"]


def _where(cond, a, b):
    """Select that keeps numpy leaves numpy and tensor leaves tensors."""
    if isinstance(cond, np.ndarray):
        return np.where(cond, a, b)
    return torch.where(cond, torch.as_tensor(a, device=cond.device),
                       torch.as_tensor(b, device=cond.device))


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


@dataclasses.dataclass(frozen=True)
class Comparison:
    """Pairwise (or batched-pairwise) comparison of clocks A vs B."""

    a_le_b: torch.Tensor       # bool[...]: A cell-wise dominated by B
    b_le_a: torch.Tensor
    fp_ab: torch.Tensor        # float32[...]: Eq. 3 fp of "A -> B"
    fp_ba: torch.Tensor
    sum_a: torch.Tensor        # float32[...]: total increments
    sum_b: torch.Tensor

    def before(self):
        """The claim "A happened-before B" (dominance; includes equal)."""
        return self.a_le_b

    def after(self):
        """The claim "B happened-before A"."""
        return self.b_le_a

    def equal(self):
        return self.a_le_b & self.b_le_a

    def concurrent(self):
        """Neither dominates: exact, no false negatives (paper §3)."""
        return ~(self.a_le_b | self.b_le_a)

    def confident(self, threshold: float):
        """"A -> B" holds AND its Eq. 3 fp is within ``threshold``."""
        return self.a_le_b & (self.fp_ab <= threshold)


@dataclasses.dataclass(frozen=True)
class ComparisonMatrix:
    """All-pairs comparison: [N, M] flag/fp matrices + per-row/col sums.

    ``conc`` is carried, not derived: dead slots report all-False across
    every flag kind, which ``~(le | ge)`` could not represent.
    """

    le: torch.Tensor           # bool[N, M]: row clock ≼ col clock
    ge: torch.Tensor           # bool[N, M]
    conc: torch.Tensor         # bool[N, M]: exact concurrency
    fp: torch.Tensor           # float32[N, M]: Eq. 3 fp of "row -> col"
    row_sums: torch.Tensor     # float32[N]
    col_sums: torch.Tensor     # float32[M]
    engine: Optional[str] = None      # dispatch metadata
    blocks: Optional[tuple] = None    # resolved block shapes

    # the reference's result-dict keys -> fields
    _KEYS = {"a_le_b": "le", "b_le_a": "ge", "concurrent": "conc",
             "fp": "fp", "row_sums": "row_sums", "col_sums": "col_sums"}

    @classmethod
    def from_dict(cls, d: dict, *, engine: str | None = None,
                  blocks: tuple | None = None) -> "ComparisonMatrix":
        return cls(**{f: d[k] for k, f in cls._KEYS.items()}, engine=engine,
                   blocks=blocks)

    def to_host(self) -> "ComparisonMatrix":
        """The same result with numpy leaves (one transfer per leaf)."""
        return dataclasses.replace(
            self, **{f: _host(getattr(self, f)) for f in self._KEYS.values()})

    def __getitem__(self, key):
        if key not in self._KEYS:
            raise KeyError(key)
        return getattr(self, self._KEYS[key])

    def keys(self):
        return iter(self._KEYS)

    def items(self):
        return ((k, self[k]) for k in self._KEYS)

    def before(self):
        return self.le

    def after(self):
        return self.ge

    def concurrent(self):
        return self.conc

    def equal(self):
        return self.le & self.ge

    def confident(self, threshold: float):
        """"row -> col" claims whose Eq. 3 fp is within ``threshold``."""
        return self.le & (self.fp <= threshold)


@dataclasses.dataclass(frozen=True)
class ClassifyResult:
    """One-vs-many classification of a query clock against N peers."""

    q_le_p: torch.Tensor       # bool[N]: query ≼ peer (peer is ahead)
    p_le_q: torch.Tensor       # bool[N]: peer ≼ query (peer in our past)
    sum_q: torch.Tensor        # float32 scalar
    sum_p: torch.Tensor        # float32[N]
    fp_q_before_p: torch.Tensor  # float32[N]: Eq. 3 fp of "query -> peer"
    fp_p_before_q: torch.Tensor
    engine: Optional[str] = None      # dispatch metadata
    blocks: Optional[tuple] = None    # resolved block shapes

    _FIELDS = ("q_le_p", "p_le_q", "sum_q", "sum_p", "fp_q_before_p",
               "fp_p_before_q")

    @classmethod
    def from_dict(cls, d: dict, *, engine: str | None = None,
                  blocks: tuple | None = None) -> "ClassifyResult":
        return cls(**{k: d[k] for k in cls._FIELDS}, engine=engine,
                   blocks=blocks)

    def to_host(self) -> "ClassifyResult":
        """The same result with numpy leaves (one transfer per leaf)."""
        return dataclasses.replace(
            self, **{k: _host(getattr(self, k)) for k in self._FIELDS})

    def before(self):
        """Per-peer claim "query happened-before peer"."""
        return self.q_le_p

    def after(self):
        """Per-peer claim "peer happened-before query"."""
        return self.p_le_q

    def equal(self):
        return self.q_le_p & self.p_le_q

    def concurrent(self):
        return ~(self.q_le_p | self.p_le_q)

    def fp_before(self):
        """fp of "query -> peer"; exact (0) where the clocks are equal."""
        return _where(self.equal(), 0.0, self.fp_q_before_p)

    def fp_after(self):
        """fp of "peer -> query"; exact (0) where the clocks are equal."""
        return _where(self.equal(), 0.0, self.fp_p_before_q)

    def claimed_fp(self):
        """fp of the direction actually claimed per peer; SAME and
        FORKED verdicts are exact (paper §3) and report 0."""
        fp = _where(self.p_le_q, self.fp_p_before_q, self.fp_q_before_p)
        return _where(self.equal() | self.concurrent(), 0.0, fp)

    def confident(self, threshold: float):
        """The uniform Eq. 3 gate over the claimed direction."""
        return self.claimed_fp() <= threshold
