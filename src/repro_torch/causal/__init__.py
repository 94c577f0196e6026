"""Unified causality API: one policy, two verbs, typed results.

    from repro_torch import causal

    engine = causal.CausalEngine(causal.CausalPolicy(fp_threshold=1e-4))
    engine.classify(query, peers)   # one-vs-many -> ClassifyResult
    engine.pairs(clocks)            # all-pairs   -> ComparisonMatrix
    causal.compare(a, b)            # pairwise    -> Comparison
"""
from repro_torch.causal.engine import CausalEngine, PackedSlab, compare
from repro_torch.causal.policy import CausalPolicy
from repro_torch.causal.results import (
    ClassifyResult,
    Comparison,
    ComparisonMatrix,
)

__all__ = [
    "CausalEngine",
    "CausalPolicy",
    "PackedSlab",
    "Comparison",
    "ComparisonMatrix",
    "ClassifyResult",
    "compare",
]
