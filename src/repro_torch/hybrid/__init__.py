"""Adaptive hybrid causality engine: exact hot set over the bloom tail.

``HybridEngine`` keeps exact prefix-chain clocks for a bounded hot set
(zero false positives, O(1) verdict math per hot row) layered over the
packed bloom slab for the long tail, fused into ONE kernel sweep per
``classify``.  ``AdaptivePolicy`` closes the loop from the measured
Eq. 3 fp signal back into the tail's (m, k) geometry against a declared
``fp_budget`` — operators set a budget, not clock parameters.
"""
from repro_torch.hybrid.adaptive import (AdaptiveConfig, AdaptivePolicy,
                                         derive_mk, fold_pow2, replay_resize)
from repro_torch.hybrid.engine import (HybridConfig, HybridEngine,
                                       HybridSlab, HybridView)

__all__ = [
    "AdaptiveConfig",
    "AdaptivePolicy",
    "HybridConfig",
    "HybridEngine",
    "HybridSlab",
    "HybridView",
    "derive_mk",
    "fold_pow2",
    "replay_resize",
]
