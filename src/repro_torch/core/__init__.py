"""The Bloom Clock and its ecosystem, on PyTorch.

- ``clock``        BloomClock + tick/merge/ordering/fp_rate/compress
- ``vector_clock`` exact O(N) baseline the paper compares against
- ``hashing``      event-id mixing + double-hashed bloom indices
- ``history``      §3 moving-window predecessor refinement
- ``sim``          N-node protocol simulator with ground-truth scoring
- ``wire``         binary frame/digest encoding (numpy only)
"""
from repro_torch.core import clock, hashing, history, sim, vector_clock, wire  # noqa: F401
from repro_torch.core.clock import (  # noqa: F401
    BloomClock,
    fp_rate,
    merge,
    ordering,
    tick,
    zeros,
)
