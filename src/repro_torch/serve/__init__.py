"""Causality-as-a-service: streaming admission over a tiered registry.

- ``tiers``    — hot card slab → warm packed (pinned) host tier → cold
  disk frames, access-driven promotion/demotion, one ``classify`` front
  door bit-identical to a flat slab;
- ``pipeline`` — bounded-queue continuous-batching admission with two
  pinned staging slots and a §4-CRC digest cache, every acted-on
  verdict audited gossip-style;
- ``churn``    — seeded million-session arrival/expiry/migration driver
  with Zipf access skew and a vector-clock ground truth.
"""
from repro_torch.serve.churn import ChurnConfig, ChurnReport, run_churn
from repro_torch.serve.pipeline import (
    AdmissionPipeline,
    AdmissionTicket,
    AdmissionVerdict,
    PipelineConfig,
)
from repro_torch.serve.tiers import TierConfig, TieredRegistry, TieredView

__all__ = [
    "TierConfig",
    "TieredRegistry",
    "TieredView",
    "PipelineConfig",
    "AdmissionPipeline",
    "AdmissionTicket",
    "AdmissionVerdict",
    "ChurnConfig",
    "ChurnReport",
    "run_churn",
]
