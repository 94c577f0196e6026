"""Fleet-wide causality observability: spans, metrics, audit trail.

Three sinks, one rider object:

- ``obs.trace``   — nestable span contexts -> JSONL -> Chrome trace
- ``obs.metrics`` — counters / gauges / streaming log10 fp histograms
- ``obs.audit``   — append-only acted-on verdict log with replay

``Observer`` bundles them and rides ``CausalPolicy(observer=...)`` the
same way ``policy`` rides everything else; disabled sinks are null
objects with near-zero call cost.  This package imports nothing from
the rest of ``repro_torch`` at module level (audit replay lazy-imports), so
any layer can depend on it without cycles.
"""
from repro_torch.obs.audit import NULL_AUDIT, AuditRecord, AuditTrail, NullAudit, ReplayReport
from repro_torch.obs.metrics import (
    FP_LOG10_EDGES,
    NULL_RECORDER,
    Counter,
    Gauge,
    Histogram,
    MetricsRecorder,
    NullRecorder,
)
from repro_torch.obs.observer import NULL_OBSERVER, Observer, resolve
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "Observer", "NULL_OBSERVER", "resolve",
    "Tracer", "NullTracer", "NULL_TRACER",
    "MetricsRecorder", "NullRecorder", "NULL_RECORDER",
    "Counter", "Gauge", "Histogram", "FP_LOG10_EDGES",
    "AuditTrail", "AuditRecord", "NullAudit", "NULL_AUDIT", "ReplayReport",
]
