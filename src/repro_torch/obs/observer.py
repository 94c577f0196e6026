"""The Observer: one object that rides policies the way ``policy`` does.

``Observer(trace=..., metrics=..., audit=...)`` bundles the three
instrumentation sinks; any component left ``None`` is replaced by its
null twin, so instrumented code never branches — it always calls
``obs.trace.span(...)`` / ``obs.metrics.counter(...)`` / ``obs.audit
.record(...)`` and pays near-zero when the sink is off.

Threading: set ``CausalPolicy(observer=obs)`` and every consumer of the
policy — ``CausalEngine``, ``ClockRegistry``, ``ClockRuntime``,
``GossipConfig``-driven sessions, ``ServingEngine`` — picks it up with
no further arguments.  ``resolve(x)`` normalizes "maybe an Observer,
maybe None" call sites to a never-None observer.

``Observer.to_dir(path)`` is the batteries-included constructor used by
the ``--trace-dir`` launch flags: trace.jsonl + metrics.json +
audit.jsonl (with wire frames, so the audit replays standalone).
"""
from __future__ import annotations

import os

from repro_torch.obs.audit import NULL_AUDIT, AuditTrail
from repro_torch.obs.metrics import NULL_RECORDER, MetricsRecorder
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["Observer", "NULL_OBSERVER", "resolve"]


class Observer:
    """Bundle of trace/metrics/audit sinks (None components → null)."""

    __slots__ = ("trace", "metrics", "audit", "_dir")

    def __init__(self, trace=None, metrics=None, audit=None):
        self.trace = trace if trace is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_RECORDER
        self.audit = audit if audit is not None else NULL_AUDIT
        self._dir = None

    def __bool__(self) -> bool:
        return bool(self.trace) or bool(self.metrics) or bool(self.audit)

    # Policies carrying an observer stay hashable (identity semantics —
    # two policies share instrumentation iff they share the object).
    def __hash__(self) -> int:
        return id(self)

    def __eq__(self, other) -> bool:
        return self is other

    @classmethod
    def to_dir(cls, path) -> "Observer":
        """Full observer writing trace.jsonl / metrics.json / audit.jsonl
        (frames stored — the audit trail replays standalone)."""
        os.makedirs(path, exist_ok=True)
        obs = cls(
            trace=Tracer(os.path.join(path, "trace.jsonl")),
            metrics=MetricsRecorder(),
            audit=AuditTrail(os.path.join(path, "audit.jsonl"),
                             store_frames=True),
        )
        obs._dir = str(path)
        return obs

    def flush(self) -> None:
        self.trace.flush()
        self.audit.flush()
        if self._dir is not None and self.metrics:
            self.metrics.to_json(os.path.join(self._dir, "metrics.json"))

    def close(self) -> None:
        self.flush()
        self.trace.close()
        self.audit.close()


NULL_OBSERVER = Observer()


def resolve(obs) -> Observer:
    """Normalize an optional observer to a never-None one."""
    return obs if obs is not None else NULL_OBSERVER
