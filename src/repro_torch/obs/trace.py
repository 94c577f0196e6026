"""Nestable trace spans with monotonic timings and typed attributes.

A :class:`Tracer` hands out span context managers; entering a span
pushes it on a thread-local stack (so nesting needs no plumbing — a
``CausalEngine.classify`` span started inside a gossip session span
records that session as its parent automatically), and exiting emits
one JSONL record with the span's monotonic start/duration in
microseconds, its id/parent-id, process/thread ids, and its attributes.

Timing is ``time.perf_counter_ns`` relative to the tracer's origin —
monotonic within a process, immune to wall-clock steps.  A ``meta``
header line records the wall-clock origin so multi-process traces can
be aligned after the fact.

Attributes are *typed*: ``str``/``int``/``float``/``bool``/``None``
pass through verbatim; anything else is stringified at emit time so a
stray tensor in an attr can never make a record unserializable.

Disabled tracing costs near zero: :class:`NullTracer` returns one
shared no-op span object from every ``span()`` call — no allocation,
no clock read, no stack push.

``repro_torch.obs.export`` converts the JSONL stream to Chrome
``trace_event`` format (load in ``chrome://tracing`` / Perfetto).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time

__all__ = ["Tracer", "NullTracer", "NULL_TRACER"]

_ATTR_TYPES = (str, int, float, bool, type(None))


def _typed(attrs: dict) -> dict:
    return {k: (v if isinstance(v, _ATTR_TYPES) else str(v))
            for k, v in attrs.items()}


class _Span:
    """One live span: its own context manager, re-entrant never."""

    __slots__ = ("_tracer", "name", "sid", "parent", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.sid = next(tracer._ids)
        self.parent = None
        self._t0 = 0

    def set(self, **attrs) -> "_Span":
        """Attach attributes discovered mid-span (engine chosen, bytes
        moved, ...); later keys win."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self.parent = stack[-1].sid if stack else None
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self._tracer._stack().pop()
        self._tracer._emit(self, t1)
        return False


class Tracer:
    """Span factory + JSONL sink (in-memory always; file when ``path``)."""

    def __init__(self, path=None):
        self._path = str(path) if path else None
        self._events: list[dict] = []
        self._ids = itertools.count(1)
        self._tl = threading.local()
        self._lock = threading.Lock()
        self._origin_ns = time.perf_counter_ns()
        self.origin_unix = time.time()
        self._file = None
        if self._path:
            self._file = open(self._path, "w")
            self._file.write(json.dumps({
                "meta": {"origin_unix": self.origin_unix,
                         "pid": os.getpid()}}) + "\n")

    def __bool__(self) -> bool:
        return True

    def _stack(self) -> list:
        stack = getattr(self._tl, "stack", None)
        if stack is None:
            stack = self._tl.stack = []
        return stack

    def span(self, name: str, **attrs) -> _Span:
        """A context manager recording one complete span."""
        return _Span(self, name, _typed(attrs) if attrs else {})

    def _emit(self, span: _Span, t1_ns: int) -> None:
        ev = {
            "name": span.name,
            "sid": span.sid,
            "parent": span.parent,
            "ts_us": (span._t0 - self._origin_ns) / 1e3,
            "dur_us": (t1_ns - span._t0) / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "attrs": _typed(span.attrs),
        }
        with self._lock:
            self._events.append(ev)
            if self._file is not None:
                self._file.write(json.dumps(ev) + "\n")

    def events(self) -> list[dict]:
        """Snapshot of every span emitted so far (exit order: children
        before their parents)."""
        with self._lock:
            return list(self._events)

    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


class _NullSpan:
    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracing disabled: every ``span()`` is the same shared no-op."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def events(self) -> list:
        return []

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL_TRACER = NullTracer()
