"""Process-local metrics: counters, gauges, and streaming histograms.

A :class:`MetricsRecorder` hands out named instruments with optional
label sets — ``rec.counter("gossip_bytes", phase="digest")`` — keyed on
``(kind, name, sorted labels)`` so the same call site always returns
the same instrument.  Everything is plain Python + numpy; no exporter
dependencies, one ``dump()`` call serializes the whole registry.

The histogram is *streaming* with fixed bin edges in **log10 space**
(defaulting to the Eq. 3 fp bands used by ``fleet_health``): samples
are clipped into the edge range, binned with ``np.histogram``, and only
the per-bin counts plus count/total/min/max survive.  Two histograms
over the same edges merge exactly — merging recorders from two
processes is identical to one recorder having seen the concatenated
sample stream (the property test in ``tests/test_obs.py`` pins this).

Disabled metrics cost near zero: :class:`NullRecorder` returns shared
no-op instruments — no dict lookup, no allocation.
"""
from __future__ import annotations

import json
import math
import threading

import numpy as np

__all__ = [
    "Counter", "Gauge", "Histogram", "FP_LOG10_EDGES",
    "MetricsRecorder", "NullRecorder", "NULL_RECORDER",
]

# log10(fp) bands matching fleet_health's fp_bins=12 default over
# [1e-30, 1]; a 13-edge linspace gives 12 bins plus under/overflow
# handled by clipping.
FP_LOG10_EDGES = tuple(np.linspace(-30.0, 0.0, 13).tolist())


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def as_dict(self) -> dict:
        return {"value": self.value}


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = float(v)

    def as_dict(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed-edge log10-binned streaming histogram with exact merge."""

    __slots__ = ("edges", "counts", "count", "total", "vmin", "vmax",
                 "_edges_arr", "_floor")

    def __init__(self, edges=FP_LOG10_EDGES):
        self.edges = tuple(float(e) for e in edges)
        self.counts = np.zeros(len(self.edges) - 1, np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self._edges_arr = np.asarray(self.edges)
        self._floor = 10.0 ** self.edges[0]

    def _bin_of(self, logs):
        """Bin indices matching np.histogram's convention: right-open
        bins, the last bin closed (``logs`` already clipped to range)."""
        idx = np.searchsorted(self._edges_arr, logs, side="right") - 1
        return np.clip(idx, 0, self.counts.size - 1)

    def observe(self, v) -> None:
        # scalar fast path: the hot per-session call sites observe one
        # value at a time, so skip the array round-trip
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        log = math.log10(v) if v > self._floor else self.edges[0]
        log = min(log, self.edges[-1])
        self.counts[int(self._bin_of(log))] += 1

    def observe_many(self, values) -> None:
        vals = np.asarray(values, np.float64).ravel()
        if vals.size == 0:
            return
        self.count += int(vals.size)
        self.total += float(vals.sum())
        lo, hi = (float(vals.min()), float(vals.max()))
        self.vmin = lo if self.vmin is None else min(self.vmin, lo)
        self.vmax = hi if self.vmax is None else max(self.vmax, hi)
        # values are raw fp probabilities; bin in log10 space, clipping
        # zeros/underflow into the lowest bin and >=1 into the highest.
        logs = np.log10(np.clip(vals, self._floor, None))
        logs = np.clip(logs, self.edges[0], self.edges[-1])
        self.counts += np.bincount(self._bin_of(logs),
                                   minlength=self.counts.size)

    def add_counts(self, counts) -> None:
        """Fold pre-binned counts (e.g. ``FleetHealth.fp_hist``) in;
        bins must align with this histogram's edges."""
        counts = np.asarray(counts, np.int64)
        if counts.shape != self.counts.shape:
            raise ValueError(
                f"bin mismatch: {counts.shape} vs {self.counts.shape}")
        self.counts += counts
        self.count += int(counts.sum())

    def merge(self, other: "Histogram") -> None:
        if self.edges != other.edges:
            raise ValueError("cannot merge histograms with different edges")
        self.counts += other.counts
        self.count += other.count
        self.total += other.total
        for attr, pick in (("vmin", min), ("vmax", max)):
            ov = getattr(other, attr)
            if ov is not None:
                sv = getattr(self, attr)
                setattr(self, attr, ov if sv is None else pick(sv, ov))

    def as_dict(self) -> dict:
        return {
            "edges": list(self.edges),
            "counts": self.counts.tolist(),
            "count": self.count,
            "total": self.total,
            "min": self.vmin,
            "max": self.vmax,
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRecorder:
    """Registry of named, labeled instruments."""

    def __init__(self):
        self._instruments: dict = {}
        self._lock = threading.Lock()

    def __bool__(self) -> bool:
        return True

    def _get(self, kind: str, name: str, labels: dict, **kw):
        key = (kind, name, tuple(sorted(labels.items())))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = self._instruments[key] = _KINDS[kind](**kw)
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, edges=FP_LOG10_EDGES, **labels) -> Histogram:
        return self._get("histogram", name, labels, edges=edges)

    def merge(self, other: "MetricsRecorder") -> None:
        """Fold another recorder in (counters add, gauges take theirs,
        histograms merge exactly)."""
        with other._lock:
            items = list(other._instruments.items())
        for (kind, name, labels), inst in items:
            mine = self._get(kind, name, dict(labels),
                             **({"edges": inst.edges}
                                if kind == "histogram" else {}))
            if kind == "counter":
                mine.inc(inst.value)
            elif kind == "gauge":
                if inst.value is not None:
                    mine.set(inst.value)
            else:
                mine.merge(inst)

    def dump(self) -> list:
        """Every instrument as a JSON-ready record."""
        with self._lock:
            items = sorted(self._instruments.items(),
                           key=lambda kv: (kv[0][0], kv[0][1], kv[0][2]))
        return [
            {"kind": kind, "name": name, "labels": dict(labels),
             **inst.as_dict()}
            for (kind, name, labels), inst in items
        ]

    def to_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.dump(), f, indent=1)


class _NullInstrument:
    __slots__ = ()

    def inc(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    def observe_many(self, values) -> None:
        pass

    def add_counts(self, counts) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullRecorder:
    """Metrics disabled: every instrument is the same shared no-op."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def counter(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, edges=FP_LOG10_EDGES, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def dump(self) -> list:
        return []

    def to_json(self, path) -> None:
        pass


NULL_RECORDER = NullRecorder()
