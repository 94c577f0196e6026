"""Fleet health views built on the all-pairs kernels.

``fleet_health`` runs one ``registry.all_pairs`` call (the symmetric
packed-triangle kernel over the alive rows, plus the exact int32 rim
for promoted rows), brings its matrices to the host with ``to_host``,
and derives on host numpy:

- **fork components**: connected components of the comparability graph
  (peers i, j connected iff their clocks are ordered either way).  A
  healthy fleet is one component; every extra one is a fork.  They run
  through ``scipy.sparse.csgraph`` when scipy is importable, else
  through a Python union-find; labels are canonical either way.
- **straggler mask**: alive peers whose clock sum lags the alive median
  by more than ``straggler_gap``.
- **predicted-fp histogram**: log10-binned Eq. 3 fp over the strict
  ordered pairs.  ``fp_within_band`` checks a measured rate against it.

``watch()`` samples ``fleet_health`` periodically into an ``Observer``'s
metrics (gauges and the streaming fp histogram), each sample inside a
``fleet.health`` span, and yields every snapshot.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import numpy as np

from repro_torch.obs.observer import resolve

try:
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components as _scipy_cc
except ImportError:
    _scipy_cc = None

__all__ = ["FleetHealth", "fleet_health", "fork_components",
           "fp_within_band", "record_health", "watch"]


@dataclasses.dataclass
class FleetHealth:
    n_alive: int
    comparable_fraction: float    # ordered pairs / alive pairs
    component: np.ndarray         # [capacity] component label, -1 for dead
    n_components: int             # fork count: healthy == 1 (or 0 if empty)
    straggler_mask: np.ndarray    # [capacity] bool
    sums: np.ndarray              # [capacity] float32 clock sums
    fp_hist: np.ndarray           # counts per log10-fp bin (strict pairs)
    fp_bin_edges: np.ndarray      # len(fp_hist) + 1 edges, log10(fp)
    mean_strict_fp: float         # mean Eq. 3 fp over STRICT ordered pairs
                                  # (dominance holds, clocks differ);
                                  # 0.0 when no strict pair exists
    shards: int = 1               # row shards the registry slab spans

    @property
    def mean_predicted_fp(self) -> float:
        """The reference's older name of ``mean_strict_fp`` (the value
        was always over strict pairs only)."""
        return self.mean_strict_fp

    def summary(self) -> str:
        return (
            f"alive={self.n_alive} components={self.n_components} "
            f"comparable={self.comparable_fraction:.3f} "
            f"stragglers={int(self.straggler_mask.sum())} "
            f"mean_strict_fp={self.mean_strict_fp:.3e} "
            f"shards={self.shards}"
        )


def _fork_components_py(comparable: np.ndarray,
                        alive: np.ndarray) -> tuple[np.ndarray, int]:
    """Union-find over the alive comparable pairs (O(pairs) in Python)."""
    n = comparable.shape[0]
    parent = np.arange(n)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    ii, jj = np.nonzero(comparable & alive[:, None] & alive[None, :])
    for i, j in zip(ii.tolist(), jj.tolist()):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj

    labels = np.full(n, -1, np.int64)
    roots: dict[int, int] = {}
    for i in np.flatnonzero(alive):
        r = find(int(i))
        labels[i] = roots.setdefault(r, len(roots))
    return labels, len(roots)


def fork_components(comparable: np.ndarray,
                    alive: np.ndarray) -> tuple[np.ndarray, int]:
    """Connected components of the comparability graph over alive slots.

    Returns (labels, count); dead slots get label -1.  Labels are
    canonical, numbered by first occurrence in ascending slot order, so
    the scipy and union-find paths return identical arrays.
    """
    alive = np.asarray(alive, bool)
    if _scipy_cc is None:
        return _fork_components_py(comparable, alive)
    aidx = np.flatnonzero(alive)
    labels = np.full(comparable.shape[0], -1, np.int64)
    if aidx.size == 0:
        return labels, 0
    sub = np.asarray(comparable, bool)[np.ix_(aidx, aidx)]
    n_comp, sub_labels = _scipy_cc(csr_matrix(sub), directed=False)
    # canonical relabel: component ids by first occurrence
    _, first = np.unique(sub_labels, return_index=True)
    rank = np.empty(n_comp, np.int64)
    rank[np.argsort(first)] = np.arange(n_comp)
    labels[aidx] = rank[sub_labels]
    return labels, int(n_comp)


def fp_within_band(measured_fp: float, mean_predicted_fp: float,
                   slack: float = 3.0, abs_tol: float = 0.01) -> bool:
    """Is a measured false-positive rate consistent with the Eq. 3
    prediction?  Eq. 3 is an independence approximation, so accept a
    multiplicative slack plus an absolute floor for small samples."""
    return measured_fp <= mean_predicted_fp * slack + abs_tol


def fleet_health(registry, *, straggler_gap: float = 64.0, fp_bins: int = 12,
                 **matrix_kw) -> FleetHealth:
    """One all-pairs call -> full fleet health snapshot.  With the
    registry's observer on, ``fleet.health.pairs`` spans the all-pairs
    call and the transfer of its matrices, ``fleet.health.host`` the
    host-side derivations."""
    obs = registry.obs
    with obs.trace.span("fleet.health.pairs"):
        h = registry.all_pairs(**matrix_kw).to_host()
    with obs.trace.span("fleet.health.host"):
        alive = registry.alive.cpu().numpy()
        n_alive = int(alive.sum())

        le = h.before()
        ge = h.after()
        comparable = le | ge
        np.fill_diagonal(comparable, False)

        pair_mask = alive[:, None] & alive[None, :]
        np.fill_diagonal(pair_mask, False)
        n_pairs = int(pair_mask.sum())
        n_ordered = int((comparable & pair_mask).sum())

        labels, n_components = fork_components(comparable, alive)

        sums = h.row_sums
        straggler = np.zeros_like(alive)
        if n_alive:
            med = float(np.median(sums[alive]))
            straggler = alive & ((med - sums) > straggler_gap)

        # strict ordered claims row -> col: dominance holds, clocks differ
        strict = le & ~h.equal() & pair_mask
        fps = h.fp[strict]
        edges = np.linspace(-30.0, 0.0, fp_bins + 1)
        hist, _ = np.histogram(np.log10(np.clip(fps, 1e-30, 1.0)), bins=edges)

    return FleetHealth(
        n_alive=n_alive,
        comparable_fraction=n_ordered / max(n_pairs, 1),
        component=labels,
        n_components=n_components,
        straggler_mask=straggler,
        sums=sums,
        fp_hist=hist,
        fp_bin_edges=edges,
        mean_strict_fp=float(fps.mean()) if fps.size else 0.0,
        shards=registry.n_shards,
    )


def record_health(health: FleetHealth, metrics) -> None:
    """Fold one health snapshot into a metrics registry."""
    metrics.gauge("fleet_alive").set(health.n_alive)
    metrics.gauge("fleet_components").set(health.n_components)
    metrics.gauge("fleet_comparable_fraction").set(
        health.comparable_fraction)
    metrics.gauge("fleet_stragglers").set(int(health.straggler_mask.sum()))
    metrics.gauge("fleet_mean_strict_fp").set(health.mean_strict_fp)
    metrics.histogram(
        "fleet_fp", edges=tuple(float(e) for e in health.fp_bin_edges),
    ).add_counts(health.fp_hist)
    metrics.counter("fleet_health_samples").inc()


def watch(registry, *, interval: float = 5.0, samples: Optional[int] = None,
          observer=None, **health_kw) -> Iterator[FleetHealth]:
    """Periodic ``fleet_health`` sampling into an Observer's metrics.

    A generator: every ``interval`` seconds (starting immediately) it
    takes one snapshot inside a ``fleet.health`` span, records it and
    yields it, for ``samples`` ticks (None = forever).  The observer
    resolves from the argument, else the registry's policy; with
    neither, snapshots still yield but record nowhere.
    """
    obs = resolve(observer if observer is not None
                  else registry.policy.observer)
    taken = 0
    while samples is None or taken < samples:
        with obs.trace.span("fleet.health", shards=registry.n_shards):
            health = fleet_health(registry, **health_kw)
        record_health(health, obs.metrics)
        taken += 1
        yield health
        if samples is not None and taken >= samples:
            break
        time.sleep(interval)
