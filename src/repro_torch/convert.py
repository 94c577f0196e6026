"""State carried across from the JAX package.

Builds the port's objects from the JAX package's state, given as numpy
arrays (``np.asarray`` of its device arrays) and plain values, so the
same clock, history, registry or hybrid engine runs in both.  The bits
are copied as they are: int32 wrap-around, u8 residuals, bases, cached
float32 sums and CRCs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import clock as bc
from repro_torch.core import history as hist

__all__ = ["clock_from_state", "history_from_state", "hybrid_from_state",
           "registry_from_state"]


def _t(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=dtype), device=device)


def clock_from_state(cells, base, k: int, device=None) -> bc.BloomClock:
    """A ``BloomClock`` from int32 ``cells`` [..., m] and ``base`` [...]."""
    return bc.BloomClock(cells=_t(cells, np.int32, device),
                         base=_t(base, np.int32, device), k=int(k))


def history_from_state(cells, sums, count, k: int,
                       device=None) -> hist.History:
    """A ``History`` from its ring ``cells`` [W, m], ``sums`` [W] and
    ``count``."""
    return hist.History(cells=_t(cells, np.int32, device),
                        sums=_t(sums, np.float32, device),
                        count=_t(count, np.int32, device), k=int(k))


def registry_from_state(state: dict, m: int, k: int = 4, *, policy=None,
                        device=None):
    """A ``ClockRegistry`` holding the JAX registry's slab.

    ``state`` keys: ``cells_u8`` [N, m] uint8, ``base`` [N] int32,
    ``sums`` [N] float32, ``alive`` [N] bool, ``slot_of`` {peer: slot},
    ``wide`` {slot: [m] int32 logical row}, ``crc`` [N] int64 per-slot
    CRCs, and optionally ``free`` (the free-slot stack; default: the
    unused slots in the order a fresh registry hands them out).
    """
    from repro_torch.fleet.registry import ClockRegistry

    cells_u8 = np.asarray(state["cells_u8"], np.uint8)
    capacity = cells_u8.shape[0]
    if cells_u8.shape != (capacity, m):
        raise ValueError(f"cells_u8 shape {cells_u8.shape} != ({capacity}, {m})")
    reg = ClockRegistry(capacity, m, k, policy=policy, device=device)
    reg.cells_u8.copy_(_t(cells_u8, np.uint8, reg.device))
    reg.base.copy_(_t(state["base"], np.int32, reg.device))
    reg.sums.copy_(_t(state["sums"], np.float32, reg.device))
    alive = np.asarray(state["alive"], bool)
    reg.alive.copy_(_t(alive, np.bool_, reg.device))
    reg._alive_host = alive.copy()
    reg._base_host = np.asarray(state["base"], np.int64).copy()
    reg._crc_host = np.asarray(state["crc"], np.int64).copy()
    reg._wide = {int(s): np.asarray(row, np.int32).copy()
                 for s, row in state["wide"].items()}
    reg._slot_of = dict(state["slot_of"])
    used = set(reg._slot_of.values())
    reg._free = (list(state["free"]) if "free" in state else
                 [s for s in range(capacity - 1, -1, -1) if s not in used])
    return reg


def hybrid_from_state(state: dict, *, device=None, policy=None,
                      observer=None, audit=None):
    """A ``HybridEngine`` holding the JAX hybrid engine's host state, so
    that both classify identically.

    ``state`` keys: ``cfg`` (a dict of ``HybridConfig`` fields; keys the
    port has no field for, such as ``interpret``, are ignored), ``m``,
    ``probes`` [V, k] int64 chain probes, ``local_cells`` [m] int64,
    ``sessions`` {sid: dict of ``v``, ``events`` ((hi, lo), ...),
    ``access``, ``hot``, ``slot``, ``promoted_window``} in the engine's
    order, ``hot`` (hot sids in device row order), the tail arrays
    ``t_u8`` [C, m] uint8, ``t_base`` [C] int64, ``t_sums`` [C] float32,
    ``t_alive`` [C] bool, ``t_wide`` {slot: [m] int32 row}, ``t_free``
    (the free-slot stack), and ``window_idx``, ``window_touches``,
    ``window_migrations``, ``promotions``, ``demotions``, ``resizes``.
    """
    from repro_torch.hybrid.engine import HybridConfig, HybridEngine, _Session

    fields = {f.name for f in dataclasses.fields(HybridConfig)}
    cfg = HybridConfig(**{k: v for k, v in state["cfg"].items()
                          if k in fields})
    eng = HybridEngine(cfg, policy=policy, observer=observer, audit=audit,
                       device=device)
    m = int(state["m"])
    t_u8 = np.array(state["t_u8"], np.uint8)
    if t_u8.shape != (cfg.tail_capacity, m):
        raise ValueError(f"t_u8 shape {t_u8.shape} != "
                         f"({cfg.tail_capacity}, {m})")
    eng.m = m
    eng._probes = np.array(state["probes"], np.int64).reshape(-1, cfg.k)
    eng._local_cells = np.array(state["local_cells"], np.int64)
    for sid, d in state["sessions"].items():
        eng.sessions[sid] = _Session(
            v=int(d["v"]),
            events=tuple((int(h), int(l)) for h, l in d["events"]),
            access=int(d["access"]), hot=bool(d["hot"]),
            slot=None if d["slot"] is None else int(d["slot"]),
            promoted_window=int(d["promoted_window"]))
    eng._hot = {sid: eng.sessions[sid] for sid in state["hot"]}
    eng._cache_probes([e for s in eng.sessions.values() for e in s.events])
    eng._t_u8 = t_u8
    eng._t_base = np.array(state["t_base"], np.int64)
    eng._t_sums = np.array(state["t_sums"], np.float32)
    eng._t_alive = np.array(state["t_alive"], bool)
    eng._t_wide = {int(s): np.array(row, np.int32)
                   for s, row in state["t_wide"].items()}
    eng._t_free = [int(s) for s in state["t_free"]]
    for key in ("window_idx", "window_touches", "window_migrations"):
        setattr(eng, f"_{key}", int(state[key]))
    for key in ("promotions", "demotions", "resizes"):
        setattr(eng, key, int(state[key]))
    return eng
