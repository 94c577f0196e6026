"""State carried across from the JAX package.

Builds the port's objects from the JAX package's state, given as numpy
arrays (``np.asarray`` of its device arrays) and plain values, so the
same clock, history, registry, hybrid engine, tiered registry, model
weights or training state run in both.  The bits are copied as they are: int32
wrap-around, u8 residuals, bases, cached float32 sums and CRCs,
bfloat16 weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import clock as bc
from repro_torch.core import history as hist

__all__ = ["clock_from_state", "history_from_state", "hybrid_from_state",
           "params_from_jax", "registry_from_state", "tiered_from_state",
           "train_state_from_jax"]


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


def params_from_jax(params: dict, cfg, device=None) -> dict:
    """The JAX package's model weights (path -> numpy array, e.g.
    ``{k: np.asarray(v) for k, v in init_params(key, cfg).items()}``)
    as the port's flat dict on ``device`` (None = the card), checked
    against ``models.params.param_table(cfg)``: the same paths, shapes
    and dtypes.  bfloat16 leaves (``ml_dtypes`` arrays, which
    ``torch.from_numpy`` refuses) cross as their uint16 bits."""
    from repro_torch.device import resolve_device
    from repro_torch.models.params import param_table

    dev = resolve_device(device)
    table = param_table(cfg)
    if set(params) != set(table):
        raise ValueError(f"param paths differ from the table: missing "
                         f"{sorted(set(table) - set(params))}, extra "
                         f"{sorted(set(params) - set(table))}")
    out = {}
    for path, info in table.items():
        a = np.asarray(params[path])
        if a.shape != tuple(info.shape) or a.dtype.name != info.dtype:
            raise ValueError(f"{path}: {a.dtype.name}{list(a.shape)} != "
                             f"{info.dtype}{list(info.shape)}")
        if info.dtype == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        out[path] = t.to(dev)
    return out


def train_state_from_jax(state, cfg, device=None):
    """The JAX package's ``TrainState`` with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, state)``; a dict with the same four keys
    also serves) as the port's ``runtime.training.TrainState`` on
    ``device`` (None = the card).  The params go through
    ``params_from_jax``; each moment is checked against its param: a
    float32 array of the param's shape, or an int8 ``Moment`` (codes
    [..., d padded to 128], float32 scales [..., d padded / 128], ``d``
    the param's last dim); the clock cells must be int32 [m]."""
    from repro_torch.device import resolve_device
    from repro_torch.optim.adamw import Moment, _BLOCK
    from repro_torch.runtime.training import TrainState

    dev = resolve_device(device)

    def get(key):
        return state[key] if isinstance(state, dict) else getattr(state, key)

    params = params_from_jax(get("params"), cfg, device=dev)
    opt = get("opt")

    def moment(x, p: torch.Tensor, path: str):
        shape = tuple(p.shape)
        if hasattr(x, "codes"):
            codes, scale = np.asarray(x.codes), np.asarray(x.scale)
            padded = shape[:-1] + (shape[-1] + (-shape[-1]) % _BLOCK,)
            want = [("int8", padded), ("float32",
                                       padded[:-1] + (padded[-1] // _BLOCK,))]
            for a, (dt, shp), what in zip((codes, scale), want,
                                          ("codes", "scales")):
                if a.dtype.name != dt or a.shape != shp:
                    raise ValueError(f"{path} moment {what}: {a.dtype.name}"
                                     f"{list(a.shape)} != {dt}{list(shp)}")
            if int(x.d) != shape[-1]:
                raise ValueError(f"{path} moment d {x.d} != {shape[-1]}")
            return Moment(_t(codes, np.int8, dev), _t(scale, np.float32, dev),
                          d=int(x.d))
        a = np.asarray(x)
        if a.dtype.name != "float32" or a.shape != shape:
            raise ValueError(f"{path} moment: {a.dtype.name}{list(a.shape)} "
                             f"!= float32{list(shape)}")
        return _t(a, np.float32, dev)

    moments = {}
    for name in ("m", "v"):
        if set(opt[name]) != set(params):
            raise ValueError(f"opt[{name!r}] paths differ from the params")
        moments[name] = {k: moment(opt[name][k], p, f"{name}/{k}")
                         for k, p in params.items()}
    cells = np.asarray(get("clock_cells"))
    if cells.dtype.name != "int32" or cells.ndim != 1:
        raise ValueError(f"clock cells: {cells.dtype.name}{list(cells.shape)}"
                         f" != int32[m]")
    return TrainState(
        params=params,
        opt={**moments, "step": _t(opt["step"], np.int32, dev)},
        clock_cells=_t(cells, np.int32, dev),
        step=_t(get("step"), np.int32, dev))


def registry_from_state(state: dict, m: int, k: int = 4, *, mesh=None,
                        policy=None, device=None):
    """A ``ClockRegistry`` holding the JAX registry's slab, on one device
    or row-sharded over ``mesh`` (``launch.mesh.FleetMesh``).

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
    reg = ClockRegistry(capacity, m, k, mesh=mesh, policy=policy,
                        device=device)
    alive = np.asarray(state["alive"], bool)
    reg._load(cells_u8, np.asarray(state["base"], np.int32),
              np.asarray(state["sums"], np.float32), alive)
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


def tiered_from_state(state: dict, *, device=None, policy=None,
                      spill_dir=None):
    """A ``TieredRegistry`` holding the JAX tiered registry's three tiers,
    so that both continue from the same state.

    ``state`` keys: ``cfg`` (a dict of ``TierConfig`` fields; its
    ``spill_dir`` is replaced by ``spill_dir``, a fresh temporary
    directory when None), ``m``, ``k``, ``hot`` (the hot slab, keyed as
    ``registry_from_state`` takes it, with ``free``), the warm arrays
    ``w_u8`` [W, m] uint8, ``w_base`` [W] int64, ``w_sums`` [W] float32,
    ``w_alive`` [W] bool, ``w_wide`` {slot: [m] int32 row},
    ``w_slot_of`` {sid: slot}, ``w_free`` (the free-slot stack), ``cold``
    {sid: frame bytes} in index order (appended to the port's own spill
    file), the access bookkeeping ``tier_of``, ``access``, ``age``,
    ``promoted_at`` (dicts) and ``age_seq``, ``window_touches``,
    ``window_migrations``, ``promotions``, ``demotions``, ``spills``,
    ``promotion_deferrals``.
    """
    from repro_torch.serve.tiers import TierConfig, TieredRegistry, _fold_i32

    fields = {f.name for f in dataclasses.fields(TierConfig)} - {"spill_dir"}
    cfg = TierConfig(**{k: v for k, v in state["cfg"].items() if k in fields},
                     spill_dir=spill_dir)
    m, k = int(state["m"]), int(state["k"])
    t = TieredRegistry(cfg, m=m, k=k, policy=policy, device=device)
    t.hot = registry_from_state(state["hot"], m, k, policy=t.policy,
                                device=t.device)
    t.hot.on_evict = t._ingest_warm
    t.engine = t.hot.engine
    w_u8 = np.asarray(state["w_u8"], np.uint8)
    if w_u8.shape != t._w_u8.shape:
        raise ValueError(f"w_u8 shape {w_u8.shape} != {t._w_u8.shape}")
    t._w_u8[:] = w_u8
    t._w_base[:] = np.asarray(state["w_base"], np.int64)
    t._w_base32[:] = _fold_i32(t._w_base)
    t._w_sums[:] = np.asarray(state["w_sums"], np.float32)
    t._w_alive[:] = np.asarray(state["w_alive"], bool)
    t._w_wide = {int(s): np.array(row, np.int32)
                 for s, row in state["w_wide"].items()}
    t._w_slot_of = dict(state["w_slot_of"])
    t._w_free = [int(s) for s in state["w_free"]]
    f = t._spill_handle()
    for sid, frame in state["cold"].items():
        t._cold_index[sid] = (f.tell(), len(frame))
        f.write(bytes(frame))
    f.flush()
    for key in ("tier_of", "access", "age", "promoted_at"):
        setattr(t, f"_{key}", dict(state[key]))
    for key in ("age_seq", "window_touches", "window_migrations"):
        setattr(t, f"_{key}", int(state[key]))
    for key in ("promotions", "demotions", "spills", "promotion_deferrals"):
        setattr(t, key, int(state[key]))
    return t
