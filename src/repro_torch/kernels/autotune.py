"""Cost-model-guided block-shape and engine selection for the CUDA kernels.

The right (engine, bi, bj, bm, bn) for the compare kernels depends on
the card: the all-pairs kernels' time follows their CTAs an SM, and a
one-vs-many CTA of bn warps stages the whole query.  The search has two
stages, as in the reference:

1. **Analytic cost model** (``predict_cost``, ``predict_hybrid_cost``,
   ``predict_one_vs_many_cost``): per candidate, the shared memory a CTA
   asks for (``template.smem_estimate``; a candidate that does not fit
   is infinite), the CTAs an SM from threads, registers and shared
   memory (``template.ctas_per_sm``), the waves of the grid, and
   time = max(bytes / 3.35 TB/s, instructions / (33.45 T a second x
   min(1, resident warps / 32))) + waves x 1 us + 4 us (+ 0.6 us for
   each one-vs-many CTA an SM holds, which stages the query).  The
   instruction counts are the built kernels' hot loops (``[sass]`` in
   ``chip_smoke.py``; ``PERF.md`` §3).  Candidates are RANKED by
   prediction and only the top half (at most 8) survive: the model
   prunes, it never has the final word.  On the CPU, which runs the
   plain versions, the model is the reference's interpret model (step
   overhead plus elements).
2. **Measured ranking**: survivors race on the live device, with the
   built-in blocks beside them where the model pruned those (on the
   card CUDA events around one call queued behind a sleep kernel, after
   a warm call, best of 3; on the CPU ``perf_counter``); the fastest
   wins the table entry.

Winners are cached in a JSON table keyed by

    op | backend | N-bucket | M-bucket | m-bucket | s<shards>

with backend ``cuda`` or ``cpu`` and shape buckets powers of two,
rounded up.  ``kernels.ops`` consults ``lookup`` on every one-vs-many,
hybrid and all-pairs dispatch that is not given its blocks and falls
back to the built-in blocks when the table has no entry.  The shipped
table holds only ``cuda`` keys, so a CPU run resolves the built-in
blocks.

The ``matrix_sharded`` op records a **strategy** for a row-sharded
slab: ``ring`` (the halved block-row ring) or ``replicated`` (gather
the slab onto the first card, run tri there), which
``ops._compare_matrix_packed_sharded`` dispatches on
(``predict_sharded_cost``, ``autotune_matrix_sharded``, ``--shards``).
Its entries are measured on distinct cards and read only there: a CUDA
mesh whose shards share a card neither writes nor reads one
(``sharded_table_ok``), and keeps the default, ``ring``.

Regenerate the shipped table on the card with

    PYTHONPATH=src python -m repro_torch.kernels.autotune --write --explain

(add ``--sizes matrix:16384x1024 --shards 2 4`` on a host with four
cards for the sharded entries) which sweeps the shapes the paths run
(``DEFAULT_SIZES``) and merges the
winners into ``autotune_table.json`` next to this module (or ``--out
PATH`` / ``$REPRO_TORCH_AUTOTUNE_TABLE``).  ``--explain`` prints the
model's predicted ranking next to the measured times; ``--trace-dir``
records one ``autotune.sweep`` span per sweep and the search counters
through a ``repro_torch.obs`` Observer.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import template as tp

__all__ = [
    "CACHE_STATS",
    "DEFAULT_SIZES",
    "SEARCH_STATS",
    "autotune_hybrid",
    "autotune_matrix",
    "autotune_matrix_sharded",
    "autotune_one_vs_many",
    "autotune_shapes",
    "backend_of",
    "key_for",
    "load_table",
    "lookup",
    "parse_size",
    "predict_cost",
    "predict_hybrid_cost",
    "predict_one_vs_many_cost",
    "predict_sharded_cost",
    "prune",
    "save_table",
    "sharded_table_ok",
    "table_path",
]

_DEFAULT_TABLE = Path(__file__).parent / "autotune_table.json"
_ENV = "REPRO_TORCH_AUTOTUNE_TABLE"

_table_cache: dict | None = None
_table_cache_path: str | None = None

#: the shapes the port's paths run: the main path's classify, the
#: all-pairs slab, the serving tiers' pin (hot + warm) and a serving
#: batch, and the hybrid classify (hot count in the M slot)
DEFAULT_SIZES = ("one_vs_many:65536x1024", "matrix:16384x1024",
                 "one_vs_many:69632x256", "one_vs_many:256x256",
                 "hybrid:69628x1024h4089")

#: candidate knobs: one-vs-many and hybrid warps a CTA and m-tiles
BNS = (4, 8, 16, 32)
BMS = (128, 256, 512, 1024)
_LANE = 128


def table_path() -> Path:
    return Path(os.environ.get(_ENV, _DEFAULT_TABLE))


def load_table() -> dict:
    global _table_cache, _table_cache_path
    path = table_path()
    if _table_cache is not None and _table_cache_path == str(path):
        return _table_cache
    try:
        with open(path) as f:
            _table_cache = json.load(f)
    except (OSError, ValueError):
        _table_cache = {}
    _table_cache_path = str(path)
    return _table_cache


def save_table(table: dict, path: Path | None = None) -> Path:
    global _table_cache, _table_cache_path
    path = path or table_path()
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    _table_cache, _table_cache_path = table, str(path)
    return path


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def backend_of(device) -> str:
    """Table backend of a device or tensor: ``cuda`` or ``cpu``."""
    if isinstance(device, torch.Tensor):
        device = device.device
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def _check_backend(backend) -> str:
    """``backend`` ("cuda" or "cpu"); a bool there is the reference's
    positional ``interpret``, which names no backend of this table."""
    if isinstance(backend, bool):
        raise TypeError("backend is 'cuda' or 'cpu' (backend_of); the "
                        "reference's interpret flag goes by keyword, "
                        "interpret=, and changes nothing here")
    return backend


def key_for(op: str, N: int, M: int, m: int, backend: str,
            shards: int = 1, *, interpret: bool | None = None) -> str:
    """Table key.  The shard count is explicit, so a d-shard tune can
    never alias the 1-shard entry of the same global shape.
    ``interpret`` (the reference's) is without effect: keys name the
    device, ``cuda`` or ``cpu``."""
    return (f"{op}|{_check_backend(backend)}|N{_bucket(N)}|M{_bucket(M)}"
            f"|m{_bucket(m)}|s{shards}")


# running hit/miss tally of the table consults; ``CausalEngine`` snapshots
# it around each front-door dispatch
CACHE_STATS = {"hit": 0, "miss": 0}

# running tallies of the two-stage search (the obs layer and the CLI
# snapshot deltas around sweeps)
SEARCH_STATS = {"candidates": 0, "pruned": 0, "measured": 0}


def lookup(op: str, N: int, M: int, m: int, backend: str,
           shards: int = 1, *, interpret: bool | None = None) -> dict | None:
    """Best known config for this op/shape/shard band, or None
    (``interpret``, the reference's, is without effect)."""
    cfg = load_table().get(key_for(op, N, M, m, backend, shards))
    CACHE_STATS["hit" if cfg is not None else "miss"] += 1
    return cfg


# ---------------------------------------------------------------------------
# analytic cost model
# ---------------------------------------------------------------------------

# Order-of-magnitude constants.  Only the RANKING matters (the model
# prunes, measurement decides).
#   cpu  — the reference's interpret model (the CPU runs the plain
#          versions): per-step overhead plus elementwise work.
#   cuda — the H100 SXM: HBM at 3.35 TB/s; 33.45 T instructions a second
#          (4 warp instructions a clock x 132 SMs x 1.98 GHz, chip_smoke
#          INT_OPS), reached only with 32 resident warps an SM to hide
#          latency; a wave of CTAs 1 us; a launch 4 us.
#          NVLink: 450 GB/s each way between two cards of a host (NVIDIA's
#          H100 data sheet: 900 GB/s in all); a copy between cards costs a
#          launch and an event besides its bytes.  The sharded ring's
#          strided bool block copies into its block-rows move ~0.5 TB/s
#          (measured on the H100: 2.12 ms for 4 N^2 bytes at N = 16,384,
#          PERF.md §6).
_MODEL = {
    "cpu": dict(step_overhead=2.0e-3, elem=4.0e-10, mxu_flop=4.0e-11),
    "cuda": dict(hbm=3.35e12, issue=128 * 132 * 1.98e9, warps_target=32,
                 wave=1.0e-6, launch=4.0e-6, nvlink=450e9, copy=10.0e-6,
                 assemble=0.5e12),
}

#: instructions a pair and lane (all-pairs) or a cell (one-vs-many) in
#: the built kernels' hot loops ([sass] lines of chip_smoke.py, PERF.md
#: §3); the mxu wide-T kernel takes 1 a pair and lane below T = 32,767
_INSTR = {"tri": 1.09375, "full": 1.083984375, "i32": 2.16015625,
          "mxu": 1.0234375, "mxu_wide": 1.0, "packed": 10.0625,
          "i32_rows": 25.0}
#: instructions a row and m-tile to close a tile sum (a warp reduction
#: and a float add, 32 lanes), and a hot row of the hybrid
_TILE_CLOSE = 192
_HOT_ROW = 32
#: seconds a one-vs-many CTA takes to stage and sum the query before its
#: first row, paid once for each CTA an SM holds: from bn = 4 to 32 at
#: equal bm the sweep measured 5.2 us less at 65,536 x 1,024 and 3.3 at
#: 69,632 x 256 (8 CTAs an SM to 1; PERF.md §6)
_CTA_SETUP = 0.6e-6


def _matrix_spec(engine: str, bi: int, bj: int, bm: int,
                 n_thresholds: int = 0) -> tp.CompareSpec:
    if engine == "tri":
        return tp.CompareSpec(topology="tri", pack="u8", bi=bi, bj=bj, bm=bm)
    if engine == "full":
        return tp.CompareSpec(topology="rect", pack="u8", bi=bi, bj=bj, bm=bm)
    if engine == "i32":
        return tp.CompareSpec(topology="rect", pack="i32", bi=bi, bj=bj,
                              bm=bm, with_stats=True)
    if engine == "mxu":
        return tp.CompareSpec(topology="mxu", pack="u8", bi=bi, bj=bj, bm=bm,
                              with_base=True, n_thresholds=max(n_thresholds, 1))
    raise ValueError(engine)


def _rows_spec(topology: str, m: int, bn: int, bm: int,
               pack: str = "u8") -> tp.CompareSpec:
    return tp.CompareSpec(topology=topology, pack=pack, bi=bn, bm=bm, m=m,
                          with_base=pack == "u8", with_stats=True)


def _fits(spec: tp.CompareSpec, backend: str) -> bool:
    """The spec is one the kernels take, and its shared memory (the
    Python copy, which ``chip_smoke.py`` holds to the libraries) is
    within the backend's budget."""
    _check_backend(backend)
    try:
        tp.validate(spec)
    except ValueError:
        return False
    budget = tp.SMEM_BUDGET[backend]
    return budget is None or tp.smem_python(spec) <= budget


def _regs(spec: tp.CompareSpec, regs: int | None) -> int:
    """Registers a thread: given, or read from the built instance."""
    return regs if regs is not None else tp.c_attrs(spec)["regs"]


def hopper_time(spec: tp.CompareSpec, regs: int, ctas: int, nbytes: float,
                instructions: float) -> float:
    """Predicted seconds of one launch of ``ctas`` CTAs of the spec's
    instance at ``regs`` registers a thread (module doc)."""
    c = _MODEL["cuda"]
    threads = tp.threads_of(spec)
    occ = tp.ctas_per_sm(threads, regs, tp.smem_python(spec))
    if occ == 0:
        return math.inf
    sms = tp.HOPPER["sms"]
    resident = min(occ, -(-ctas // sms)) * -(-threads // 32)
    waves = -(-ctas // (sms * occ))
    rate = c["issue"] * min(1.0, resident / c["warps_target"])
    return (max(nbytes / c["hbm"], instructions / rate)
            + waves * c["wave"] + c["launch"])


def predict_cost(engine: str, N: int, M: int, m: int, bi: int, bj: int,
                 bm: int, backend: str, n_thresholds: int = 0,
                 regs: int | None = None, *,
                 interpret: bool | None = None) -> float:
    """Predicted seconds for one all-pairs sweep with this candidate.

    Infinite when the spec is refused or its shared memory does not fit
    (the model and the wrappers refuse the same combos).  On ``cuda``
    the registers are read from the built instance unless given.
    ``interpret`` (the reference's) is without effect: ``backend``
    names the device modelled."""
    spec = _matrix_spec(engine, bi, bj, bm, n_thresholds)
    if not _fits(spec, backend):
        return math.inf
    gi, gj, gm = -(-N // bi), -(-M // bj), -(-m // bm)
    tiles = gi * (gi + 1) // 2 if engine == "tri" else gi * gj
    if backend == "cpu":
        c = _MODEL["cpu"]
        steps = tiles * gm
        if engine == "mxu":
            util = min(bi, 128) * min(bj, 128) / (128 * 128)
            compute = steps * ((bi + bj) * bm * n_thresholds * c["elem"]
                               + 2 * bi * bj * bm * n_thresholds
                               * c["mxu_flop"] / max(util, 1e-3))
        else:
            compute = steps * bi * bj * bm * (2 if engine == "i32" else 1) \
                * c["elem"]
        return steps * c["step_overhead"] + compute
    kind = "mxu_wide" if engine == "mxu" and n_thresholds > tp.MXU_T_MAX \
        else engine
    instr = tiles * bi * bj * m * _INSTR[kind]
    esize = 4 if engine == "i32" else 1
    # inputs once, the flags (and i32's fp, mxu's counts) once, and the
    # finalize's fp and concurrent matrices
    out = {"i32": 2 + 4 + 1, "mxu": 4 + 2 + 4 + 1}.get(engine, 2 + 4 + 1)
    nbytes = (N + M) * m * esize + N * M * out
    t = hopper_time(spec, _regs(spec, regs), tiles, nbytes, instr)
    if engine == "i32":          # the row-sum pre-pass: one warp a row
        t += N * m * 4 / _MODEL["cuda"]["hbm"] + _MODEL["cuda"]["launch"]
    return t


def _rows_grid(N: int, bn: int) -> tuple[int, int]:
    """(rows a warp's batch, CTAs) of the one-vs-many launch
    (one_vs_many.cu: launch)."""
    sms = tp.HOPPER["sms"]
    cap = sms * max(1, 32 // bn) * bn
    rb = min(32, max(1, -(-N // cap)))
    warps = min(cap, max(-(-N // rb), 1))
    return rb, -(-warps // bn)


def predict_one_vs_many_cost(N: int, m: int, bn: int, bm: int, backend: str,
                             packed: bool = True,
                             regs: int | None = None) -> float:
    """Predicted seconds for one one-vs-many classify of N rows."""
    spec = _rows_spec("one_vs_many", m, bn, bm, "u8" if packed else "i32")
    if not _fits(spec, backend):
        return math.inf
    if backend == "cpu":
        c = _MODEL["cpu"]
        return (-(-N // bn)) * (-(-m // bm)) * (c["step_overhead"]
                                               + bn * bm * c["elem"])
    _, ctas = _rows_grid(N, bn)
    esize = 1 if packed else 4
    nbytes = N * (m * esize + (4 if packed else 0) + 18)
    instr = (N * m * _INSTR["packed" if packed else "i32_rows"]
             + N * -(-m // bm) * _TILE_CLOSE)
    return (hopper_time(spec, _regs(spec, regs), ctas, nbytes, instr)
            + -(-ctas // tp.HOPPER["sms"]) * _CTA_SETUP)


def predict_hybrid_cost(N: int, H: int, m: int, bn: int, bm: int,
                        backend: str, regs: int | None = None, *,
                        interpret: bool | None = None) -> float:
    """Predicted seconds for one fused hot+tail hybrid classify.  ``N``
    is the TOTAL row count, ``H`` of which are hot.  ``interpret`` (the
    reference's) is without effect."""
    spec = _rows_spec("hybrid", m, bn, bm)
    if not _fits(spec, backend):
        return math.inf
    T = max(N - H, 1)
    if backend == "cpu":
        c = _MODEL["cpu"]
        steps = (-(-H // bn) + -(-T // bn)) * (-(-m // bm))
        return steps * (c["step_overhead"] + bn * bm * c["elem"])
    _, ctas = _rows_grid(T, bn)
    nbytes = T * (m + 4 + 18) + H * (12 + 18)
    instr = (T * m * _INSTR["packed"] + T * -(-m // bm) * _TILE_CLOSE
             + H * _HOT_ROW)
    return (hopper_time(spec, _regs(spec, regs), ctas, nbytes, instr)
            + -(-ctas // tp.HOPPER["sms"]) * _CTA_SETUP)


def sharded_table_ok(mesh) -> bool:
    """Whether a ``matrix_sharded`` entry may be read or written for this
    mesh: always on the CPU (the counterpart of the reference's forced
    host devices), on CUDA only when every shard has its own card, since
    the entries are measured there and read there."""
    devices = mesh.devices
    return devices[0].type != "cuda" or len(set(devices)) == len(devices)


def predict_sharded_cost(strategy: str, N: int, m: int, shards: int,
                         backend: str, *, parallel: int | None = None,
                         bi: int | None = None, bj: int | None = None,
                         bm: int = 512, uniform_base: bool = True,
                         regs: dict | None = None,
                         interpret: bool | None = None) -> float:
    """Predicted seconds for one sharded all-pairs sweep of N rows over
    ``shards`` row shards, ``parallel`` of them on distinct devices
    (default: all, at least 1).

    ``ring``: d tri launches of N/d rows and d(d - 1)/2 rect-u8 launches
    of N/d x N/d, spread over ``parallel`` cards, no card doing less than
    the busiest shard (tri and d // 2 rects at an even d); every pair's
    two flags are copied once more into the block-rows (4 N^2 bytes read
    and written, at the measured ``assemble`` rate, spread likewise);
    across cards each of the d // 2 steps copies a shard (N/d m bytes,
    and 4 N/d of bases when they are not uniform) and ships the mirror
    flags (2 (N/d)^2 bytes) over NVLink, and the block-rows of the other
    cards then cross to the first, (d - 1)/d of 2 N^2 bytes.  On one card
    the copies are none.  ``replicated``: (d - 1)/d of the slab's N m
    bytes gathered onto the first card, then the one-card tri.  Both
    finalise on the first card alike, which the model leaves out.  On
    the CPU it is the reference's model of forced host devices, which
    run in turn: the ring pays its steps and buys no parallelism.
    ``interpret`` (the reference's) is without effect."""
    if shards == 1:
        strategy = "replicated"          # a 1-wide ring is the plain sweep
    if strategy not in ("ring", "replicated"):
        raise ValueError(strategy)
    bi = bi or 64
    bj = bj or bi
    regs = regs or {}
    tri = predict_cost("tri", N, N, m, max(bi, bj), max(bi, bj), bm, backend,
                       regs=regs.get("tri"))
    if backend == "cpu":
        if strategy == "replicated":
            return tri + N * m * 1e-9
        steps = 1 + shards // 2
        return tri + steps * 2.0e-3 + steps * shards * 1.0e-3
    c = _MODEL["cuda"]
    d = shards
    p = max(1, min(d, parallel if parallel is not None else d))
    link = p > 1
    if strategy == "replicated":
        gather = (d - 1) / d * N * m / c["nvlink"] + c["copy"] if link else 0.0
        return tri + gather
    nd = -(-N // d)
    tri_s = predict_cost("tri", nd, nd, m, max(bi, bj), max(bi, bj), bm,
                         backend, regs=regs.get("tri"))
    rect_s = predict_cost("full", nd, nd, m, bi, bj, bm, backend,
                          regs=regs.get("full"))
    steps = d // 2
    work = max((d * tri_s + d * (d - 1) // 2 * rect_s) / p,
               tri_s + steps * rect_s)
    ring = 4 * N * N / c["assemble"] / p
    if link:
        shard = nd * m + (0 if uniform_base else 4 * nd)
        ring += steps * ((shard + 2 * nd * nd) / c["nvlink"] + 3 * c["copy"])
        ring += (d - 1) / d * 2 * N * N / c["nvlink"] + 2 * c["copy"]
    return work + ring


def prune(candidates: list, predicted: list[float]) -> list:
    """Keep at most half of ``candidates`` (capped at 8) ranked by
    predicted cost — always at least one; infinite predictions (shared
    memory busts) never survive."""
    if not candidates:
        return []
    order = sorted(range(len(candidates)), key=lambda i: predicted[i])
    keep = max(1, min(len(candidates) // 2, 8))
    kept = [candidates[i] for i in order[:keep]
            if predicted[i] < math.inf]
    SEARCH_STATS["candidates"] += len(candidates)
    SEARCH_STATS["pruned"] += len(candidates) - len(kept)
    return kept or [candidates[order[0]]]


# ---------------------------------------------------------------------------
# measured sweeps
# ---------------------------------------------------------------------------

# ~10 ms at boost clock: longer than the host takes to queue one call,
# so the card times the call and not the host's gaps
_SLEEP_CYCLES = 20_000_000


def _divisor_blocks(size: int, want: tuple, mult: int) -> list:
    return [b for b in want if b % mult == 0 and b <= size and size % b == 0]


def _bm_choices(m: int) -> list:
    """m-tiles that ``ops.tile_width`` keeps as asked for at this m."""
    return _divisor_blocks(-(-m // _LANE) * _LANE, BMS, _LANE)


def _measure(fn, dev: torch.device, reps: int = 3,
             count: bool = True) -> float:
    """Best of ``reps`` timed calls after a warm one (seconds)."""
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            fn()
            torch.cuda.synchronize()
            best = math.inf
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(_SLEEP_CYCLES)
                start.record()
                fn()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
    else:
        fn()
        best = math.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    if count:
        SEARCH_STATS["measured"] += 1
    return best


def _rand_packed(N: int, m: int, span: int, dev: torch.device,
                 seed: int = 0):
    rng = np.random.default_rng(seed)
    cells = torch.as_tensor(rng.integers(0, span, (N, m)), dtype=torch.uint8)
    return cells.to(dev), torch.zeros((N,), dtype=torch.int32, device=dev)


def _explain(explain: dict | None, grid: list, predicted: list,
             survivors: list, keys: tuple, engine: str | None = None):
    if explain is None:
        return
    ranking = sorted(zip(grid, predicted), key=lambda t: t[1])
    explain["grid"] = len(grid)
    explain["predicted"] = [
        {**({"engine": engine} if engine else {}), **dict(zip(keys, cfg)),
         "pred_us": p * 1e6} for cfg, p in ranking]
    explain["survivors"] = len(survivors)


def _race(survivors: list, keys: tuple, run, dev, verbose: bool, what: str,
          explain: dict | None, default, engine: str | None = None) -> dict:
    """Measure the survivors with ``run(cfg)``, and the default config
    beside them where the model pruned it: the fastest wins, so an entry
    is never slower than the built-in blocks in its own sweep.  With
    ``explain`` the measured times, the default's time and the winner's
    rank in the model's ranking are recorded."""
    default = tuple(default)
    results = []
    for cfg in list(survivors) + ([default] if default not in survivors else []):
        try:
            dt = _measure(run(cfg), dev)
        except Exception as e:            # candidate invalid on this device
            if verbose:
                print(f"  {what} {cfg}: FAILED {e}")
            continue
        results.append({**({"engine": engine} if engine else {}),
                        **dict(zip(keys, cfg)), "us": dt * 1e6})
        if verbose:
            print(f"  {what} {dict(zip(keys, cfg))}: {dt * 1e3:.4f} ms")
    if not results:
        raise RuntimeError(f"no viable {what} candidates")
    best = min(results, key=lambda r: r["us"])
    if explain is not None:
        explain["measured"] = sorted(results, key=lambda r: r["us"])
        explain["default"] = {**({"engine": engine} if engine else {}),
                              **dict(zip(keys, default))}
        hit = [r["us"] for r in results if tuple(r[k] for k in keys) == default]
        explain["default_us"] = hit[0] if hit else None
        ranked = [{k: v for k, v in p.items() if k != "pred_us"}
                  for p in explain["predicted"]]
        win = {k: v for k, v in best.items() if k != "us"}
        explain["winner_rank"] = ranked.index(win) + 1 if win in ranked else None
    return best


def _matrix_candidates(N: int, m: int, span: int) -> list:
    """The full knob grid for the matrix op (before the model prunes):
    tri at its square tiles, i32 at every tile and m-tile, mxu at every
    tile where the span allows it; bm matters only to i32."""
    from repro_torch.kernels import ops
    out = [("tri", bt, bt, 512) for bt in tp.TRI_TILES]
    for bi in tp.PAIR_TILES:
        for bj in tp.PAIR_TILES:
            if bi * bj > tp.PAIR_MAX_PAIRS:
                continue
            out += [("i32", bi, bj, bm) for bm in _bm_choices(m)]
            if span <= ops.MXU_SPAN_MAX:
                out.append(("mxu", bi, bj, 512))
    return out


def autotune_matrix(N: int, m: int, *, span: int = 30, device=None,
                    interpret: bool | None = None, verbose: bool = False,
                    explain: dict | None = None,
                    regs: dict | None = None) -> dict:
    """Race matrix engines x block shapes at a symmetric [N, m] slab;
    return the best config.  The model ranks the full grid first and
    only the top half is measured.  ``explain={}`` receives the
    predicted ranking, the survivors, the measured times, the default's
    time and the winner's rank.  ``regs`` maps an engine to registers a
    thread (default: read from the card).  ``interpret`` (the
    reference's) is without effect: ``device`` decides where the
    candidates run, the kernels on the card, their plain versions on
    the CPU."""
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    backend = backend_of(dev)
    cells, base = _rand_packed(N, m, span, dev)
    cells_i32 = cells.to(torch.int32)

    grid = _matrix_candidates(N, m, span)
    predicted = [predict_cost(e, N, N, m, bi, bj, bm, backend,
                              n_thresholds=span if e == "mxu" else 0,
                              regs=(regs or {}).get(e))
                 for (e, bi, bj, bm) in grid]
    survivors = prune(grid, predicted)
    keys = ("engine", "bi", "bj", "bm")
    _explain(explain, grid, predicted, survivors, keys)

    def run(cfg):
        engine, bi, bj, bm = cfg
        if engine == "i32":
            return lambda: ops._compare_matrix(
                cells_i32, cells_i32, engine="i32", bi=bi, bj=bj, bm=bm,
                use_autotune=False)
        return lambda: ops._compare_matrix_packed(
            cells, base, engine=engine, bi=bi, bj=bj, bm=bm,
            uniform_base=True, use_autotune=False)

    return _race(survivors, keys, run, dev, verbose, "matrix", explain,
                 ("tri",) + ops.MATRIX_BLOCKS)


def autotune_matrix_sharded(N: int, m: int, shards: int, *, span: int = 30,
                            device=None, mesh=None,
                            interpret: bool | None = None,
                            verbose: bool = False,
                            explain: dict | None = None) -> dict:
    """Race "ring" against "replicated" for the sharded symmetric
    all-pairs at [N, m] over ``shards`` row shards; returns
    ``{"strategy", "bi", "bj", "bm", "us"}``, the entry
    ``ops._compare_matrix_packed_sharded`` reads under
    ``key_for("matrix_sharded", N, N, m, backend, shards)``.

    The mesh is ``mesh``, else ``shards`` distinct cards (``device`` on
    CUDA) or ``shards`` shards of the CPU.  A CUDA mesh whose shards
    share a card is refused, as the reference refuses fewer devices than
    shards: its entry would be read on distinct cards.  Blocks are the
    ``matrix`` entry's where it names tri (the ring's diagonal runs tri
    at them), else the built-in ones.  ``interpret`` (the reference's)
    is without effect."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.sharding import split_rows

    if mesh is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            n = torch.cuda.device_count()
            if n < shards:
                raise RuntimeError(f"{shards}-shard sweep needs {shards} "
                                   f"CUDA devices, have {n}")
            mesh = make_fleet_mesh(shards)
        else:
            mesh = make_fleet_mesh(shards, device=dev)
    if len(mesh.devices) != shards:
        raise ValueError(f"a mesh of {len(mesh.devices)} devices for a "
                         f"{shards}-shard sweep")
    if not sharded_table_ok(mesh):
        raise RuntimeError(
            f"{shards}-shard sweep on a CUDA mesh whose shards share a card: "
            "matrix_sharded entries are measured on distinct cards")
    dev = mesh.devices[0]
    backend = backend_of(dev)
    cells, base = _rand_packed(N, m, span, dev)
    cells, base = split_rows(cells, mesh.devices), split_rows(base, mesh.devices)
    bi, bj, bm = ops._matrix_blocks("tri", N, N, m, None, None, None,
                                    backend)

    grid = [("ring",), ("replicated",)]
    parallel = len(set(mesh.devices))
    predicted = [predict_sharded_cost(st, N, m, shards, backend,
                                      parallel=parallel, bi=bi, bj=bj, bm=bm)
                 for (st,) in grid]
    _explain(explain, grid, predicted, grid, ("strategy",))

    def run(cfg):
        return lambda: ops._compare_matrix_packed_sharded(
            cells, base, mesh=mesh, strategy=cfg[0], bi=bi, bj=bj, bm=bm,
            uniform_base=True, use_autotune=False)

    best = _race(grid, ("strategy",), run, dev, verbose,
                 f"matrix_sharded s={shards}", explain, ("ring",))
    return {**best, "bi": bi, "bj": bj, "bm": bm}


def _rows_candidates(m: int) -> list:
    return [(bn, bm) for bn in BNS for bm in _bm_choices(m)]


def _rows_default(m: int) -> tuple:
    """The built-in one-vs-many blocks as the grid names them at this m
    (bm as ``ops.tile_width`` runs it)."""
    from repro_torch.kernels import ops
    return ops.OVM_BLOCKS[0], ops.tile_width(m, ops.OVM_BLOCKS[1])


def autotune_one_vs_many(N: int, m: int, *, span: int = 30, device=None,
                         interpret: bool | None = None,
                         verbose: bool = False, explain: dict | None = None,
                         regs: int | None = None) -> dict:
    """Race (bn, bm) for the packed one-vs-many classify at [N, m]
    (``interpret``, the reference's, is without effect)."""
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    backend = backend_of(dev)
    cells, base = _rand_packed(N, m, span, dev)
    q = cells[0].to(torch.int32)

    grid = _rows_candidates(m)
    predicted = [predict_one_vs_many_cost(N, m, bn, bm, backend, regs=regs)
                 for (bn, bm) in grid]
    survivors = prune(grid, predicted)
    _explain(explain, grid, predicted, survivors, ("bn", "bm"), "packed")

    def run(cfg):
        bn, bm = cfg
        return lambda: ops._classify_vs_many_packed(
            q, cells, base, bn=bn, bm=bm, use_autotune=False)

    return _race(survivors, ("bn", "bm"), run, dev, verbose, "one_vs_many",
                 explain, _rows_default(m), "packed")


def autotune_hybrid(N: int, m: int, *, hot: int | None = None,
                    span: int = 30, device=None,
                    interpret: bool | None = None, verbose: bool = False,
                    explain: dict | None = None,
                    regs: int | None = None) -> dict:
    """Race block shapes for the fused hot+tail hybrid classify.

    ``N`` is the TOTAL row count; ``hot`` (default N // 8) of those are
    exact hot rows, the rest the packed tail.  Winners land under
    ``key_for("hybrid", N, hot, m, ...)`` — the hot count rides in the
    M slot — matching the ``ops._hybrid_blocks`` lookup.  ``interpret``
    (the reference's) is without effect."""
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    backend = backend_of(dev)
    hot = hot if hot is not None else max(8, N // 8)
    T = max(8, N - hot)
    cells, base = _rand_packed(T, m, span, dev)
    q = cells[0].to(torch.int32)
    rng = np.random.default_rng(1)
    meta = torch.as_tensor(np.stack([rng.integers(0, 64, hot),
                                     rng.integers(0, 4, hot)], axis=1),
                           dtype=torch.int32).to(dev)
    hsums = torch.as_tensor(rng.integers(0, 64 * span, hot),
                            dtype=torch.float32).to(dev)

    grid = _rows_candidates(m)
    predicted = [predict_hybrid_cost(N, hot, m, bn, bm, backend, regs=regs)
                 for (bn, bm) in grid]
    survivors = prune(grid, predicted)
    _explain(explain, grid, predicted, survivors, ("bn", "bm"), "hybrid")

    def run(cfg):
        bn, bm = cfg
        return lambda: ops._classify_hybrid(
            q, 32, meta, hsums, cells, base, bn=bn, bm=bm,
            use_autotune=False)

    return _race(survivors, ("bn", "bm"), run, dev, verbose, "hybrid",
                 explain, _rows_default(m), "hybrid")


_SIZE = re.compile(r"^(?:(matrix|one_vs_many|hybrid):)?(\d+)x(\d+)(?:h(\d+))?$")


def parse_size(text: str) -> tuple:
    """``NxM`` (every op, the reference's form), ``op:NxM``, or
    ``hybrid:NxMhH`` (H hot rows) -> (op or None, N, m, hot or None)."""
    hit = _SIZE.match(text)
    if hit is None:
        raise ValueError(f"size {text!r}: want NxM, op:NxM or hybrid:NxMhH")
    op, N, m, hot = hit.groups()
    if hot is not None and op != "hybrid":
        raise ValueError(f"size {text!r}: a hot count is a hybrid knob")
    return op, int(N), int(m), None if hot is None else int(hot)


def autotune_shapes(shapes, *, shard_counts=(), device=None,
                    interpret: bool | None = None, verbose: bool = False,
                    observer=None, explains: dict | None = None) -> dict:
    """Sweep shapes (and shard counts); returns {table_key: cfg}.

    A shape is ``(N, m)`` (matrix, one-vs-many and hybrid, hot N // 8,
    as in the reference) or ``(op, N, m, hot)`` from ``parse_size``.
    Each matrix shape is also raced ring against replicated at every
    shard count d >= 2 of ``shard_counts`` that divides N
    (``autotune_matrix_sharded``: distinct cards on CUDA).
    ``observer`` (a ``repro_torch.obs.Observer``) gets one
    ``autotune.sweep`` span per (op, shape) with the search counters as
    attributes and ``autotune.{candidates,pruned,measured}`` counters;
    the running tallies live in ``SEARCH_STATS``.  ``interpret`` (the
    reference's) is without effect: ``device`` decides."""
    from repro_torch.obs import resolve
    obs = resolve(observer)
    dev = resolve_device(device)
    backend = backend_of(dev)
    out = {}

    def swept(op, N, m, fn, **kw):
        before = dict(SEARCH_STATS)
        exp: dict = {}
        with obs.trace.span("autotune.sweep", op=op, N=N, m=m, **kw) as span:
            best = fn(explain=exp)
            span.set(
                candidates=SEARCH_STATS["candidates"] - before["candidates"],
                pruned=SEARCH_STATS["pruned"] - before["pruned"],
                measured=SEARCH_STATS["measured"] - before["measured"],
                winner=json.dumps(best, sort_keys=True))
        for k in SEARCH_STATS:
            obs.metrics.counter(f"autotune.{k}", op=op).inc(
                SEARCH_STATS[k] - before[k])
        key = key_for(op, N, kw.get("M", N), m, backend, kw.get("shards", 1))
        if explains is not None:
            explains[key] = exp
        if verbose:
            print(f"  -> {best}")
        out[key] = best

    for shape in shapes:
        op, N, m, hot = shape if len(shape) == 4 else (None, *shape, None)
        if op in (None, "matrix"):
            if verbose:
                print(f"[autotune] matrix N={N} m={m}")
            swept("matrix", N, m, lambda explain: autotune_matrix(
                N, m, device=dev, verbose=verbose, explain=explain))
            for d in shard_counts:
                if d < 2 or N % d:
                    continue
                if verbose:
                    print(f"[autotune] matrix_sharded N={N} m={m} shards={d}")
                swept("matrix_sharded", N, m,
                      lambda explain, d=d: autotune_matrix_sharded(
                          N, m, d, device=dev, verbose=verbose,
                          explain=explain), shards=d)
        if op in (None, "one_vs_many"):
            if verbose:
                print(f"[autotune] one_vs_many N={N} m={m}")
            swept("one_vs_many", N, m, lambda explain: autotune_one_vs_many(
                N, m, device=dev, verbose=verbose, explain=explain))
        if op in (None, "hybrid"):
            h = hot if hot is not None else max(8, N // 8)
            if verbose:
                print(f"[autotune] hybrid N={N} hot={h} m={m}")
            swept("hybrid", N, m, lambda explain: autotune_hybrid(
                N, m, hot=h, device=dev, verbose=verbose, explain=explain),
                M=h)
    return out


def _print_explain(explains: dict) -> str:
    """Human-readable predicted-vs-measured report; returns the text."""
    lines = []
    for key, exp in sorted(explains.items()):
        pred = exp.get("predicted", [])
        meas = exp.get("measured", [])
        lines.append(f"== {key} ==")
        if "grid" in exp:
            lines.append(
                f"   grid {exp['grid']} candidates -> "
                f"{exp['survivors']} measured "
                f"({exp['grid'] - exp['survivors']} pruned by cost model)")
        lines.append("   predicted ranking                        | measured")
        for i in range(max(len(pred), len(meas))):
            left = right = ""
            if i < len(pred):
                p = dict(pred[i])
                us = p.pop("pred_us")
                left = f"{_cfg_str(p)} ~{us:.1f}us"
            if i < len(meas):
                r = dict(meas[i])
                us = r.pop("us")
                right = f"{_cfg_str(r)} {us:.1f}us"
            lines.append(f"   {left:<41}| {right}")
        if meas:
            if "default_us" in exp:
                lines.append(f"   default {_cfg_str(exp['default'])}: "
                             f"{exp['default_us']:.1f}us")
            win = dict(meas[0])
            win.pop("us", None)
            ranked = [{k: v for k, v in dict(p).items() if k != "pred_us"}
                      for p in pred]
            if win in ranked:
                lines.append(f"   measured winner predicted at rank "
                             f"{ranked.index(win) + 1}/{len(ranked)}")
    text = "\n".join(lines)
    print(text)
    return text


def _cfg_str(cfg: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(cfg.items()))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--sizes", nargs="*", default=list(DEFAULT_SIZES),
                   help="shapes to sweep: NxM (peers x cells, every op), "
                        "op:NxM, or hybrid:NxMhH (H hot rows)")
    p.add_argument("--shards", nargs="*", type=int, default=[],
                   help="also race ring against replicated for each matrix "
                        "shape at these shard counts (distinct cards)")
    p.add_argument("--device", default=None,
                   help="device to tune on (default: the card)")
    p.add_argument("--write", action="store_true",
                   help="merge results into the autotune table on disk")
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--explain", action="store_true",
                   help="print the cost model's predicted ranking next to "
                        "the measured winner for every (op, shape bucket)")
    p.add_argument("--explain-out", type=Path, default=None,
                   help="also write the --explain report to this file")
    p.add_argument("--trace-dir", type=Path, default=None,
                   help="record autotune.sweep spans + search counters "
                        "through a repro_torch.obs Observer into this "
                        "directory")
    args = p.parse_args(argv)
    shapes = [parse_size(s) for s in args.sizes]

    observer = None
    if args.trace_dir is not None:
        from repro_torch.obs import Observer
        observer = Observer.to_dir(args.trace_dir)
    explains: dict | None = {} if (args.explain or args.explain_out) else None
    results = autotune_shapes(shapes, shard_counts=tuple(args.shards),
                              device=args.device, verbose=True,
                              observer=observer, explains=explains)
    if observer is not None:
        observer.close()
    if explains is not None:
        text = _print_explain(explains)
        if args.explain_out is not None:
            args.explain_out.write_text(text + "\n")
    if args.write:
        table = dict(load_table())
        table.update(results)
        path = save_table(table, args.out)
        print(f"wrote {len(results)} entries -> {path}")
    else:
        print(json.dumps(results, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
