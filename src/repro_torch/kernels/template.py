"""The compare-kernel design space of the CUDA kernels, as the autotuner
sees it.

The reference emits every compare engine from one Pallas template
parameterized by a ``CompareSpec``.  The port's kernels are written by
hand in ``csrc/`` and their templates are instantiated there (there is
no ``generate.py``); this module keeps the spec surface so the
autotuner, the wrappers and the tests describe an instance the same
way:

    topology        "tri" (upper-triangle tiles of one slab), "rect"
                    (rows x cols), "mxu" (violation counts),
                    "one_vs_many" (one query vs a peer slab), "hybrid"
                    (one query vs exact hot rows + the packed tail)
    pack            "u8" (residuals + per-row int32 base) or "i32"
    bi / bj         all-pairs tile, pairs a CTA along rows / cols (one of
                    ``PAIR_TILES``, at most ``PAIR_MAX_PAIRS``); for
                    one_vs_many and hybrid ``bi`` is bn, warps a CTA
    bm              m-tile of the float32 sums (a 128-lane multiple)
    pipeline_depth  stages in flight; the kernels are built
                    double-buffered, so 2 is the only depth
    m               row width in cells: a one-vs-many CTA stages the
                    whole query (0 = bm)

``validate`` refuses what the CUDA kernels refuse, and ``smem_estimate``
(in place of the reference's VMEM estimate) is the dynamic shared memory
a CTA asks for: on the card the libraries' own exports, on the CPU the
same arithmetic copied here.  ``ctas_per_sm`` is the occupancy rule of
compute capability 9.0 (threads, registers in 256-register warp
allocations over 4 sub-partitions, shared memory with 1 KiB reserved a
CTA), which ``chip_smoke.py`` holds to
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

__all__ = [
    "CompareSpec",
    "ENGINE_SPECS",
    "HOPPER",
    "PACKS",
    "PAIR_MAX_PAIRS",
    "PAIR_TILES",
    "SMEM_BUDGET",
    "TOPOLOGIES",
    "TRI_TILES",
    "c_attrs",
    "ctas_per_sm",
    "smem_estimate",
    "smem_python",
    "threads_of",
    "validate",
]

TOPOLOGIES = ("tri", "rect", "mxu", "one_vs_many", "hybrid")
PACKS = ("u8", "i32")
_ACCS = ("int8", "int32")

#: all-pairs tile edges and the most pairs a tile may hold
#: (common.cuh: pair_edge_ok, PAIR_MAX_PAIRS); tri is instantiated
#: square at 32 and 64 only (bloom_matrix.cu: matrix_tri_flags)
PAIR_TILES = (32, 64, 128)
PAIR_MAX_PAIRS = 128 * 64
TRI_TILES = (32, 64)
#: largest T of the 16-bit-lane mxu kernel (bloom_mxu.cu: MXU_T_MAX)
MXU_T_MAX = 65535 // 8

#: the H100's per-SM limits (compute capability 9.0) the model uses
HOPPER = {
    "sms": 132,
    "warps_per_sm": 64,            # 2,048 threads
    "ctas_per_sm": 32,
    "regs_per_sm": 65536,
    "regs_per_cta": 65536,
    "reg_grain": 256,              # a warp's registers, allocated in units of 256
    "sub_partitions": 4,
    "smem_per_sm": 228 * 1024,
    "smem_reserved": 1024,         # reserved for the system, a CTA
    "smem_grain": 128,
    "smem_per_cta": 227 * 1024,    # dynamic shared memory a CTA may opt in to
}

#: dynamic shared memory a CTA may take, by backend (the CPU runs the
#: plain versions and has no such limit)
SMEM_BUDGET = {"cuda": HOPPER["smem_per_cta"], "cpu": None}

# staging geometry of the kernels (common.cuh, one_vs_many.cu)
_PAIR_LDK = 64 + 4        # words a staged row of 32-bit lanes
_PK_LDW = 32 + 4          # words a staged row of 16-bit lane pairs
_PK_QUADS = 16            # 4-byte reads a row and chunk
_PAIR_THREAD = 4 * 4      # pairs a thread
_OVM_RING = 2 * 2 * 32 * 16   # a warp's cp.async ring: depth x chunks x lanes x 16 B


@dataclasses.dataclass(frozen=True)
class CompareSpec:
    """One point in the compare-kernel design space (see module doc)."""

    topology: str
    pack: str = "u8"
    bi: int = 64
    bj: int = 64
    bm: int = 512
    pipeline_depth: int = 2
    acc: Optional[str] = None
    with_base: bool = False
    with_stats: bool = False
    n_thresholds: int = 0
    m: int = 0

    @property
    def acc_dtype(self) -> torch.dtype:
        if self.topology == "mxu":
            return torch.float32
        if self.acc is not None:
            return {"int8": torch.int8, "int32": torch.int32}[self.acc]
        if self.topology in ("one_vs_many", "hybrid") or self.pack == "i32":
            return torch.int32
        return torch.int8

    @property
    def row_width(self) -> int:
        return self.m or self.bm

    def label(self) -> str:
        parts = [self.topology, self.pack,
                 f"bi{self.bi}", f"bj{self.bj}", f"bm{self.bm}",
                 f"pd{self.pipeline_depth}"]
        if self.with_base:
            parts.append("base")
        if self.n_thresholds:
            parts.append(f"T{self.n_thresholds}")
        if self.m:
            parts.append(f"m{self.m}")
        return "/".join(parts)


#: the spec behind each named instance, at the port's default blocks
#: (the reference's ``generate.ENGINE_SPECS``)
ENGINE_SPECS = {
    "one_vs_many_i32": CompareSpec(
        topology="one_vs_many", pack="i32", bi=8, bm=512, with_stats=True),
    "one_vs_many_packed": CompareSpec(
        topology="one_vs_many", pack="u8", bi=8, bm=512,
        with_base=True, with_stats=True),
    "matrix_i32_stats": CompareSpec(
        topology="rect", pack="i32", bi=64, bj=64, bm=512, with_stats=True),
    "matrix_tri": CompareSpec(topology="tri", pack="u8", bi=64, bj=64, bm=512),
    "matrix_rect": CompareSpec(
        topology="rect", pack="u8", bi=64, bj=64, bm=512),
    "matrix_mxu": CompareSpec(
        topology="mxu", pack="u8", bi=64, bj=64, bm=512,
        with_base=True, n_thresholds=64),
    "hybrid_one_vs_many": CompareSpec(
        topology="hybrid", pack="u8", bi=8, bm=512,
        with_base=True, with_stats=True),
}


def _rows(spec: CompareSpec) -> bool:
    return spec.topology in ("one_vs_many", "hybrid")


def validate(spec: CompareSpec, backend: str | None = None) -> None:
    """Refuse malformed specs and those the CUDA kernels refuse (raises
    ValueError); with ``backend`` also those whose shared memory passes
    its budget."""
    if spec.topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {spec.topology!r}")
    if spec.pack not in PACKS:
        raise ValueError(f"unknown pack mode {spec.pack!r}")
    if spec.acc is not None and spec.acc not in _ACCS:
        raise ValueError(f"unknown accumulator {spec.acc!r}")
    if spec.bm < 128 or spec.bm % 128:
        raise ValueError(f"bm must be a lane multiple: bm={spec.bm}")
    if spec.pipeline_depth != 2:
        raise ValueError(f"the kernels are built double-buffered: "
                         f"pipeline_depth must be 2, got {spec.pipeline_depth}")
    if spec.m < 0:
        raise ValueError(f"m must be >= 0, got {spec.m}")
    if _rows(spec):
        if not 1 <= spec.bi <= 32:
            raise ValueError(f"bn={spec.bi} warps per block must be in [1, 32]")
    elif (spec.bi not in PAIR_TILES or spec.bj not in PAIR_TILES
          or spec.bi * spec.bj > PAIR_MAX_PAIRS):
        raise ValueError(f"all-pairs tile bi={spec.bi} bj={spec.bj}: each "
                         f"must be one of {PAIR_TILES}, and bi * bj at most "
                         f"{PAIR_MAX_PAIRS}")
    if spec.topology == "tri":
        if spec.pack != "u8":
            raise ValueError("tri topology is packed-only (pack='u8')")
        if spec.bi != spec.bj or spec.bi not in TRI_TILES:
            raise ValueError(f"tri tiles are square, one of {TRI_TILES}: "
                             f"bi={spec.bi} bj={spec.bj}")
    if spec.topology == "mxu":
        if spec.pack != "u8":
            raise ValueError("mxu topology is packed-only (pack='u8')")
        if spec.n_thresholds < 1:
            raise ValueError("mxu needs n_thresholds >= 1")
        if spec.with_stats:
            raise ValueError("mxu emits violation counts, not stats")
    elif spec.n_thresholds:
        raise ValueError("n_thresholds is an mxu-only knob")
    if spec.topology == "one_vs_many" and not spec.with_stats:
        raise ValueError("one_vs_many always emits stats (flags+sums+fp)")
    if spec.topology == "hybrid":
        if spec.pack != "u8":
            raise ValueError("hybrid's tail slab is packed-only "
                             "(pack='u8'); hot rows carry no cells at all")
        if not (spec.with_stats and spec.with_base):
            raise ValueError("hybrid always emits stats and folds tail "
                             "bases (with_stats=True, with_base=True)")
    if spec.topology == "rect" and spec.pack == "i32" and not spec.with_stats:
        raise ValueError("rect/i32 is the stats engine (with_stats=True)")
    if spec.with_stats and spec.topology in ("tri", "rect") \
            and spec.pack == "u8":
        raise ValueError("packed tri/rect emit flags only; sums/fp are "
                         "finalized outside the kernel")
    if backend is not None:
        budget = SMEM_BUDGET[backend]
        need = smem_estimate(spec, backend)
        if budget is not None and need > budget:
            raise ValueError(
                f"shared memory {need} B exceeds the {backend} budget "
                f"{budget} B for {spec.label()}")


def threads_of(spec: CompareSpec) -> int:
    """Threads a CTA of the spec's instance."""
    if _rows(spec):
        return 32 * spec.bi
    return spec.bi * spec.bj // _PAIR_THREAD


def smem_python(spec: CompareSpec) -> int:
    """Dynamic shared memory (bytes) a CTA asks for: the libraries'
    arithmetic (``ovm_smem``, ``u16x2_smem_bytes``, the rect-i32 and
    mxu launchers), copied."""
    bi, bj = spec.bi, spec.bj
    if _rows(spec):
        vec = 4 if spec.pack == "i32" else 16
        m = spec.row_width
        return -(-m // vec) * vec * 4 + bi * _OVM_RING
    if spec.topology in ("tri", "rect") and spec.pack == "u8":
        return (2 * _PK_LDW + _PK_QUADS) * (bi + bj) * 4
    if spec.topology == "rect":
        return 2 * (bi + bj) * _PAIR_LDK * 4
    if spec.n_thresholds > MXU_T_MAX:
        return (bi + bj) * _PAIR_LDK * 4
    return 2 * (bi + bj) * _PK_LDW * 4


def smem_estimate(spec: CompareSpec, backend: str = "cpu") -> int:
    """Dynamic shared memory a CTA of the spec asks for: from the
    library's export on ``"cuda"``, else ``smem_python``."""
    if backend != "cuda":
        return smem_python(spec)
    from repro_torch.kernels._build import library
    bi, bj = spec.bi, spec.bj
    if _rows(spec):
        esize = 4 if spec.pack == "i32" else 1
        return library("one_vs_many").one_vs_many_smem(spec.row_width, esize, bi)
    if spec.topology == "mxu":
        return library("bloom_mxu").mxu_smem(bi, bj, spec.n_thresholds)
    kind = {"tri": 1, "rect": 0 if spec.pack == "u8" else 2}[spec.topology]
    return library("bloom_matrix").matrix_smem(kind, bi, bj)


_ATTR_KEYS = ("regs", "max_threads", "static_smem", "ctas", "threads", "smem")


def _attrs(fn, *args) -> dict:
    import ctypes
    out = (ctypes.c_int * 6)()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}{args}: CUDA error {err}")
    return dict(zip(_ATTR_KEYS, out))


@functools.lru_cache(maxsize=None)
def c_attrs(spec: CompareSpec, scalar_staging: bool = False) -> dict:
    """On the card: the instance's registers a thread, thread limit,
    static and dynamic shared memory, threads, and the CTAs an SM that
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` admits, from the
    library export beside its launcher.  ``scalar_staging`` picks
    rect-i32's 4-byte-copy instance."""
    from repro_torch.kernels._build import library
    validate(spec)
    if _rows(spec):
        esize = 4 if spec.pack == "i32" else 1
        return _attrs(library("one_vs_many").one_vs_many_attrs,
                      spec.row_width, esize, spec.bi)
    if spec.topology == "mxu":
        return _attrs(library("bloom_mxu").mxu_attrs, spec.bi, spec.bj,
                      spec.n_thresholds)
    kind = {"tri": 1, "rect": 0}[spec.topology] if spec.pack == "u8" \
        else (3 if scalar_staging else 2)
    return _attrs(library("bloom_matrix").matrix_attrs, kind, spec.bi, spec.bj)


def row_sums_attrs() -> dict:
    """``c_attrs`` of rect-i32's row-sum pre-pass (256 threads, no shared
    memory), which has no knob."""
    from repro_torch.kernels._build import library
    return _attrs(library("bloom_matrix").matrix_attrs, 4, 0, 0)


def _round_up(x: int, grain: int) -> int:
    return -(-x // grain) * grain


def ctas_per_sm(threads: int, regs: int, smem: int, static_smem: int = 0,
                hw: dict = HOPPER) -> int:
    """CTAs of ``threads`` threads at ``regs`` registers a thread and
    ``smem`` + ``static_smem`` bytes of shared memory that one SM holds
    at once: the least of the warp, CTA, register and shared-memory
    limits (0 where one CTA does not fit)."""
    warps = -(-threads // 32)
    by_warps = min(hw["warps_per_sm"] // warps, hw["ctas_per_sm"])
    if regs > 0:
        per_warp = _round_up(regs * 32, hw["reg_grain"])
        parts = hw["sub_partitions"]
        if per_warp * _round_up(warps, parts) > hw["regs_per_cta"]:
            return 0
        by_regs = (hw["regs_per_sm"] // parts // per_warp) * parts // warps
    else:
        by_regs = by_warps
    if static_smem + smem > hw["smem_per_cta"]:
        return 0
    per_cta = _round_up(static_smem + smem + hw["smem_reserved"],
                        hw["smem_grain"])
    by_smem = hw["smem_per_sm"] // per_cta
    return min(by_warps, by_regs, by_smem)
