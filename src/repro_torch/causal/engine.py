"""CausalEngine: the dispatch front-door over the compare engines.

    engine = CausalEngine(CausalPolicy(...))
    engine.classify(query, peers)   # one-vs-many -> ClassifyResult
    engine.pairs(clocks)            # all-pairs   -> ComparisonMatrix
    causal.compare(a, b)            # pairwise    -> Comparison

``classify`` takes a ``PackedSlab`` (the registry's u8 residual + int32
base layout; promoted rows are overlaid through the exact int32 kernel)
or an ``[N, m]`` int32 slab / batched ``BloomClock`` (int32 kernel).
A hot-carrying slab (``repro_torch.hybrid.HybridSlab``, duck typed on
``hot_meta``) classifies through the fused hybrid kernel.  ``pairs``
takes the same inputs but hot-carrying slabs: a slab is compared
symmetrically, with dead slots compacted away and promoted rows patched
in through the exact int32 rim; an int32 slab is packed on the fly when
its value span fits a byte.

A sharded slab (``PackedSlab.mesh`` set, one tensor a row shard) runs
``classify`` once a shard and ``pairs`` through
``ops._compare_matrix_packed_sharded`` at full capacity (the
reference's block-row ring by default, or its "replicated" strategy),
with promoted rows patched in and dead slots masked on the device;
every result is bit-identical to the unsharded slab's and lives on
``mesh.devices[0]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.causal.policy import CausalPolicy
from repro_torch.causal.results import (
    ClassifyResult,
    Comparison,
    ComparisonMatrix,
)
from repro_torch.core import clock as bc
from repro_torch.device import indexed_device
from repro_torch.kernels import autotune, ops, pack
from repro_torch.obs.observer import resolve

__all__ = ["CausalEngine", "PackedSlab", "compare"]


def compare(a: bc.BloomClock, b: bc.BloomClock) -> Comparison:
    """Pairwise (broadcast/batched) typed comparison of two clocks."""
    o = bc.ordering(a, b)
    return Comparison(a_le_b=o.a_le_b, b_le_a=o.b_le_a,
                      fp_ab=o.fp_a_before_b, fp_ba=o.fp_b_before_a,
                      sum_a=bc.clock_sum(a), sum_b=bc.clock_sum(b))


@dataclasses.dataclass
class PackedSlab:
    """Packed peer-clock slab view handed to the front-door.

    u8 window residuals plus a per-slot int32 base.  ``wide`` maps a
    promoted slot (span beyond a byte, or a near-wrap base) to its host
    int32 logical row; those rows are compared exactly.  ``base_host``
    (optional) lets ``pairs`` probe base uniformity without a device
    sync.  With a ``mesh`` (``launch.mesh.FleetMesh``), ``cells_u8`` and
    ``base`` are tuples of per-shard tensors in slot order, shard i on
    ``mesh.devices[i]``; ``wide`` and ``base_host`` keep global slots.
    """

    cells_u8: torch.Tensor | tuple            # [N, m] uint8 residuals
    base: torch.Tensor | tuple                # [N] int32 offsets
    base_host: Optional[np.ndarray] = None    # host copy of ``base``
    wide: dict = dataclasses.field(default_factory=dict)
    mesh: Any = None

    @property
    def capacity(self) -> int:
        if self.mesh is not None:
            return sum(c.shape[0] for c in self.cells_u8)
        return self.cells_u8.shape[0]

    @property
    def m(self) -> int:
        if self.mesh is not None:
            return self.cells_u8[0].shape[1]
        return self.cells_u8.shape[1]

    @property
    def device(self) -> torch.device:
        """Where results land: the slab's device, or the mesh's first."""
        if self.mesh is not None:
            return self.mesh.devices[0]
        return self.cells_u8.device

    @property
    def packed(self) -> bool:
        return not self.wide


def _dispatch_label(fallback: str) -> tuple[str, tuple | None]:
    """(engine, blocks) metadata from the most recent ops dispatch."""
    d = ops.LAST_DISPATCH
    if not d:
        return fallback, None
    blocks = tuple((k, v) for k, v in sorted(d.items())
                   if k not in ("op", "engine"))
    return d.get("engine", fallback), blocks


def _check_alive_dev(alive_dev, cap: int, device: torch.device) -> None:
    """``alive_dev`` must be a [cap] bool tensor on ``device``, where the
    results live: a mask elsewhere is refused, never copied."""
    if not isinstance(alive_dev, torch.Tensor) or alive_dev.dtype != torch.bool \
            or tuple(alive_dev.shape) != (cap,):
        raise ValueError(f"alive_dev must be a [{cap}] bool tensor, got "
                         f"{getattr(alive_dev, 'dtype', type(alive_dev))} "
                         f"{tuple(getattr(alive_dev, 'shape', ()))}")
    if alive_dev.device != indexed_device(device):
        raise ValueError(f"alive_dev is on {alive_dev.device}; the slab's "
                         f"results live on {device}")


def _as_cells(clocks, device=None) -> torch.Tensor:
    """int32 logical cells from a BloomClock (any batch shape) or array."""
    if isinstance(clocks, bc.BloomClock):
        return clocks.logical_cells().to(torch.int32)
    return torch.as_tensor(clocks, dtype=torch.int32, device=device)


class CausalEngine:
    """The causality front-door (see module docstring)."""

    def __init__(self, policy: CausalPolicy | None = None):
        self.policy = policy or CausalPolicy()
        self.obs = resolve(self.policy.observer)

    def _record_dispatch(self, verb: str, res, n: int, span,
                         tune0: tuple[int, int]) -> None:
        """Span attrs and dispatch counters for one front-door call,
        with the autotune table's hits and misses during it."""
        obs = self.obs
        span.set(engine=res.engine, n=n,
                 blocks=dict(res.blocks) if res.blocks else None,
                 shards=self.policy.shards)
        obs.metrics.counter("engine_dispatch", verb=verb,
                            engine=res.engine).inc()
        hits = autotune.CACHE_STATS["hit"] - tune0[0]
        misses = autotune.CACHE_STATS["miss"] - tune0[1]
        if hits:
            obs.metrics.counter("autotune_cache", outcome="hit").inc(hits)
        if misses:
            obs.metrics.counter("autotune_cache", outcome="miss").inc(misses)

    def classify(self, query, peers, *, bn: int | None = None,
                 bm: int | None = None,
                 interpret: bool | None = None) -> ClassifyResult:
        """Classify one query clock against N peers in one kernel call
        (one a row shard on a sharded slab), plus one for promoted rows.
        The query moves to the peers' device (every shard's).
        ``interpret``: the reference's Pallas mode, accepted and without
        effect: the peers' device picks the kernel or its plain version."""
        obs = self.obs
        if not obs:
            return self._classify(query, peers, bn=bn, bm=bm)
        packed = isinstance(peers, PackedSlab)
        tune0 = (autotune.CACHE_STATS["hit"], autotune.CACHE_STATS["miss"])
        with obs.trace.span("causal.classify",
                            pack="slab" if packed else "i32") as sp:
            res = self._classify(query, peers, bn=bn, bm=bm)
            n = peers.capacity if packed else int(res.sum_p.shape[-1])
            self._record_dispatch("classify", res, n, sp, tune0)
        return res

    def _classify(self, query, peers, *, bn, bm) -> ClassifyResult:
        pol = self.policy
        bn = bn if bn is not None else pol.bn
        bm = bm if bm is not None else pol.bm
        ops.LAST_DISPATCH.clear()
        if isinstance(peers, PackedSlab):
            q = _as_cells(query).to(peers.device).contiguous()
            hot_meta = getattr(peers, "hot_meta", None)
            if hot_meta is not None and np.shape(hot_meta)[0] > 0:
                return self._classify_hybrid(q, peers, bn, bm)
            if peers.mesh is not None:
                out = ops._classify_vs_many_packed_sharded(
                    q, peers.cells_u8, peers.base, mesh=peers.mesh, bn=bn,
                    bm=bm, use_autotune=pol.autotune)
            else:
                out = ops._classify_vs_many_packed(
                    q, peers.cells_u8, peers.base, bn=bn, bm=bm,
                    use_autotune=pol.autotune)
            engine, blocks = _dispatch_label("packed")
            if peers.wide:
                widx = sorted(peers.wide)
                rows = torch.as_tensor(np.stack([peers.wide[s] for s in widx]),
                                       device=q.device)
                out = ops._overlay_wide_classify(out, q, widx, rows)
                engine += "+wide_overlay"
            return ClassifyResult.from_dict(out, engine=engine, blocks=blocks)
        cells = _as_cells(peers).contiguous()
        q = _as_cells(query).to(cells.device).contiguous()
        kw = {k: v for k, v in (("bn", bn), ("bm", bm)) if v is not None}
        out = ops._classify_vs_many(q, cells, **kw)
        return ClassifyResult.from_dict(out, engine="i32")

    def _classify_hybrid(self, q, peers, bn, bm) -> ClassifyResult:
        """Hot-carrying slab: one fused kernel sweep covers the exact hot
        rows and the packed tail; hot verdicts come back with fp = 0,
        tail verdicts bit-identical to a flat packed slab at the same
        blocks.  Result rows are hot first: [0, H) hot, then the tail."""
        dev = q.device
        hot_meta = torch.as_tensor(np.asarray(peers.hot_meta, np.int32),
                                   device=dev)
        hot_sums = torch.as_tensor(
            np.asarray(peers.hot_sums, np.float32).reshape(-1), device=dev)
        out = ops._classify_hybrid(q, int(peers.local_version), hot_meta,
                                   hot_sums, peers.cells_u8, peers.base,
                                   bn=bn, bm=bm,
                                   use_autotune=self.policy.autotune)
        engine, blocks = _dispatch_label("hybrid")
        if peers.wide:
            # wide keys index tail slots; result rows shift by the hot
            # block, so the overlay patches the shifted positions
            H = hot_meta.shape[0]
            widx = sorted(peers.wide)
            rows = torch.as_tensor(np.stack([peers.wide[s] for s in widx]),
                                   device=dev)
            out = ops._overlay_wide_classify(out, q, [H + s for s in widx],
                                             rows)
            engine += "+wide_overlay"
        return ClassifyResult.from_dict(out, engine=engine, blocks=blocks)

    # ------------------------------------------------------------------
    # verb 2: all-pairs compare
    # ------------------------------------------------------------------
    def pairs(self, clocks, cols=None, *, alive: np.ndarray | None = None,
              alive_dev: torch.Tensor | None = None,
              engine: str | None = None, bi: int | None = None,
              bj: int | None = None, bm: int | None = None,
              uniform_base: bool | None = None,
              interpret: bool | None = None) -> ComparisonMatrix:
        """All-pairs partial order + Eq. 3 fp over a batch of clocks.

        ``clocks``: a ``PackedSlab`` (symmetric; ``alive`` masks slots,
        promoted rows go through the exact int32 rim) or an ``[N, m]``
        int32 slab / batched ``BloomClock``, optionally against a second
        ``cols`` slab, packed on the fly when the value span fits a byte
        and compared by the int32 kernel otherwise.

        ``alive``: host bool mask over slab slots; dead slots cost no
        compute and report all-False flags, zero fp and zero sums.
        ``alive_dev``: the same mask as a bool tensor already on the
        slab's device (``PackedSlab.device``; a sharded registry passes
        its own), which a sharded slab masks with in place of uploading
        ``alive``; it changes no result.  ``interpret``: the reference's
        Pallas mode, accepted and without effect: the slab's device
        picks the kernels or their plain versions.
        """
        obs = self.obs
        kw = dict(alive=alive, alive_dev=alive_dev, engine=engine, bi=bi,
                  bj=bj, bm=bm, uniform_base=uniform_base)
        if not obs:
            return self._pairs(clocks, cols, **kw)
        packed = isinstance(clocks, PackedSlab)
        tune0 = (autotune.CACHE_STATS["hit"], autotune.CACHE_STATS["miss"])
        with obs.trace.span("causal.pairs",
                            pack="slab" if packed else "i32") as sp:
            res = self._pairs(clocks, cols, **kw)
            self._record_dispatch("pairs", res, int(res.le.shape[0]), sp,
                                  tune0)
        return res

    def _pairs(self, clocks, cols=None, *, alive=None, alive_dev=None,
               engine=None, bi=None, bj=None, bm=None,
               uniform_base=None) -> ComparisonMatrix:
        pol = self.policy
        engine = engine if engine is not None else pol.engine
        bi = bi if bi is not None else pol.bi
        bj = bj if bj is not None else pol.bj
        bm = bm if bm is not None else pol.bm
        ops.LAST_DISPATCH.clear()
        if isinstance(clocks, PackedSlab):
            if getattr(clocks, "hot_meta", None) is not None:
                raise ValueError(
                    "hot-carrying slabs are classify-only here; use "
                    "repro_torch.hybrid.HybridEngine.pairs for the fused "
                    "all-pairs sweep")
            if cols is not None:
                raise ValueError(
                    "PackedSlab pairs are symmetric; cols is not supported")
            return self._pairs_slab(clocks, alive, alive_dev, engine, bi,
                                    bj, bm, uniform_base)
        if alive is not None or alive_dev is not None:
            raise ValueError("alive masking needs a PackedSlab input")
        rows = _as_cells(clocks)
        if engine is None and not pol.pack:
            engine = "i32"
        cols_c = rows if cols is None else _as_cells(cols).to(rows.device)
        out = ops._compare_matrix(rows, cols_c, engine=engine, bi=bi, bj=bj,
                                  bm=bm, use_autotune=pol.autotune)
        eng, blocks = _dispatch_label(engine or "auto")
        return ComparisonMatrix.from_dict(out, engine=eng, blocks=blocks)

    # ---- packed-slab assembly (compaction, promoted rims, masking) ----
    def _pairs_slab(self, slab: PackedSlab, alive, alive_dev, engine, bi,
                    bj, bm, uniform_base) -> ComparisonMatrix:
        cap = slab.capacity
        dev = slab.device
        if alive_dev is not None:
            _check_alive_dev(alive_dev, cap, dev)
        alive = (np.ones(cap, bool) if alive is None
                 else np.asarray(alive, bool))
        aidx = np.flatnonzero(alive)
        kw = dict(engine=engine, bi=bi, bj=bj, bm=bm,
                  use_autotune=self.policy.autotune)
        if aidx.size == 0:
            false = torch.zeros((cap, cap), dtype=torch.bool, device=dev)
            zeros = torch.zeros((cap,), dtype=torch.float32, device=dev)
            return ComparisonMatrix(
                le=false, ge=false, conc=false,
                fp=torch.zeros((cap, cap), dtype=torch.float32, device=dev),
                row_sums=zeros, col_sums=zeros, engine="empty")
        if uniform_base is None:
            uniform_base = self._uniform_base(slab, alive)
        if slab.mesh is not None:
            # the bulk at full capacity, by either strategy; the fully
            # alive packed slab returns it as it is
            bulk = ops._compare_matrix_packed_sharded(
                slab.cells_u8, slab.base, mesh=slab.mesh,
                uniform_base=uniform_base, **kw)
            eng, blocks = _dispatch_label("ring_full")
            if aidx.size == cap and slab.packed:
                return ComparisonMatrix.from_dict(bulk, engine=eng,
                                                  blocks=blocks)
            if not slab.packed:
                # promoted rows: the O(P x A) int32 rim patched in on
                # the device
                bulk = self._device_wide_overlay(slab, bulk, aidx, **kw)
                eng += "+wide_rim"
            if alive_dev is None:
                alive_dev = torch.as_tensor(alive, device=dev)
            return ComparisonMatrix.from_dict(
                _mask_dead_pairs(bulk, alive_dev), engine=eng, blocks=blocks)
        if aidx.size == cap and slab.packed:
            out = ops._compare_matrix_packed(slab.cells_u8, slab.base,
                                             uniform_base=uniform_base, **kw)
            eng, blocks = _dispatch_label("tri")
            return ComparisonMatrix.from_dict(out, engine=eng, blocks=blocks)
        if slab.packed:
            # gather the alive rows into a dense sub-slab: dead slots
            # cost no compute, results scatter back to full capacity
            jidx = torch.as_tensor(aidx, device=dev)
            sub = ops._compare_matrix_packed(
                slab.cells_u8.index_select(0, jidx),
                slab.base.index_select(0, jidx),
                uniform_base=uniform_base, **kw)
            eng, blocks = _dispatch_label("tri")
            return ComparisonMatrix.from_dict(
                _expand_alive(sub, jidx, cap), engine=eng, blocks=blocks)
        return self._host_pairs(slab, alive, aidx, **kw)

    @staticmethod
    def _uniform_base(slab: PackedSlab, alive: np.ndarray) -> bool | None:
        """Host-side base-uniformity probe over the alive rows; None
        (a device probe in ``ops``) when no host base copy is carried."""
        if slab.base_host is None:
            return None
        b = np.asarray(slab.base_host)[alive]
        return bool(b.size == 0 or (b == b[0]).all())

    @staticmethod
    def _alive_widx(slab: PackedSlab, aidx: np.ndarray) -> np.ndarray:
        """Promoted slots restricted to the given alive index set."""
        keep = set(int(s) for s in aidx)
        return np.asarray(sorted(s for s in slab.wide if s in keep), np.int64)

    def _wide_rim(self, slab: PackedSlab, aidx: np.ndarray,
                  widx: np.ndarray, **kw) -> dict:
        """Exact int32 compare of the promoted rows against every alive
        row ([P, A]).  Unpacks only the gathered alive rows and patches
        the promoted rows' true values over their clipped residuals.  A
        promoted row's span exceeds a byte by definition, so the int32
        engine is named outright; block shapes carry over."""
        dev = slab.device
        rim_kw = {k: v for k, v in kw.items()
                  if k in ("bi", "bj", "bm", "use_autotune")}
        wide_rows = torch.as_tensor(
            np.stack([slab.wide[int(s)] for s in widx]), device=dev)
        alive_i32 = pack.unpack_rows(*_take_rows(slab, aidx))
        wpos = {int(s): i for i, s in enumerate(aidx)}
        alive_i32[torch.as_tensor([wpos[int(s)] for s in widx],
                                  device=dev)] = wide_rows
        return ops._compare_matrix(wide_rows, alive_i32, engine="i32",
                                   **rim_kw)

    def _device_wide_overlay(self, slab: PackedSlab, bulk: dict,
                             aidx: np.ndarray, **kw) -> dict:
        """Patch the promoted rows' and columns' flags into a
        full-capacity bulk and re-finalise fp from the corrected sums,
        on the device (the reference's counterpart of ``_host_pairs`` on
        a sharded slab): only the O(P x A) rim is computed.  The bulk's
        tensors are fresh, so they are patched in place."""
        cap, m = slab.capacity, slab.m
        widx = self._alive_widx(slab, aidx)
        if widx.size == 0:
            return bulk
        rim = self._wide_rim(slab, aidx, widx, **kw)
        dev = bulk["a_le_b"].device
        jw = torch.as_tensor(widx, device=dev)
        ja = torch.as_tensor(aidx, device=dev)

        def patch(mat, row_pa, col_pa):
            full = torch.zeros((2, len(widx), cap), dtype=torch.bool,
                               device=dev)
            full[0].index_copy_(1, ja, row_pa)
            full[1].index_copy_(1, ja, col_pa)
            mat.index_copy_(0, jw, full[0])
            return mat.index_copy_(1, jw, full[1].T)

        le = patch(bulk["a_le_b"], rim["a_le_b"], rim["b_le_a"])
        ge = patch(bulk["b_le_a"], rim["b_le_a"], rim["a_le_b"])
        sums = bulk["row_sums"].index_copy(0, jw, rim["row_sums"])
        return {"a_le_b": le, "b_le_a": ge, "concurrent": ~(le | ge),
                "fp": ops.eq3_outer(sums, sums, m), "row_sums": sums,
                "col_sums": sums}

    def _host_pairs(self, slab: PackedSlab, alive: np.ndarray,
                    aidx: np.ndarray, **kw) -> ComparisonMatrix:
        """Sparse promoted-row assembly: the packed engines over the
        still-packed alive rows plus the exact int32 rim for the promoted
        handful, stitched together on the slab's device.  fp is
        re-finalized from the corrected sums through the engines' Eq. 3
        expression (``ops.eq3_outer``)."""
        cap, m = slab.capacity, slab.m
        dev = slab.cells_u8.device
        widx = self._alive_widx(slab, aidx)
        le = torch.zeros((cap, cap), dtype=torch.bool, device=dev)
        ge = torch.zeros((cap, cap), dtype=torch.bool, device=dev)
        sums = torch.zeros((cap,), dtype=torch.float32, device=dev)
        pidx = np.asarray([s for s in aidx if s not in slab.wide], np.int64)
        eng = "none"
        if pidx.size:
            uniform = None            # no host copy: ``ops`` probes
            if slab.base_host is not None:
                b = np.asarray(slab.base_host)[pidx]
                uniform = bool((b == b[0]).all())
            jp = torch.as_tensor(pidx, device=dev)
            sub = ops._compare_matrix_packed(
                slab.cells_u8.index_select(0, jp),
                slab.base.index_select(0, jp), uniform_base=uniform, **kw)
            eng, _ = _dispatch_label("tri")
            _put_block(le, jp, jp, sub["a_le_b"])
            _put_block(ge, jp, jp, sub["b_le_a"])
            sums[jp] = sub["row_sums"]
        if widx.size:
            rim = self._wide_rim(slab, aidx, widx, **kw)
            eng += "+wide_rim"
            jw = torch.as_tensor(widx, device=dev)
            ja = torch.as_tensor(aidx, device=dev)
            _put_block(le, jw, ja, rim["a_le_b"])
            _put_block(ge, jw, ja, rim["b_le_a"])
            _put_block(le, ja, jw, rim["b_le_a"].T)
            _put_block(ge, ja, jw, rim["a_le_b"].T)
            sums[jw] = rim["row_sums"]
        # only alive pairs were written: dead rows/cols stay False / 0
        al = torch.as_tensor(alive, device=dev)
        pair = al[:, None] & al[None, :]
        conc = ~(le | ge) & pair
        fp = torch.where(pair, ops.eq3_outer(sums, sums, m), 0.0)
        return ComparisonMatrix(le=le, ge=ge, conc=conc, fp=fp,
                                row_sums=sums, col_sums=sums, engine=eng)


def _take_rows(slab: PackedSlab, slots: np.ndarray):
    """(u8 rows, bases) of the given sorted global slots on
    ``slab.device``: one gather a shard on a sharded slab."""
    if slab.mesh is None:
        j = torch.as_tensor(slots, device=slab.device)
        return slab.cells_u8.index_select(0, j), slab.base.index_select(0, j)
    rows = slab.cells_u8[0].shape[0]
    parts = []
    for i, (c, b) in enumerate(zip(slab.cells_u8, slab.base)):
        local = slots[(slots >= i * rows) & (slots < (i + 1) * rows)] - i * rows
        if local.size:
            j = torch.as_tensor(local, device=c.device)
            parts.append((c.index_select(0, j).to(slab.device),
                          b.reshape(-1).index_select(0, j).to(slab.device)))
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def _mask_dead_pairs(bulk: dict, alive: torch.Tensor) -> dict:
    """Dead-slot masking of a full-capacity all-pairs bulk on its device,
    the sharded path's counterpart of ``_expand_alive`` (same contract:
    dead rows and columns report all-False flags and zero fp and sums)."""
    pair = alive[:, None] & alive[None, :]
    le = bulk["a_le_b"] & pair
    ge = bulk["b_le_a"] & pair
    sums = torch.where(alive, bulk["row_sums"], 0.0)
    return {
        "a_le_b": le,
        "b_le_a": ge,
        "concurrent": ~(le | ge) & pair,
        "fp": torch.where(pair, bulk["fp"], 0.0),
        "row_sums": sums,
        "col_sums": sums,
    }


def _put_block(mat: torch.Tensor, ridx: torch.Tensor, cidx: torch.Tensor,
               block: torch.Tensor) -> None:
    """``mat[ridx][:, cidx] = block`` in place, by two index copies (no
    [R, C] index tensors)."""
    rows = mat.index_select(0, ridx)
    rows.index_copy_(1, cidx, block.to(mat.dtype))
    mat.index_copy_(0, ridx, rows)


def _expand_alive(sub: dict, jidx: torch.Tensor, cap: int) -> dict:
    """Scatter an alive-compacted result back to [capacity, capacity]:
    dead rows/cols report all-False flags and zero fp / sums."""
    dev = jidx.device

    def mat(x, dtype):
        out = torch.zeros((cap, cap), dtype=dtype, device=dev)
        _put_block(out, jidx, jidx, x)
        return out

    def vec(x):
        return torch.zeros((cap,), dtype=x.dtype, device=dev).index_copy_(
            0, jidx, x)

    return {
        "a_le_b": mat(sub["a_le_b"], torch.bool),
        "b_le_a": mat(sub["b_le_a"], torch.bool),
        "concurrent": mat(sub["concurrent"], torch.bool),
        "fp": mat(sub["fp"], torch.float32),
        "row_sums": vec(sub["row_sums"]),
        "col_sums": vec(sub["col_sums"]),
    }
