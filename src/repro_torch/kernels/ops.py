"""Wrappers around the CUDA kernels.

Each wrapper launches its hand-written kernel (``csrc/``) when given
CUDA tensors and raises if the launch fails; it runs the plain PyTorch
version (``kernels.ref``) only for tensors on the CPU.  There is no
fallback from the card to the plain version.

Every launch adds one to ``LAUNCHES[name]``, so a run can show that it
went through the kernels.  A wrapper's call on the card is one launch:
the merge-compare, one-vs-many and hybrid kernels write their flags as
``torch.bool`` into the output, and the returned flags are views of it.
``LAST_DISPATCH`` records the most recent one-vs-many, hybrid or
all-pairs dispatch (op, engine and blocks), which ``CausalEngine``
copies into its results.  A row-sharded slab classifies with one
launch a shard (``_classify_vs_many_packed_sharded``) and compares
all-pairs by the reference's block-row ring or on a replica gathered
onto the mesh's first device (``_compare_matrix_packed_sharded``); a
wrapper refuses a tensor that lies on another device than the one its
kernel runs on, so each shard's launch runs on its own card.

Blocks and the all-pairs engine resolve as the reference's do: an
explicit argument, else the measured ``autotune`` table entry for the
tensors' backend and shape (unless ``use_autotune=False``), else the
built-in blocks (``OVM_BLOCKS``, ``MATRIX_BLOCKS``).  The shipped table
holds only ``cuda`` keys, so CPU tensors resolve the built-in blocks.

The m-tile width follows the JAX wrappers' tile plan (``tile_width``):
m is padded to the 128-lane grain and the tile is the largest multiple
of 128 up to ``bm`` that divides it.  The kernels do not pad; they mask
the ragged edge themselves, and padded zeros add nothing to any sum, so
tile sums and their float32 accumulation order match the reference.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.hashing import bloom_indices
from repro_torch.kernels import autotune, pack, ref
from repro_torch.kernels._build import library
from repro_torch.kernels.template import PAIR_TILES, CompareSpec, validate
from repro_torch.sharding import arrive, mark, send_to

__all__ = [
    "LAUNCHES",
    "LAST_DISPATCH",
    "MATRIX_BLOCKS",
    "MXU_SPAN_MAX",
    "OVM_BLOCKS",
    "PAIR_TILES",
    "pick_block",
    "tile_width",
    "tick",
    "merge_compare",
    "hybrid",
    "eq3_outer",
    "tri_flags",
    "rect_u8_flags",
    "rect_i32_stats",
    "mxu_viol",
    "compare_matrix_packed_sharded",
]

LANE = 128  # the reference's lane grain; fixes its m-tile widths

#: kernel launches per kernel entry point
LAUNCHES: dict[str, int] = {
    "bloom_tick": 0,
    "bloom_merge_compare": 0,
    "one_vs_many_packed": 0,
    "one_vs_many_i32": 0,
    "hybrid": 0,
    "matrix_tri": 0,
    "matrix_rect_u8": 0,
    "matrix_rect_i32": 0,
    "matrix_mxu": 0,
}

#: widest value span (max - min logical cell) the mxu engine accepts,
#: and the thermometer widths T it rounds a span up to (the reference's)
MXU_SPAN_MAX = 64
_MXU_SPAN_BUCKETS = (8, 16, 32, 64)
#: largest T of the mxu kernel on packed 16-bit counts, which gain at
#: most 8 T a staged chunk; above it a 32-bit-lane kernel takes the call
#: (bloom_mxu.cu: MXU_T_MAX, the dispatch point)
MXU_T_MAX = 65535 // 8

#: all-pairs blocks (bi x bj pairs a CUDA block, bm the m-tile of the
#: i32 engine's sums) when neither the call nor the table gives them
MATRIX_BLOCKS = (64, 64, 512)

#: the most recent one-vs-many, hybrid or all-pairs dispatch: op, engine,
#: blocks
LAST_DISPATCH: dict = {}

#: 16-byte chunks a lane of the one-vs-many kernels takes a stage
#: (one_vs_many.cu: OVM_CPL)
OVM_CHUNKS_PER_LANE = 2
#: one-vs-many and hybrid blocks (bn warps a CTA, bm the m-tile) when
#: neither the call nor the table gives them: the reference's bn=8,
#: bm=512
OVM_BLOCKS = (8, 512)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _note_dispatch(op: str, engine: str, **blocks) -> None:
    LAST_DISPATCH.clear()
    LAST_DISPATCH.update({"op": op, "engine": engine, **blocks})


def pick_block(padded: int, want: int, lane: int = LANE) -> int:
    """Largest lane-multiple block <= want that divides ``padded``."""
    q = padded // lane
    best = 1
    for d in range(1, q + 1):
        if q % d == 0 and d * lane <= max(want, lane):
            best = d
    return best * lane


def tile_width(m: int, want: int) -> int:
    """The m-tile width the reference's ``tile2d`` plan picks for m."""
    return pick_block(-(-m // LANE) * LANE, want)


def _check(t: torch.Tensor, name: str, dtype, shape: tuple,
           device: torch.device | None = None) -> None:
    """Refuse what the kernel cannot read: a tensor off the card, of
    another dtype, shape or layout, or on another card than ``device``
    (the device of the tensors it is launched beside)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, the kernel runs on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1


def _log_q(m: int) -> float:
    return float(ref.eq3_log_q(m))


# ---------------------------------------------------------------------------
# tick / pairwise merge-compare
# ---------------------------------------------------------------------------

def tick_probes(cells: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """cells [B, m] int32 or int16 plus probe ids [B, P] -> new cells."""
    if not cells.is_cuda:
        return ref.bloom_tick_ref(cells, probes)
    B, m = cells.shape
    P = probes.shape[1]
    _check(cells, "tick cells", cells.dtype, (B, m))
    _check(probes, "tick probes", torch.int32, (B, P), cells.device)
    if cells.dtype not in (torch.int32, torch.int16):
        raise TypeError(f"tick: cells must be int32 or int16, got "
                        f"{cells.dtype}")
    out = torch.empty_like(cells)
    lib = library("bloom_tick")
    fn = lib.bloom_tick_i32 if cells.dtype == torch.int32 else lib.bloom_tick_i16
    with torch.cuda.device(cells.device):
        err = fn(cells.data_ptr(), probes.data_ptr(), out.data_ptr(), B, m, P,
                 _stream(cells))
    _launched(err, "bloom_tick")
    return out


def tick(cells: torch.Tensor, ev_hi, ev_lo, *, k: int = 4) -> torch.Tensor:
    """Batched bloom tick: cells [B, m], events [B, E], k probes each."""
    B, m = cells.shape
    idx = bloom_indices(ev_hi, ev_lo, k, m, device=cells.device)
    probes = idx.reshape(B, -1).to(torch.int32).contiguous()
    return tick_probes(cells, probes)


def merge_compare(a: torch.Tensor, b: torch.Tensor, *, bm: int = 512) -> dict:
    """Fused receive path over [B, m] int32 logical rows: merged cells,
    dominance flags, sums and Eq. 3 fp both ways, in one pass."""
    B, m = a.shape
    bm = tile_width(m, bm)
    if not a.is_cuda:
        merged, flags, sums, fp = ref.bloom_merge_compare_ref(a, b, bm=bm)
    else:
        _check(a, "merge_compare a", torch.int32, (B, m))
        _check(b, "merge_compare b", torch.int32, (B, m), a.device)
        merged = torch.empty_like(a)
        flags = torch.empty((B, 2), dtype=torch.bool, device=a.device)
        sums = torch.empty((B, 2), dtype=torch.float32, device=a.device)
        fp = torch.empty((B, 2), dtype=torch.float32, device=a.device)
        with torch.cuda.device(a.device):
            err = library("bloom_compare").bloom_merge_compare(
                a.data_ptr(), b.data_ptr(), merged.data_ptr(),
                flags.data_ptr(), sums.data_ptr(), fp.data_ptr(), B, m, bm,
                _log_q(m), _stream(a))
        _launched(err, "bloom_merge_compare")
    return {
        "merged": merged,
        "a_le_b": flags[:, 0],
        "b_le_a": flags[:, 1],
        "sum_a": sums[:, 0],
        "sum_b": sums[:, 1],
        "fp_a_before_b": fp[:, 0],
        "fp_b_before_a": fp[:, 1],
    }


# ---------------------------------------------------------------------------
# one-vs-many classify
# ---------------------------------------------------------------------------

def _classify_dict(flags, sums, fp) -> dict:
    return {
        "q_le_p": flags[:, 0],
        "p_le_q": flags[:, 1],
        "sum_q": sums[0, 0],
        "sum_p": sums[:, 1],
        "fp_q_before_p": fp[:, 0],
        "fp_p_before_q": fp[:, 1],
    }


def _check_ovm_block(name: str, m: int, pack_: str, bn: int) -> None:
    """bn warps a CTA in [1, 32], and the CTA's shared memory (the query
    and each warp's ring, as the library computes it) within the card's
    limit: ``template.validate``."""
    try:
        validate(CompareSpec(topology="one_vs_many", pack=pack_, bi=bn, m=m,
                             with_base=pack_ == "u8", with_stats=True), "cuda")
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def _one_vs_many(q: torch.Tensor, peers: torch.Tensor,
                 base: torch.Tensor | None, bn: int, bm: int):
    """(flags, sums, fp) for one query against [N, m] peers: the kernel
    for CUDA tensors, its plain version for CPU tensors."""
    (m,) = q.shape
    N = peers.shape[0]
    if tuple(peers.shape) != (N, m):
        raise ValueError(f"query {tuple(q.shape)} vs peers "
                         f"{tuple(peers.shape)}")
    bm = tile_width(m, bm)
    if not peers.is_cuda:
        return ref.one_vs_many_ref(q, peers, base, bm=bm)
    packed = base is not None
    name = "one_vs_many_packed" if packed else "one_vs_many_i32"
    dev = peers.device
    _check(peers, f"{name} peers", torch.uint8 if packed else torch.int32,
           (N, m))
    _check(q, f"{name} query", torch.int32, (m,), dev)
    if packed:
        _check(base, f"{name} base", torch.int32, (N,), dev)
    vec = 16 // peers.element_size()
    _check_ovm_block(name, m, "u8" if packed else "i32", bn)
    vec_ok = int(m % vec == 0 and peers.data_ptr() % 16 == 0)
    flags = torch.empty((N, 2), dtype=torch.bool, device=dev)
    sums = torch.empty((N, 2), dtype=torch.float32, device=dev)
    fp = torch.empty((N, 2), dtype=torch.float32, device=dev)
    lib = library("one_vs_many")
    with torch.cuda.device(dev):
        if packed:
            err = lib.one_vs_many_packed(
                q.data_ptr(), peers.data_ptr(), base.data_ptr(),
                flags.data_ptr(), sums.data_ptr(), fp.data_ptr(), N, m, bn,
                bm, _log_q(m), vec_ok, _stream(peers))
        else:
            err = lib.one_vs_many_i32(
                q.data_ptr(), peers.data_ptr(), flags.data_ptr(),
                sums.data_ptr(), fp.data_ptr(), N, m, bn, bm, _log_q(m),
                vec_ok, _stream(peers))
    _launched(err, name)
    return flags, sums, fp


def _classify_vs_many(q: torch.Tensor, peers: torch.Tensor, *, bn: int = 8,
                      bm: int = 512) -> dict:
    """One-vs-many classify against an int32 slab of logical rows."""
    return _classify_dict(*_one_vs_many(q, peers, None, bn, bm))


def _one_vs_many_blocks(N: int, m: int, bn, bm, backend: str,
                        use_table: bool = True) -> tuple[int, int]:
    """Resolve one-vs-many blocks: explicit args > autotune table >
    ``OVM_BLOCKS``."""
    if bn is None or bm is None:
        cfg = (autotune.lookup("one_vs_many", N, N, m, backend) or {}) \
            if use_table else {}
        bn = bn or cfg.get("bn", OVM_BLOCKS[0])
        bm = bm or cfg.get("bm", OVM_BLOCKS[1])
    return bn, bm


def _classify_vs_many_packed(q: torch.Tensor, peers: torch.Tensor,
                             base: torch.Tensor, *, bn: int | None = None,
                             bm: int | None = None,
                             use_autotune: bool = True) -> dict:
    """One-vs-many classify against a packed slab (u8 residuals + base).
    Blocks resolve through ``_one_vs_many_blocks``."""
    N, m = peers.shape
    bn, bm = _one_vs_many_blocks(N, m, bn, bm, autotune.backend_of(peers),
                                 use_autotune)
    _note_dispatch("one_vs_many", "packed", bn=bn, bm=bm)
    return _classify_dict(*_one_vs_many(q, peers, base.reshape(-1), bn, bm))


def _classify_vs_many_packed_sharded(q: torch.Tensor, peers: tuple,
                                     base: tuple, *, mesh,
                                     bn: int | None = None,
                                     bm: int | None = None,
                                     use_autotune: bool = True) -> dict:
    """``_classify_vs_many_packed`` over a row-sharded slab: ``peers``
    and ``base`` hold one [N/d, m] u8 and one [N/d] int32 tensor a
    shard, shard i on ``mesh.devices[i]``.

    The query is replicated onto every shard's device and each shard
    takes one launch under its own device guard; every launch is queued
    before any result is read, so shards on distinct cards overlap.
    Blocks resolve ONCE at full N, so bm, and with it the float32 order
    of the sums and the fp bits, is the same at every shard count as on
    the unsharded slab.  Flags, sums and fp come back concatenated in
    slot order on ``mesh.devices[0]``.
    """
    devices = mesh.devices
    d, nd, m = _mesh_shards("one_vs_many_sharded", peers, base, mesh)
    N = nd * d
    bn, bm = _one_vs_many_blocks(N, m, bn, bm, autotune.backend_of(peers[0]),
                                 use_autotune)
    _note_dispatch("one_vs_many", "packed_sharded", bn=bn, bm=bm, shards=d)
    parts = [_one_vs_many(q.to(dev, non_blocking=True), p, b.reshape(-1),
                          bn, bm)
             for p, b, dev in zip(peers, base, devices)]
    dev0 = devices[0]
    flags, sums, fp = (torch.cat([part[j].to(dev0, non_blocking=True)
                                  for part in parts]) for j in range(3))
    return _classify_dict(flags, sums, fp)


def _overlay_wide_classify(out: dict, q: torch.Tensor, wide_idx,
                           wide_rows: torch.Tensor) -> dict:
    """Re-classify just the promoted rows ``wide_rows`` [P, m] int32
    through the exact int32 kernel and patch them into a packed result
    at slots ``wide_idx``."""
    wout = _classify_vs_many(q, wide_rows)
    idx = torch.as_tensor(wide_idx, dtype=torch.int64, device=q.device)
    patched = dict(out)
    for key in ("q_le_p", "p_le_q", "sum_p", "fp_q_before_p",
                "fp_p_before_q"):
        patched[key] = out[key].index_put((idx,), wout[key])
    return patched


# ---------------------------------------------------------------------------
# hybrid classify (exact hot rows + packed tail, one fused kernel)
# ---------------------------------------------------------------------------

def hybrid(q: torch.Tensor, v_local: int, hot_meta: torch.Tensor,
           hot_sums: torch.Tensor, tail: torch.Tensor,
           tail_base: torch.Tensor, *, bn: int = 8, bm: int = 512):
    """(flags, sums, fp), each [H + T, 2], of one query [m] int32 against
    H exact hot rows (``hot_meta`` [H, 2] int32 ``(v, n_private)``,
    ``hot_sums`` [H] float32) and T packed tail rows (``tail`` [T, m] u8,
    ``tail_base`` [T] int32), hot first: the kernel for CUDA tensors,
    its plain version for CPU tensors.  Both H and T must be positive."""
    (m,) = q.shape
    H = hot_meta.shape[0]
    T = tail.shape[0]
    if H == 0 or T == 0:
        raise ValueError(f"hybrid needs both a hot set and a tail, got "
                         f"H={H} T={T}")
    if tuple(tail.shape) != (T, m):
        raise ValueError(f"query {tuple(q.shape)} vs tail {tuple(tail.shape)}")
    bm = tile_width(m, bm)
    hot_sums = hot_sums.reshape(-1)
    tail_base = tail_base.reshape(-1)
    if not tail.is_cuda:
        return ref.hybrid_classify_ref(q, v_local, hot_meta, hot_sums, tail,
                                       tail_base, bm=bm)
    dev = tail.device
    _check(tail, "hybrid tail", torch.uint8, (T, m))
    _check(q, "hybrid query", torch.int32, (m,), dev)
    _check(hot_meta, "hybrid hot_meta", torch.int32, (H, 2), dev)
    _check(hot_sums, "hybrid hot_sums", torch.float32, (H,), dev)
    _check(tail_base, "hybrid tail_base", torch.int32, (T,), dev)
    _check_ovm_block("hybrid", m, "u8", bn)
    vec_ok = int(m % 16 == 0 and tail.data_ptr() % 16 == 0)
    flags = torch.empty((H + T, 2), dtype=torch.bool, device=dev)
    sums = torch.empty((H + T, 2), dtype=torch.float32, device=dev)
    fp = torch.empty((H + T, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library("one_vs_many").hybrid_classify(
            q.data_ptr(), int(v_local), hot_meta.data_ptr(),
            hot_sums.data_ptr(), tail.data_ptr(), tail_base.data_ptr(),
            flags.data_ptr(), sums.data_ptr(), fp.data_ptr(), H, T, m, bn, bm,
            _log_q(m), vec_ok, _stream(tail))
    _launched(err, "hybrid")
    return flags, sums, fp


def _hybrid_blocks(N: int, H: int, m: int, bn, bm, backend: str,
                   use_table: bool = True) -> tuple[int, int]:
    """Resolve hybrid blocks: explicit args > autotune table (keyed on
    total rows AND hot count: the hot/tail split changes the winning
    tile) > ``OVM_BLOCKS``."""
    if bn is None or bm is None:
        cfg = (autotune.lookup("hybrid", N, H, m, backend) or {}) \
            if use_table else {}
        bn = bn or cfg.get("bn", OVM_BLOCKS[0])
        bm = bm or cfg.get("bm", OVM_BLOCKS[1])
    return bn, bm


def _classify_hybrid(q: torch.Tensor, v_local: int, hot_meta: torch.Tensor,
                     hot_sums: torch.Tensor, tail: torch.Tensor,
                     tail_base: torch.Tensor, *, bn: int | None = None,
                     bm: int | None = None,
                     use_autotune: bool = True) -> dict:
    """One query vs an exact hot set plus a packed bloom tail, fused.

    Hot verdicts are integer compares of ``(v, n_private)`` against the
    local chain version ``v_local`` with fp = 0; tail rows are
    bit-identical to ``_classify_vs_many_packed`` at the same bm.  Blocks
    resolve through ``_hybrid_blocks``.  Returns the ``_classify_dict``
    layout over H + T rows, hot first."""
    (m,) = q.shape
    H, T = hot_meta.shape[0], tail.shape[0]
    assert H > 0 and T > 0, "hybrid needs both a hot set and a tail " \
        "(route single-representation slabs through the plain engines)"
    bn, bm = _hybrid_blocks(H + T, H, m, bn, bm, autotune.backend_of(tail),
                            use_autotune)
    _note_dispatch("hybrid", "fused_hot_tail", bn=bn, bm=tile_width(m, bm),
                   hot=H, tail=T)
    return _classify_dict(*hybrid(q, v_local, hot_meta, hot_sums, tail,
                                  tail_base, bn=bn, bm=bm))


# ---------------------------------------------------------------------------
# all-pairs kernels
# ---------------------------------------------------------------------------

def _check_tiles(bi: int, bj: int) -> None:
    validate(CompareSpec(topology="rect", bi=bi, bj=bj))


def _flag_pair(N: int, M: int, dev):
    return (torch.empty((N, M), dtype=torch.bool, device=dev),
            torch.empty((N, M), dtype=torch.bool, device=dev))


def tri_flags(cells: torch.Tensor, base: torch.Tensor, *, bt: int = 64,
              with_base: bool = True):
    """Symmetric packed all-pairs flags over one u8 slab [N, m] with
    bases [N]: (le, ge) bool [N, N], the kernel writing the mirror of
    its upper-triangle tiles itself.  ``with_base=False`` ignores the
    bases (a uniform window), as the reference does."""
    N, m = cells.shape
    _check_tiles(bt, bt)
    if not cells.is_cuda:
        return ref.tri_flags_ref(cells, base if with_base else None)
    _check(cells, "matrix_tri cells", torch.uint8, (N, m))
    _check(base, "matrix_tri base", torch.int32, (N,), cells.device)
    le, ge = _flag_pair(N, N, cells.device)
    if N:
        with torch.cuda.device(cells.device):
            err = library("bloom_matrix").matrix_tri_flags(
                cells.data_ptr(), base.data_ptr(), le.data_ptr(),
                ge.data_ptr(), N, m, bt, int(with_base), _stream(cells))
        _launched(err, "matrix_tri")
    return le, ge


def rect_u8_flags(rows: torch.Tensor, cols: torch.Tensor,
                  row_base: torch.Tensor, col_base: torch.Tensor, *,
                  bi: int = 64, bj: int = 64, with_base: bool = True):
    """Packed all-pairs flags over a full rectangle: rows [N, m] and cols
    [M, m] u8 with bases [N], [M] -> (le, ge) bool [N, M].  The kernel
    takes a bi x bj tile of pairs a block, two m lanes a 32-bit word;
    the flags do not depend on the tile."""
    N, m = rows.shape
    M = cols.shape[0]
    _check_tiles(bi, bj)
    if not rows.is_cuda:
        if with_base:
            return ref.rect_u8_flags_ref(rows, cols, row_base, col_base)
        return ref.rect_u8_flags_ref(rows, cols)
    _check(rows, "matrix_rect_u8 rows", torch.uint8, (N, m))
    _check(cols, "matrix_rect_u8 cols", torch.uint8, (M, m), rows.device)
    _check(row_base, "matrix_rect_u8 row_base", torch.int32, (N,),
           rows.device)
    _check(col_base, "matrix_rect_u8 col_base", torch.int32, (M,),
           rows.device)
    le, ge = _flag_pair(N, M, rows.device)
    if N and M:
        with torch.cuda.device(rows.device):
            err = library("bloom_matrix").matrix_rect_u8_flags(
                rows.data_ptr(), cols.data_ptr(), row_base.data_ptr(),
                col_base.data_ptr(), le.data_ptr(), ge.data_ptr(), N, M, m,
                bi, bj, int(with_base), _stream(rows))
        _launched(err, "matrix_rect_u8")
    return le, ge


def rect_i32_stats(rows: torch.Tensor, cols: torch.Tensor,
                   col_sums: torch.Tensor, *, bi: int = 64, bj: int = 64,
                   bm: int = 512):
    """int32 all-pairs: rows [N, m], cols [M, m] logical cells, col_sums
    [M] float32 -> (le, ge) bool [N, M], row sums [N] float32 (per
    bm-wide m-tile, the reference's order) and fp(row -> col) [N, M].
    One call launches two kernels: the row sums, then the pairs (a bi x
    bj tile a block) with Eq. 3 from those sums; only the sums depend on
    ``bm``."""
    N, m = rows.shape
    M = cols.shape[0]
    _check_tiles(bi, bj)
    bm = tile_width(m, bm)
    if not rows.is_cuda:
        return ref.rect_i32_stats_ref(rows, cols, col_sums, bm=bm)
    _check(rows, "matrix_rect_i32 rows", torch.int32, (N, m))
    _check(cols, "matrix_rect_i32 cols", torch.int32, (M, m), rows.device)
    _check(col_sums, "matrix_rect_i32 col_sums", torch.float32, (M,),
           rows.device)
    if N and not M:
        raise ValueError("matrix_rect_i32: row sums need at least one column")
    dev = rows.device
    le, ge = _flag_pair(N, M, dev)
    row_sums = torch.empty((N,), dtype=torch.float32, device=dev)
    fp = torch.empty((N, M), dtype=torch.float32, device=dev)
    if N:
        with torch.cuda.device(dev):
            err = library("bloom_matrix").matrix_rect_i32_stats(
                rows.data_ptr(), cols.data_ptr(), col_sums.data_ptr(),
                le.data_ptr(), ge.data_ptr(), row_sums.data_ptr(),
                fp.data_ptr(), N, M, m, bi, bj, bm, _log_q(m), _stream(rows))
        _launched(err, "matrix_rect_i32")
    return le, ge, row_sums, fp


def mxu_viol(rows: torch.Tensor, cols: torch.Tensor, row_base: torch.Tensor,
             col_base: torch.Tensor, *, lo: int, n_thresholds: int,
             bi: int = 64, bj: int = 64) -> torch.Tensor:
    """Violation counts ``sum_m relu(a - b)`` float32 [N, M] over packed
    rows/cols on window-relative values in [0, T] (T = n_thresholds).
    Refuses ``m * T >= 2^24``, where float32 counts stop being exact, as
    the reference does."""
    N, m = rows.shape
    M = cols.shape[0]
    _check_tiles(bi, bj)
    if m * n_thresholds >= 2 ** 24:
        raise ValueError(f"mxu: m={m} x T={n_thresholds} exceeds the float32 "
                         f"exactness bound 2^24")
    if not rows.is_cuda:
        return ref.mxu_viol_ref(rows, cols, row_base, col_base, lo=lo,
                                n_thresholds=n_thresholds)
    _check(rows, "matrix_mxu rows", torch.uint8, (N, m))
    _check(cols, "matrix_mxu cols", torch.uint8, (M, m), rows.device)
    _check(row_base, "matrix_mxu row_base", torch.int32, (N,), rows.device)
    _check(col_base, "matrix_mxu col_base", torch.int32, (M,), rows.device)
    viol = torch.empty((N, M), dtype=torch.float32, device=rows.device)
    if N and M:
        with torch.cuda.device(rows.device):
            err = library("bloom_mxu").matrix_mxu_viol(
                rows.data_ptr(), cols.data_ptr(), row_base.data_ptr(),
                col_base.data_ptr(), viol.data_ptr(), N, M, m, bi, bj, lo,
                n_thresholds, _stream(rows))
        _launched(err, "matrix_mxu")
    return viol


# ---------------------------------------------------------------------------
# all-pairs compare: dispatch and finalize
# ---------------------------------------------------------------------------

def eq3_outer(row_sums: torch.Tensor, col_sums: torch.Tensor,
              m: int) -> torch.Tensor:
    """Eq. 3 fp of "row happened-before col" as an [N, M] outer product,
    the expression of every engine's finalize."""
    return ref.eq3_fp(row_sums[:, None], col_sums[None, :], m)


def _packed_row_sums(cells: torch.Tensor, base: torch.Tensor,
                     m: int) -> torch.Tensor:
    s = ref.wrap_sum_i32(cells).to(torch.float32)
    return s + base.reshape(-1).to(torch.int32).to(torch.float32) * m


def _matrix_dict(le, ge, row_sums, col_sums, m: int) -> dict:
    return {
        "a_le_b": le,
        "b_le_a": ge,
        "concurrent": ~(le | ge),
        "fp": eq3_outer(row_sums, col_sums, m),
        "row_sums": row_sums,
        "col_sums": col_sums,
    }


def _matrix_blocks(engine: str, N: int, M: int, m: int, bi, bj, bm,
                   backend: str, use_table: bool = True,
                   shards: int = 1) -> tuple[int, int, int]:
    """Resolve all-pairs blocks: explicit args > the autotune table's
    entry for this shape when it names the same engine > ``MATRIX_BLOCKS``
    (64 x 64 pairs a CUDA block; bm 512, which fixes the i32 engine's
    sum order).  A sharded ring (``shards > 1``) reads the
    ``matrix_sharded`` entry of the global shape and shard count, never
    the ``matrix`` entry, as in the reference."""
    if not use_table:
        cfg = {}
    elif shards > 1:
        cfg = autotune.lookup("matrix_sharded", N, M, m, backend,
                              shards=shards) or {}
    else:
        cfg = autotune.lookup("matrix", N, M, m, backend) or {}
        if cfg.get("engine") != engine:
            cfg = {}
    bi = bi or cfg.get("bi", MATRIX_BLOCKS[0])
    bj = bj or cfg.get("bj", MATRIX_BLOCKS[1])
    _check_tiles(bi, bj)
    return bi, bj, bm or cfg.get("bm", MATRIX_BLOCKS[2])


def _span_bucket(span: int) -> int:
    for b in _MXU_SPAN_BUCKETS:
        if span <= b:
            return b
    raise ValueError(f"value span {span} exceeds MXU_SPAN_MAX={MXU_SPAN_MAX}")


def _logical_bounds(cells, base, cols, col_base) -> tuple[int, int]:
    """Global (lo, span) of the logical values of both slabs, in one
    host transfer."""
    b = base.reshape(-1).to(torch.int32)
    cb = col_base.reshape(-1).to(torch.int32)
    lo = torch.minimum(b.min(), cb.min())
    hi = torch.maximum((cells.amax(1).to(torch.int32) + b).max(),
                       (cols.amax(1).to(torch.int32) + cb).max())
    lo, hi = torch.stack([lo, hi]).tolist()
    return lo, hi - lo


def _mxu_finalize(viol, cells, base, cols, col_base, row_sums, col_sums,
                  m: int, lo: int) -> dict:
    """le = no violations; ge from the rank-1 identity
    viol_ge = viol - Σa + Σb over window-shifted sums (< 2^24, so the
    float32 zero tests are exact; the shift cancels)."""
    sa = _packed_row_sums(cells, base.reshape(-1) - lo, m)
    sb = _packed_row_sums(cols, col_base.reshape(-1) - lo, m)
    le = viol == 0.0
    ge = (viol - sa[:, None] + sb[None, :]) == 0.0
    return _matrix_dict(le, ge, row_sums, col_sums, m)


def _mxu_viable(cells, base, cols, col_base) -> bool:
    _, span = _logical_bounds(cells, base, cols, col_base)
    return span <= MXU_SPAN_MAX


def _compare_matrix_packed(cells: torch.Tensor, base: torch.Tensor,
                           cols: torch.Tensor | None = None,
                           col_base: torch.Tensor | None = None, *,
                           engine: str | None = None, bi: int | None = None,
                           bj: int | None = None, bm: int | None = None,
                           uniform_base: bool | None = None,
                           use_autotune: bool = True) -> dict:
    """Tiled all-pairs compare over packed u8 slab(s) (rows [N, m] +
    bases; ``cols`` None means symmetric).

    The engine resolves as the reference's does: asked for, else the
    table's (its "i32" becomes "tri", its "mxu" stands only where the
    logical span is at most ``MXU_SPAN_MAX``), else "tri"; "tri" over a
    rectangle is "full".  An "mxu" asked for over a wider span raises,
    as in the reference; "i32" is not a packed engine and resolves to
    auto.  Returns the dict of ``_compare_matrix``.
    """
    symmetric = cols is None
    if symmetric:
        cols, col_base = cells, base
    N, m = cells.shape
    M = cols.shape[0]
    base = base.reshape(-1)
    col_base = col_base.reshape(-1)
    backend = autotune.backend_of(cells)
    if engine == "i32":
        engine = None
    if engine is None:
        cfg = (autotune.lookup("matrix", N, M, m, backend) or {}) \
            if use_autotune else {}
        engine = cfg.get("engine", "tri")
        if engine == "i32":
            engine = "tri"
        if engine == "mxu" and not _mxu_viable(cells, base, cols, col_base):
            engine = "tri"
    if engine not in ("tri", "full", "mxu"):
        raise ValueError(f"unknown packed engine: {engine}")
    if engine == "tri" and not symmetric:
        engine = "full"
    if uniform_base is None:
        b0 = base[:1]
        uniform_base = bool(((base == b0).all() & (col_base == b0).all()).item())
    bi, bj, bm = _matrix_blocks(engine, N, M, m, bi, bj, bm, backend,
                                use_autotune)
    _note_dispatch("matrix", engine, bi=bi, bj=bj, bm=bm)

    row_sums = _packed_row_sums(cells, base, m)
    col_sums = row_sums if symmetric else _packed_row_sums(cols, col_base, m)
    if engine == "tri":
        le, ge = tri_flags(cells, base, bt=max(bi, bj),
                           with_base=not uniform_base)
        return _matrix_dict(le, ge, row_sums, row_sums, m)
    if engine == "full":
        le, ge = rect_u8_flags(cells, cols, base, col_base, bi=bi, bj=bj,
                               with_base=not uniform_base)
        return _matrix_dict(le, ge, row_sums, col_sums, m)
    lo, span = _logical_bounds(cells, base, cols, col_base)
    viol = mxu_viol(cells, cols, base, col_base, lo=lo,
                    n_thresholds=_span_bucket(span), bi=bi, bj=bj)
    return _mxu_finalize(viol, cells, base, cols, col_base, row_sums,
                         col_sums, m, lo)


# ---------------------------------------------------------------------------
# sharded all-pairs
# ---------------------------------------------------------------------------

# gather memo of the "replicated" strategy: registries call all_pairs
# repeatedly on the same slab, so the copy is paid once a slab state, not
# once a call.  Keyed on each shard's identity and version counter (every
# in-place write bumps it) and guarded by strong references to the keyed
# tensors, so an id cannot be reused while the cache holds its tensor.
_REPLICA_CACHE: dict = {}


def _gathered_replica(shards: tuple, dev: torch.device) -> torch.Tensor:
    """The per-shard tensors ``shards`` concatenated in slot order on
    ``dev`` (memoised)."""
    key = (tuple((id(t), t._version) for t in shards), dev)
    hit = _REPLICA_CACHE.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], shards)):
        return hit[1]
    if len(_REPLICA_CACHE) >= 8:
        _REPLICA_CACHE.clear()
    gathered = torch.cat([t.to(dev, non_blocking=True) for t in shards])
    _REPLICA_CACHE[key] = (tuple(shards), gathered)
    return gathered


def _ring_flags(cells: tuple, base: tuple, devices: tuple, bi: int, bj: int,
                with_base: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(le, ge) bool [N, N] on ``devices[0]`` of the symmetric all-pairs
    over the row shards ``cells`` / ``base`` (shard i [N/d, m] on
    ``devices[i]``): the reference's block-row ring
    (``src/repro/kernels/ops.py::_sharded_ring_fn``) as copies between
    cards.

    Step 0 runs tri over each resident shard (the kernel writes the mirror
    of its upper tiles itself).  Step 1 <= s <= d // 2 brings shard i + s
    to shard i and runs rect-u8 of the resident rows against it, block
    (i, i + s); the transposed flags (``le(j, i) = ge(i, j)^T``) go to
    shard i + s as its block (i + s, i).  At the half-way offset of an
    even d only shards i < d/2 compute.  So the ring launches tri d times
    and rect-u8 d(d - 1)/2 times, and each pair's flags are computed
    once, exactly as on one slab.

    Double buffered: the copies of step s + 1 are queued on side streams
    before step s's kernels, each after an event taken when the ring
    starts (the shard's last write), and a card's current stream waits
    only on the copy its next kernel reads.  A visiting shard comes from
    its owner, not from a neighbour: on NVLink, all to all, that is the
    same hop and no copy waits on another.  Bases travel only when they
    are not uniform.  Mirror blocks are written after the last step, so
    no card waits on another before its own sweep is queued.  Each
    shard's [N/d, N] block-row is a view of the output where the shard
    lies on ``devices[0]``, else a buffer on its card copied there at the
    end, which also makes ``devices[0]``'s current stream wait on every
    card."""
    d = len(devices)
    nd = cells[0].shape[0]
    N = nd * d
    dev0 = devices[0]
    if d == 1:
        return tri_flags(cells[0], base[0], bt=max(bi, bj),
                         with_base=with_base)
    le, ge = _flag_pair(N, N, dev0)
    rows = [(le[i * nd:(i + 1) * nd], ge[i * nd:(i + 1) * nd])
            if dev == dev0 else _flag_pair(nd, N, dev)
            for i, dev in enumerate(devices)]
    ready = [mark(dev) for dev in devices]
    steps = d // 2 + 1

    def computes(s: int, i: int) -> bool:
        return not (d % 2 == 0 and s == d // 2) or i < d // 2

    def visit(s: int) -> list:
        out = []
        for i, dev in enumerate(devices):
            j = (i + s) % d
            if s >= steps or not computes(s, i):
                out.append(None)
            elif with_base:
                out.append((send_to(cells[j], dev, ready[j]),
                            send_to(base[j], dev, ready[j])))
            else:
                out.append((send_to(cells[j], dev, ready[j]),
                            (base[i], None)))
        return out

    mirrors = []
    nxt = visit(1)
    for s in range(steps):
        cur = nxt
        if s:
            nxt = visit(s + 1)      # queued before this step's kernels
        for i, dev in enumerate(devices):
            if not computes(s, i):
                continue
            j = (i + s) % d
            if s == 0:
                lf, gf = tri_flags(cells[i], base[i], bt=max(bi, bj),
                                   with_base=with_base)
            else:
                cols, cb = (arrive(x, dev) for x in cur[i])
                lf, gf = rect_u8_flags(cells[i], cols, base[i], cb, bi=bi,
                                       bj=bj, with_base=with_base)
            rows[i][0][:, j * nd:(j + 1) * nd] = lf
            rows[i][1][:, j * nd:(j + 1) * nd] = gf
            if s:
                # block (j, i) of shard j: the transposed flags
                if devices[j] == dev:
                    mirrors.append((j, i, (gf.T, None), (lf.T, None)))
                else:
                    mirrors.append((j, i,
                                    send_to(gf.T.contiguous(), devices[j]),
                                    send_to(lf.T.contiguous(), devices[j])))
    for j, i, le_m, ge_m in mirrors:
        rows[j][0][:, i * nd:(i + 1) * nd] = arrive(le_m, devices[j])
        rows[j][1][:, i * nd:(i + 1) * nd] = arrive(ge_m, devices[j])
    for i, dev in enumerate(devices):
        if dev != dev0:
            le[i * nd:(i + 1) * nd].copy_(rows[i][0])
            ge[i * nd:(i + 1) * nd].copy_(rows[i][1])
    return le, ge


def _mesh_shards(what: str, cells: tuple, base: tuple, mesh) -> tuple:
    """(d, rows a shard, m) of a row-sharded slab, refusing shards that
    do not match the mesh: their count, devices and equal row counts."""
    devices = mesh.devices
    d = len(devices)
    if len(cells) != d or len(base) != d:
        raise ValueError(f"{what}: {len(cells)} row shards and {len(base)} "
                         f"base shards on a mesh of {d} devices")
    nd, m = cells[0].shape
    for i, (c, dev) in enumerate(zip(cells, devices)):
        if c.device != dev:
            raise ValueError(f"{what}: row shard {i} is on {c.device}, its "
                             f"mesh device is {dev}")
        if tuple(c.shape) != (nd, m):
            raise ValueError(f"{what}: row shard {i} is {tuple(c.shape)}, "
                             f"shard 0 is {(nd, m)}")
    return d, nd, m


def _compare_matrix_packed_sharded(cells: tuple, base: tuple, *, mesh,
                                   engine: str | None = None,
                                   strategy: str | None = None,
                                   bi: int | None = None,
                                   bj: int | None = None,
                                   bm: int | None = None,
                                   uniform_base: bool | None = None,
                                   use_autotune: bool = True) -> dict:
    """Symmetric all-pairs over a row-sharded packed slab: ``cells`` and
    ``base`` hold one [N/d, m] u8 and one [N/d] int32 tensor a shard,
    shard i on ``mesh.devices[i]``.  Returns ``_compare_matrix``'s dict
    on ``mesh.devices[0]``.

    The strategy is the argument, else the autotune table's
    ``matrix_sharded`` entry for this backend, global shape and shard
    count, else "ring", the reference's default.  A CUDA mesh whose shards
    share a card reads no entry (``autotune.sharded_table_ok``): the
    entries are measured on distinct cards.

    - "ring" (``_ring_flags``): tri on each shard's diagonal block,
      rect-u8 on the halved off-diagonal blocks, the mirrors shipped;
      blocks from ``_matrix_blocks("full", ..., shards=d)``.
    - "replicated": the shards gathered onto ``mesh.devices[0]``
      (memoised, ``_gathered_replica``) and the one-device engines run
      there unchanged (``_compare_matrix_packed``, no engine hint, as in
      the reference).

    Both are bit-identical to the unsharded slab: flags are exact, and
    sums and fp are finalised on ``mesh.devices[0]`` through the same
    ``_packed_row_sums`` / ``eq3_outer`` as every engine.  Every engine
    name valid unsharded ("tri", "full", "mxu", "i32") is accepted and
    runs the packed ring, as in the reference.  Pass ``uniform_base``
    (the registry's host copy of the bases gives it): the default probes
    every shard's bases, one host sync.
    """
    if engine not in (None, "full", "tri", "mxu", "i32"):
        raise ValueError(f"unknown packed engine: {engine}")
    # keep the caller's tensors where they are flat already: the
    # replica's memo keys on their identity
    base = tuple(b if b.dim() == 1 else b.reshape(-1) for b in base)
    d, nd, m = _mesh_shards("matrix_sharded", cells, base, mesh)
    N = nd * d
    dev0 = mesh.devices[0]
    backend = autotune.backend_of(dev0)
    use_table = use_autotune and autotune.sharded_table_ok(mesh)
    if uniform_base is None:
        b = torch.cat([x.to(dev0) for x in base])
        uniform_base = bool((b == b[:1]).all().item())
    if strategy is None:
        cfg = (autotune.lookup("matrix_sharded", N, N, m, backend, shards=d)
               or {}) if use_table else {}
        strategy = cfg.get("strategy", "ring")
    if strategy == "replicated":
        out = _compare_matrix_packed(
            _gathered_replica(cells, dev0), _gathered_replica(base, dev0),
            bi=bi, bj=bj, bm=bm, uniform_base=uniform_base,
            use_autotune=use_autotune)
        inner = dict(LAST_DISPATCH)
        _note_dispatch("matrix", f"replicated_{inner.get('engine', 'tri')}",
                       bi=inner.get("bi"), bj=inner.get("bj"),
                       bm=inner.get("bm"), shards=d, strategy="replicated")
        return out
    if strategy != "ring":
        raise ValueError(f"unknown sharded strategy: {strategy}")
    bi, bj, bm = _matrix_blocks("full", N, N, m, bi, bj, bm, backend,
                                use_table, shards=d)
    _note_dispatch("matrix", "ring_full", bi=bi, bj=bj, bm=bm, shards=d,
                   strategy="ring")
    le, ge = _ring_flags(tuple(cells), base, mesh.devices, bi, bj,
                         not uniform_base)
    row_sums = torch.cat([_packed_row_sums(c, b, m).to(dev0)
                          for c, b in zip(cells, base)])
    return _matrix_dict(le, ge, row_sums, row_sums, m)


def compare_matrix_packed_sharded(*args, **kwargs) -> dict:
    """DEPRECATED, as in the reference: use ``repro_torch.causal
    .CausalEngine.pairs`` on a sharded ``PackedSlab``.  Delegates to
    ``_compare_matrix_packed_sharded``, so its results are the same."""
    warnings.warn(
        "repro_torch.kernels.ops.compare_matrix_packed_sharded is "
        "deprecated; use the repro_torch.causal.CausalEngine front-door "
        "(engine.pairs) instead", DeprecationWarning, stacklevel=2)
    return _compare_matrix_packed_sharded(*args, **kwargs)


def _shift_pack(x: torch.Tensor, lo: int) -> torch.Tensor:
    return (x.to(torch.int32) - lo).to(torch.uint8)


def _span_probe(rows: torch.Tensor,
                cols: torch.Tensor | None = None) -> tuple[int, int]:
    """(lo, hi) over one or two slabs, fetched in one host transfer."""
    lo, hi = rows.min(), rows.max()
    if cols is not None:
        lo = torch.minimum(lo, cols.min())
        hi = torch.maximum(hi, cols.max())
    lo, hi = torch.stack([lo, hi]).tolist()
    return lo, hi


def _compare_matrix(rows: torch.Tensor, cols: torch.Tensor, *,
                    engine: str | None = None, bi: int | None = None,
                    bj: int | None = None, bm: int | None = None,
                    use_autotune: bool = True) -> dict:
    """Tiled all-pairs compare of int32 logical rows [N, m] vs cols
    [M, m] (``rows is cols`` means symmetric).

    Unless the i32 engine is asked for, the slabs are packed on the fly
    when their global value span fits a byte (one shared window base)
    and go to the packed engines; wider spans, or a table entry whose
    measured winner is "i32", take the int32 kernel, and a packed engine
    asked for by name over a wide span raises.  Returns [N, M]
    ``a_le_b`` / ``b_le_a`` / ``concurrent`` bool matrices, ``fp`` of
    "row before col", and per-row / per-col float32 sums.
    """
    symmetric = rows is cols
    N, m = rows.shape
    M, mc = cols.shape
    if m != mc:
        raise ValueError(f"rows {tuple(rows.shape)} vs cols {tuple(cols.shape)}")
    backend = autotune.backend_of(rows)
    if engine is None and use_autotune:
        # honour a measured "int32 wins here" verdict before the probe
        cfg = autotune.lookup("matrix", N, M, m, backend) or {}
        if cfg.get("engine") == "i32":
            engine = "i32"
    if engine != "i32":
        lo, hi = _span_probe(rows, None if symmetric else cols)
        if hi - lo <= pack.U8_MAX:
            packed_rows = _shift_pack(rows, lo)
            base = torch.full((N,), lo, dtype=torch.int32, device=rows.device)
            kw = dict(engine=engine, bi=bi, bj=bj, bm=bm, uniform_base=True,
                      use_autotune=use_autotune)
            if symmetric:
                return _compare_matrix_packed(packed_rows, base, **kw)
            return _compare_matrix_packed(
                packed_rows, base, _shift_pack(cols, lo),
                torch.full((M,), lo, dtype=torch.int32, device=rows.device),
                **kw)
        if engine is not None:
            raise ValueError(f"engine={engine} needs value span <= "
                             f"{pack.U8_MAX}, got {hi - lo}")
    bi, bj, bm = _matrix_blocks("i32", N, M, m, bi, bj, bm, backend,
                                use_autotune)
    _note_dispatch("matrix", "i32", bi=bi, bj=bj, bm=bm)
    rows = rows.to(torch.int32).contiguous()
    cols = rows if symmetric else cols.to(torch.int32).contiguous()
    col_sums = ref.wrap_sum_i32(cols).to(torch.float32)   # wrapping int32 sum
    le, ge, row_sums, fp = rect_i32_stats(rows, cols, col_sums, bi=bi, bj=bj,
                                          bm=bm)
    return {
        "a_le_b": le,
        "b_le_a": ge,
        "concurrent": ~(le | ge),
        "fp": fp,
        "row_sums": row_sums,
        "col_sums": col_sums,
    }
