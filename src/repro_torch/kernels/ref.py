"""Plain PyTorch versions of the CUDA kernels.

Each function computes exactly what its kernel in ``csrc/`` computes,
including the order of float32 additions, so the CPU path and the tests
reproduce the JAX package's Pallas kernels bit for bit where the
arithmetic is integer or f32 addition, and within libm ulps for Eq. 3:

- integer sums are taken per m-tile of width ``bm`` with int32
  wrap-around (``torch.sum`` of int32 returns int64, so each tile sum is
  folded back to 32 bits), cast to float32, and added tile by tile in
  order, as the Pallas kernels accumulate their revisited outputs;
- Eq. 3 is ``exp(Σx · log(clip(-expm1(Σy · log_q), 1e-30, 1)))`` with
  ``log_q`` the float32 ``log1p`` of float32(-1/m).

The wrappers in ``kernels.ops`` run these only for tensors on the CPU.
"""
from __future__ import annotations

import torch

__all__ = [
    "eq3_log_q",
    "eq3_fp",
    "tile_sums",
    "bloom_tick_ref",
    "bloom_merge_compare_ref",
    "one_vs_many_ref",
    "hybrid_classify_ref",
    "wrap_sum_i32",
    "tri_flags_ref",
    "rect_u8_flags_ref",
    "rect_i32_stats_ref",
    "mxu_viol_ref",
]

# elements of the largest [rows, cols, m] intermediate the all-pairs
# plain versions build at once; rows are taken in chunks below it, so
# they also run at the card's full slab sizes
_CHUNK_ELEMS = 1 << 28

EQ3_CLIP = 1e-30
_MASK32 = 0xFFFFFFFF


def eq3_log_q(m: int) -> torch.Tensor:
    """float32 log(1 - 1/m), computed as the reference computes it."""
    return torch.log1p(torch.tensor(-1.0 / m, dtype=torch.float32))


def eq3_fp(sum_x: torch.Tensor, sum_y: torch.Tensor, m: int) -> torch.Tensor:
    """Eq. 3 fp of "X -> Y": (1 - (1 - 1/m)^ΣY)^ΣX, log-stable, float32."""
    # a Python float holding the float32 value: exact as a scalar operand,
    # and no host-to-device copy (which would synchronise the stream)
    log_q = float(eq3_log_q(m))
    inner = (-torch.expm1(sum_y * log_q)).clamp(EQ3_CLIP, 1.0)
    return torch.exp(sum_x * torch.log(inner))


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Fold int64 values onto the int32 two's-complement circle."""
    x = x & _MASK32
    return torch.where(x >= 0x80000000, x - 0x100000000, x)


def tile_sums(x: torch.Tensor, bm: int) -> torch.Tensor:
    """[..., m] integers -> float32 [...]: int32 sums of each bm-wide
    m-tile (wrapping), cast to float32 and added in tile order."""
    m = x.shape[-1]
    n_tiles = -(-m // bm)
    xp = torch.nn.functional.pad(x.to(torch.int64), (0, n_tiles * bm - m))
    per_tile = _wrap_i32(xp.reshape(*x.shape[:-1], n_tiles, bm).sum(-1))
    per_tile = per_tile.to(torch.float32)
    acc = per_tile[..., 0]
    for t in range(1, n_tiles):
        acc = acc + per_tile[..., t]
    return acc


def bloom_tick_ref(cells: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """cells [B, m] int32 or int16, probes [B, P] -> incremented cells.

    The one-hot count of ``kernels/bloom_tick.py``: probes outside
    [0, m) hit nothing; 16-bit cells accumulate in int32 and are cast
    back.
    """
    m = cells.shape[-1]
    cols = torch.arange(m, device=cells.device)
    inc = (probes.to(torch.int64)[:, :, None] == cols).sum(1)
    return (cells.to(torch.int32) + inc.to(torch.int32)).to(cells.dtype)


def bloom_merge_compare_ref(a: torch.Tensor, b: torch.Tensor, *, bm: int):
    """Fused receive path over [B, m] int32 rows (direct compares, as
    ``kernels/bloom_compare.py``): returns (merged, flags [B, 2] bool
    = (all(a<=b), all(a>=b)), sums [B, 2] f32, fp [B, 2] f32 = (fp of
    "a -> b", fp of "b -> a"))."""
    m = a.shape[-1]
    merged = torch.maximum(a, b)
    flags = torch.stack([(a <= b).all(-1), (a >= b).all(-1)], -1)
    sa = tile_sums(a, bm)
    sb = tile_sums(b, bm)
    fp = torch.stack([eq3_fp(sa, sb, m), eq3_fp(sb, sa, m)], -1)
    return merged, flags, torch.stack([sa, sb], -1), fp


def one_vs_many_ref(q: torch.Tensor, peers: torch.Tensor,
                    base: torch.Tensor | None = None, *, bm: int):
    """One query [m] int32 vs N peers: [N, m] int32 logical rows, or u8
    residuals plus ``base`` [N] int32 (widened with int32 wrap).

    ``d = p - q`` by int32 wrap-subtraction; flags [N, 2] bool =
    (all(d >= 0), all(d <= 0)); sums [N, 2] f32 = (Σq, Σp); fp [N, 2]
    = (fp of "q -> p", fp of "p -> q").
    """
    m = q.shape[-1]
    p = peers.to(torch.int32)
    if base is not None:
        p = p + base.reshape(-1, 1).to(torch.int32)
    d = p - q.to(torch.int32)[None, :]
    flags = torch.stack([(d >= 0).all(-1), (d <= 0).all(-1)], -1)
    sp = tile_sums(p, bm)
    sq = tile_sums(q, bm).expand_as(sp)
    fp = torch.stack([eq3_fp(sq, sp, m), eq3_fp(sp, sq, m)], -1)
    return flags, torch.stack([sq, sp], -1), fp


def hybrid_classify_ref(q: torch.Tensor, v_local: int,
                        hot_meta: torch.Tensor, hot_sums: torch.Tensor,
                        tail: torch.Tensor, tail_base: torch.Tensor, *,
                        bm: int):
    """One query [m] int32 vs H exact hot rows and T packed tail rows
    (``template.py::_emit_hybrid``); outputs stacked hot first, each
    [H + T, 2] as in ``one_vs_many_ref``.

    Hot row ``(v, n_private)`` of ``hot_meta`` [H, 2] int32: flags =
    (V <= v, v <= V and n_private == 0) against the local chain version
    V = ``v_local``; sums = (Σq per bm-wide tile as the tail rows take
    it, its ``hot_sums`` [H] value); fp = 0.  Tail rows: exactly
    ``one_vs_many_ref`` on ``tail`` [T, m] u8 with ``tail_base`` [T].
    """
    t_flags, t_sums, t_fp = one_vs_many_ref(q, tail, tail_base, bm=bm)
    H = hot_meta.shape[0]
    v = hot_meta[:, 0].to(torch.int32)
    n_private = hot_meta[:, 1].to(torch.int32)
    h_flags = torch.stack([v_local <= v, (v <= v_local) & (n_private == 0)],
                          -1)
    sq = tile_sums(q, bm).expand(H)
    h_sums = torch.stack([sq, hot_sums.reshape(-1).to(torch.float32)], -1)
    h_fp = torch.zeros((H, 2), dtype=torch.float32, device=q.device)
    return (torch.cat([h_flags, t_flags]), torch.cat([h_sums, t_sums]),
            torch.cat([h_fp, t_fp]))


# ---------------------------------------------------------------------------
# all-pairs
# ---------------------------------------------------------------------------

def wrap_sum_i32(x: torch.Tensor) -> torch.Tensor:
    """Row sums of [..., m] integers with int32 wrap-around (int64 values
    in the int32 range), as the reference's int32 ``jnp.sum``."""
    return _wrap_i32(x.to(torch.int64).sum(-1))


def _row_chunks(n_rows: int, n_cols: int, m: int):
    step = max(1, _CHUNK_ELEMS // max(1, n_cols * m))
    return range(0, n_rows, step), step


def _diff_bounds(rows: torch.Tensor, cols: torch.Tensor, dtype):
    """(max, min) over m of ``a_i - b_j`` for every pair, [N, M] int32 each;
    the difference is taken in ``dtype`` (int32 wraps)."""
    N, M = rows.shape[0], cols.shape[0]
    hi = torch.empty((N, M), dtype=torch.int32, device=rows.device)
    lo = torch.empty_like(hi)
    b = cols.to(dtype)
    starts, step = _row_chunks(N, M, rows.shape[1])
    for r0 in starts:
        d = rows[r0:r0 + step].to(dtype)[:, None, :] - b[None, :, :]
        mn, mx = torch.aminmax(d, dim=-1)
        hi[r0:r0 + step] = mx
        lo[r0:r0 + step] = mn
    return hi, lo


def rect_u8_flags_ref(rows: torch.Tensor, cols: torch.Tensor,
                      row_base: torch.Tensor | None = None,
                      col_base: torch.Tensor | None = None):
    """Packed all-pairs flags (``template.py::_pair_flags_u8``): rows
    [N, m] and cols [M, m] u8 residuals, optional int32 bases [N], [M].

    Per pair ``d = a - b + clip(row_base - col_base, -256, 256)`` (the
    base delta an int32 wrap-subtraction before the clip, 0 without
    bases); le = max(d) <= 0, ge = min(d) >= 0, as bool [N, M].  The
    delta is constant over the m lanes, so it is added to max(a - b) and
    min(a - b).
    """
    hi, lo = _diff_bounds(rows, cols, torch.int16)
    if row_base is not None:
        delta = _wrap_i32(row_base.to(torch.int64)[:, None]
                          - col_base.to(torch.int64)[None, :])
        delta = delta.clamp(-256, 256).to(torch.int32)
        hi = hi + delta
        lo = lo + delta
    return hi <= 0, lo >= 0


def tri_flags_ref(cells: torch.Tensor, base: torch.Tensor | None = None):
    """Symmetric packed all-pairs flags over one slab: pairs i <= j as
    ``rect_u8_flags_ref`` computes them, pairs i > j by the mirror
    le(i, j) = ge(j, i) (the TPU kernel sweeps the upper triangle only)."""
    le, ge = rect_u8_flags_ref(cells, cells, base, base)
    n = cells.shape[0]
    idx = torch.arange(n, device=cells.device)
    upper = idx[:, None] <= idx[None, :]
    return torch.where(upper, le, ge.T), torch.where(upper, ge, le.T)


def rect_i32_stats_ref(rows: torch.Tensor, cols: torch.Tensor,
                       col_sums: torch.Tensor, *, bm: int):
    """int32 all-pairs (``template.py::_emit_rect_i32_stats``): rows
    [N, m], cols [M, m] int32 logical cells, col_sums [M] float32.

    ``d = a - b`` by int32 wrap-subtraction; le = all(d <= 0), ge =
    all(d >= 0) as bool [N, M]; row sums [N] float32 per bm-wide m-tile
    (``tile_sums``); fp [N, M] = Eq. 3 of "row -> col" from the row sums
    and ``col_sums``.
    """
    hi, lo = _diff_bounds(rows, cols, torch.int32)
    row_sums = tile_sums(rows, bm)
    fp = eq3_fp(row_sums[:, None], col_sums[None, :], rows.shape[1])
    return hi <= 0, lo >= 0, row_sums, fp


def mxu_viol_ref(rows: torch.Tensor, cols: torch.Tensor,
                 row_base: torch.Tensor, col_base: torch.Tensor, *,
                 lo: int, n_thresholds: int) -> torch.Tensor:
    """Violation counts (``template.py::_emit_mxu``): float32 [N, M] of
    ``sum_m #{t in 1..T: b < t <= a}`` with a = u8 + (row_base - lo) and
    b = u8 + (col_base - lo) (int32 wrap), which is
    ``relu(min(a, T) - max(b, 0))`` per lane: the thermometer product
    without the encoding.  a is clamped to [-1, T] and b to [0, T + 1],
    which keeps every count."""
    T = n_thresholds
    a = (rows.to(torch.int32) + (row_base.to(torch.int32) - lo)[:, None])
    b = (cols.to(torch.int32) + (col_base.to(torch.int32) - lo)[:, None])
    a = a.clamp(-1, T)
    b = b.clamp(0, T + 1)
    N, M = rows.shape[0], cols.shape[0]
    viol = torch.empty((N, M), dtype=torch.float32, device=rows.device)
    starts, step = _row_chunks(N, M, rows.shape[1])
    for r0 in starts:
        d = (a[r0:r0 + step, None, :] - b[None, :, :]).clamp_(min=0)
        viol[r0:r0 + step] = d.sum(-1).to(torch.float32)
    return viol
