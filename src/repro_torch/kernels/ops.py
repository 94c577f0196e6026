"""Wrappers around the CUDA kernels of the main path.

Each wrapper launches its hand-written kernel (``csrc/``) when given
CUDA tensors and raises if the launch fails; it runs the plain PyTorch
version (``kernels.ref``) only for tensors on the CPU.  There is no
fallback from the card to the plain version.

Every launch adds one to ``LAUNCHES[name]``, so a run can show that it
went through the kernels.  ``LAST_DISPATCH`` records the most recent
one-vs-many dispatch (engine and blocks), which ``CausalEngine`` copies
into its results.

The m-tile width follows the JAX wrappers' tile plan (``tile_width``):
m is padded to the 128-lane grain and the tile is the largest multiple
of 128 up to ``bm`` that divides it.  The kernels do not pad; they mask
the ragged edge themselves, and padded zeros add nothing to any sum, so
tile sums and their float32 accumulation order match the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import bloom_indices
from repro_torch.kernels import ref
from repro_torch.kernels._build import library

__all__ = [
    "LAUNCHES",
    "LAST_DISPATCH",
    "pick_block",
    "tile_width",
    "tick",
    "merge_compare",
]

LANE = 128  # the reference's lane grain; fixes its m-tile widths

#: kernel launches per kernel entry point
LAUNCHES: dict[str, int] = {
    "bloom_tick": 0,
    "bloom_merge_compare": 0,
    "one_vs_many_packed": 0,
    "one_vs_many_i32": 0,
}

#: the most recent one-vs-many dispatch: op, engine and blocks
LAST_DISPATCH: dict = {}

# largest dynamic shared memory a block may take on Hopper (bytes)
_SMEM_MAX = 232448


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


def _check(t: torch.Tensor, name: str, dtype, shape: tuple) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
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

def tick_probes(cells: torch.Tensor, probes: torch.Tensor, *,
                bm: int = 512) -> torch.Tensor:
    """cells [B, m] int32 or int16 plus probe ids [B, P] -> new cells."""
    if not cells.is_cuda:
        return ref.bloom_tick_ref(cells, probes)
    B, m = cells.shape
    P = probes.shape[1]
    _check(cells, "tick cells", cells.dtype, (B, m))
    _check(probes, "tick probes", torch.int32, (B, P))
    if cells.dtype not in (torch.int32, torch.int16):
        raise TypeError(f"tick: cells must be int32 or int16, got "
                        f"{cells.dtype}")
    out = torch.empty_like(cells)
    lib = library("bloom_tick")
    fn = lib.bloom_tick_i32 if cells.dtype == torch.int32 else lib.bloom_tick_i16
    with torch.cuda.device(cells.device):
        err = fn(cells.data_ptr(), probes.data_ptr(), out.data_ptr(), B, m, P,
                 bm, _stream(cells))
    _launched(err, "bloom_tick")
    return out


def tick(cells: torch.Tensor, ev_hi, ev_lo, *, k: int = 4,
         bm: int = 512) -> torch.Tensor:
    """Batched bloom tick: cells [B, m], events [B, E], k probes each."""
    B, m = cells.shape
    idx = bloom_indices(ev_hi, ev_lo, k, m, device=cells.device)
    probes = idx.reshape(B, -1).to(torch.int32).contiguous()
    return tick_probes(cells, probes, bm=bm)


def merge_compare(a: torch.Tensor, b: torch.Tensor, *, bm: int = 512) -> dict:
    """Fused receive path over [B, m] int32 logical rows: merged cells,
    dominance flags, sums and Eq. 3 fp both ways, in one pass."""
    B, m = a.shape
    bm = tile_width(m, bm)
    if not a.is_cuda:
        merged, flags, sums, fp = ref.bloom_merge_compare_ref(a, b, bm=bm)
    else:
        _check(a, "merge_compare a", torch.int32, (B, m))
        _check(b, "merge_compare b", torch.int32, (B, m))
        merged = torch.empty_like(a)
        flags = torch.empty((B, 2), dtype=torch.int32, device=a.device)
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
        "a_le_b": flags[:, 0].bool(),
        "b_le_a": flags[:, 1].bool(),
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
        "q_le_p": flags[:, 0].bool(),
        "p_le_q": flags[:, 1].bool(),
        "sum_q": sums[0, 0],
        "sum_p": sums[:, 1],
        "fp_q_before_p": fp[:, 0],
        "fp_p_before_q": fp[:, 1],
    }


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
    _check(q, f"{name} query", torch.int32, (m,))
    _check(peers, f"{name} peers", torch.uint8 if packed else torch.int32,
           (N, m))
    if packed:
        _check(base, f"{name} base", torch.int32, (N,))
    if not 1 <= bn <= 32:
        raise ValueError(f"{name}: bn={bn} rows per block must be in [1, 32]")
    vec = 16 // peers.element_size()
    # the kernel's chunk-transposed query (one_vs_many.cu: query_stride)
    if 4 * vec * ((-(-m // vec)) | 1) > _SMEM_MAX:
        raise ValueError(f"{name}: m={m} query row does not fit shared memory")
    vec_ok = int(m % vec == 0 and peers.data_ptr() % 16 == 0)
    dev = peers.device
    flags = torch.empty((N, 2), dtype=torch.int32, device=dev)
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


def _classify_vs_many_packed(q: torch.Tensor, peers: torch.Tensor,
                             base: torch.Tensor, *, bn: int | None = None,
                             bm: int | None = None) -> dict:
    """One-vs-many classify against a packed slab (u8 residuals + base).
    Blocks default to the reference's built-in bn=8, bm=512."""
    bn = bn or 8
    bm = bm or 512
    _note_dispatch("one_vs_many", "packed", bn=bn, bm=bm)
    return _classify_dict(*_one_vs_many(q, peers, base.reshape(-1), bn, bm))


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
