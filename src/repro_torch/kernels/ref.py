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
]

EQ3_CLIP = 1e-30
_MASK32 = 0xFFFFFFFF


def eq3_log_q(m: int) -> torch.Tensor:
    """float32 log(1 - 1/m), computed as the reference computes it."""
    return torch.log1p(torch.tensor(-1.0 / m, dtype=torch.float32))


def eq3_fp(sum_x: torch.Tensor, sum_y: torch.Tensor, m: int) -> torch.Tensor:
    """Eq. 3 fp of "X -> Y": (1 - (1 - 1/m)^ΣY)^ΣX, log-stable, float32."""
    log_q = eq3_log_q(m).to(sum_y.device)
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
    ``kernels/bloom_compare.py``): returns (merged, flags [B, 2] int32
    = (all(a<=b), all(a>=b)), sums [B, 2] f32, fp [B, 2] f32 = (fp of
    "a -> b", fp of "b -> a"))."""
    m = a.shape[-1]
    merged = torch.maximum(a, b)
    flags = torch.stack([(a <= b).all(-1), (a >= b).all(-1)], -1)
    sa = tile_sums(a, bm)
    sb = tile_sums(b, bm)
    fp = torch.stack([eq3_fp(sa, sb, m), eq3_fp(sb, sa, m)], -1)
    return merged, flags.to(torch.int32), torch.stack([sa, sb], -1), fp


def one_vs_many_ref(q: torch.Tensor, peers: torch.Tensor,
                    base: torch.Tensor | None = None, *, bm: int):
    """One query [m] int32 vs N peers: [N, m] int32 logical rows, or u8
    residuals plus ``base`` [N] int32 (widened with int32 wrap).

    ``d = p - q`` by int32 wrap-subtraction; flags [N, 2] int32 =
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
    return flags.to(torch.int32), torch.stack([sq, sp], -1), fp
