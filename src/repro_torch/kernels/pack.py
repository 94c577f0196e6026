"""Quantized slab packing: int32 bloom-clock cells <-> u8 residuals + base.

The §4 moving window keeps a clock's cells within a byte of each other,
so a slab of N peer clocks is stored as one int32 ``base`` per row plus
u8 residuals ``cells - base``: a quarter of the int32 bytes, which is
what every bulk compare is bound by.  Packing is lossless or refused:
``ok`` is False for a row whose span exceeds ``U8_MAX``, and the caller
promotes that row instead of using its clipped residuals.

Same arithmetic as ``repro.kernels.pack`` (direct min/max, int32
wrap-around); functions follow their tensors' device.
"""
from __future__ import annotations

import torch

__all__ = ["U8_MAX", "pack_rows", "unpack_rows", "rows_fit_u8"]

U8_MAX = 255


def pack_rows(cells: torch.Tensor, base: torch.Tensor | None = None):
    """Pack int32 rows [N, m] into (residuals u8, base i32 [N], ok [N]).

    ``base`` is an offset already applied to ``cells`` (None = zeros).
    The row minimum is lifted into the base, so residuals have min 0.
    """
    cells = cells.to(torch.int32)
    if base is None:
        base = torch.zeros(cells.shape[:-1], dtype=torch.int32,
                           device=cells.device)
    mn = cells.amin(dim=-1)
    span = cells.amax(dim=-1) - mn
    resid = cells - mn[..., None]
    packed = resid.clamp(0, U8_MAX).to(torch.uint8)
    return packed, base.to(torch.int32) + mn, span <= U8_MAX


def unpack_rows(packed: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_rows``: int32 logical cells."""
    return packed.to(torch.int32) + base.to(torch.int32)[..., None]


def rows_fit_u8(cells: torch.Tensor) -> torch.Tensor:
    """[N] bool: can each int32 row be packed losslessly?"""
    cells = cells.to(torch.int32)
    return (cells.amax(dim=-1) - cells.amin(dim=-1)) <= U8_MAX
