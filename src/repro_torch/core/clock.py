"""The Bloom Clock (Ramabaja, 2019) on PyTorch tensors.

A clock is a counting bloom filter of ``m`` int32 cells plus a scalar
``base`` (the paper's §4 compression): the logical value of cell i is
``base + cells[i]``.  Batched clocks carry leading batch dims.

Bounded-counter semantics, as in ``repro.core.clock``: int32 counters
live on the mod-2^32 circle, so compare, max and min derive from the
wrap-subtraction ``a - b``, and ``clock_sum`` reads cells through their
mod-2^32 positions.  torch's int32 ``+``/``-`` wrap on overflow; the
tests pin that with near-wrap cases.

``tick`` goes through ``kernels.ops.tick_probes``: the CUDA tick kernel
for a clock on the card, its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.kernels import ops, ref

__all__ = [
    "BloomClock",
    "Ordering",
    "zeros",
    "tick",
    "merge",
    "ordering",
    "compare",
    "fp_rate",
    "compress",
    "decompress",
    "clock_sum",
    "residual_span",
    "to_wire",
    "from_wire",
    "happened_before",
    "comparability_matrix",
]

_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class BloomClock:
    """Counting-bloom-filter logical clock.

    cells: int32[..., m] residual counters.
    base:  int32[...]    shared offset; logical cell = base + cells[i].
    k:     number of hash probes per event.
    """

    cells: torch.Tensor
    base: torch.Tensor
    k: int = 4

    @property
    def m(self) -> int:
        return self.cells.shape[-1]

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.cells.shape[:-1])

    @property
    def device(self) -> torch.device:
        return self.cells.device

    def logical_cells(self) -> torch.Tensor:
        return self.cells + self.base[..., None].to(self.cells.dtype)

    def sum(self) -> torch.Tensor:
        return clock_sum(self)


def zeros(m: int, k: int = 4, batch_shape: tuple = (), dtype=torch.int32,
          device=None) -> BloomClock:
    return BloomClock(
        cells=torch.zeros(tuple(batch_shape) + (m,), dtype=dtype, device=device),
        base=torch.zeros(tuple(batch_shape), dtype=dtype, device=device),
        k=k,
    )


def _as_mod_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 counters as their mod-2^32 positions (int64 in [0, 2^32))."""
    return x.to(torch.int64) & _MASK32


def clock_sum(c: BloomClock) -> torch.Tensor:
    """Total increments (Σ cells + m·base) as float32.

    The reference sums the uint32 view in uint32, which wraps mod 2^32
    before the float cast; torch sums int32 into int64, so the sum is
    masked back to 32 bits first.
    """
    s = (_as_mod_u32(c.cells).sum(-1) & _MASK32).to(torch.float32)
    return s + _as_mod_u32(c.base).to(torch.float32) * c.m


def tick(c: BloomClock, event_hi, event_lo) -> BloomClock:
    """Record event(s): increment the k hashed cells per event.

    event_hi/lo: uint32 values whose shape is ``c.batch_shape`` (one
    event per clock) or ``c.batch_shape + (E,)`` (E events per clock).
    """
    B = int(np.prod(c.batch_shape, dtype=np.int64))
    hi, lo = (torch.as_tensor(e, dtype=torch.int64, device=c.device).reshape(B, -1)
              for e in (event_hi, event_lo))
    cells = ops.tick(c.cells.reshape(B, c.m).contiguous(), hi, lo, k=c.k)
    return dataclasses.replace(c, cells=cells.reshape(c.cells.shape))


def merge(a: BloomClock, b: BloomClock) -> BloomClock:
    """§3 step 3: element-wise max of logical cells, derived from the
    wrap-subtraction ``a + relu(b - a)``; keeps the max base."""
    la = a.logical_cells()
    lb = b.logical_cells()
    mx = la + torch.clamp(lb - la, min=0)
    base = torch.where(a.base - b.base >= 0, a.base, b.base)
    return BloomClock(cells=mx - base[..., None].to(mx.dtype), base=base, k=a.k)


@dataclasses.dataclass(frozen=True)
class Ordering:
    """Result of comparing two clocks A, B (see ``repro.core.clock``)."""

    a_le_b: torch.Tensor
    b_le_a: torch.Tensor
    concurrent: torch.Tensor
    equal: torch.Tensor
    fp_a_before_b: torch.Tensor
    fp_b_before_a: torch.Tensor


def fp_rate(sum_a, sum_b, m: int) -> torch.Tensor:
    """Paper Eq. 3: (1 - (1 - 1/m)^{ΣB})^{ΣA} in float32, computed as
    exp(ΣA * log(clip(-expm1(ΣB * log1p(-1/m)), 1e-30, 1)))."""
    sum_a = torch.as_tensor(sum_a, dtype=torch.float32)
    sum_b = torch.as_tensor(sum_b, dtype=torch.float32, device=sum_a.device)
    return ref.eq3_fp(sum_a, sum_b, m)


def ordering(a: BloomClock, b: BloomClock) -> Ordering:
    """Cell-wise partial order by wrap-subtraction, plus Eq. 3 fp."""
    d = b.logical_cells() - a.logical_cells()
    a_le_b = (d >= 0).all(-1)
    b_le_a = (d <= 0).all(-1)
    sa = clock_sum(a)
    sb = clock_sum(b)
    return Ordering(
        a_le_b=a_le_b,
        b_le_a=b_le_a,
        concurrent=~(a_le_b | b_le_a),
        equal=a_le_b & b_le_a,
        fp_a_before_b=fp_rate(sa, sb, a.m),
        fp_b_before_a=fp_rate(sb, sa, a.m),
    )


def compare(a: BloomClock, b: BloomClock) -> Ordering:
    """DEPRECATED alias of ``ordering``; use ``repro_torch.causal.compare``
    (typed ``Comparison``) or ``ordering`` directly."""
    warnings.warn(
        "repro_torch.core.clock.compare is deprecated; use "
        "repro_torch.causal.compare (typed Comparison results) or "
        "repro_torch.core.clock.ordering",
        DeprecationWarning, stacklevel=2)
    return ordering(a, b)


def compress(c: BloomClock) -> BloomClock:
    """§4: lift min(cells) into the base; the min is taken over
    wrap-differences from the first cell."""
    ref = c.cells[..., :1]
    mn = ref[..., 0] + (c.cells - ref).amin(-1)
    return BloomClock(cells=c.cells - mn[..., None],
                      base=c.base + mn.to(c.base.dtype), k=c.k)


def decompress(c: BloomClock) -> BloomClock:
    """Inverse of compress (materialize logical cells, zero base)."""
    return BloomClock(cells=c.logical_cells(), base=torch.zeros_like(c.base),
                      k=c.k)


def residual_span(c: BloomClock) -> torch.Tensor:
    """max - min of the residual cells (wrap-safe §4 window width)."""
    d = c.cells - c.cells[..., :1]
    return d.amax(-1) - d.amin(-1)


def to_wire(c: BloomClock) -> dict:
    """Wire snapshot of one clock: §4 compression, u8 residuals when the
    window fits a byte, int32 otherwise."""
    cc = compress(c)
    cells = cc.cells.cpu().numpy()
    if cells.max(initial=0) <= 255:
        cells = cells.astype(np.uint8)
    return {"cells": cells, "base": int(cc.base), "k": cc.k}


def from_wire(snap, device=None) -> BloomClock:
    """Rebuild a clock from a ``to_wire`` dict or an encoded clock frame
    (``core.wire.encode_clock`` bytes, validated first)."""
    if isinstance(snap, (bytes, bytearray, memoryview)):
        from repro_torch.core import wire
        snap = wire.decode_clock(snap)
    cells = np.asarray(snap["cells"]).astype(np.int32)
    return BloomClock(
        cells=torch.as_tensor(cells, device=device),
        base=torch.tensor(int(snap["base"]), dtype=torch.int32, device=device),
        k=int(snap["k"]),
    )


def happened_before(a: BloomClock, b: BloomClock, threshold: float = 0.01):
    """Where "A -> B" holds with Eq. 3 fp within ``threshold``."""
    o = ordering(a, b)
    return o.a_le_b & (o.fp_a_before_b <= threshold)


def comparability_matrix(clocks: BloomClock) -> dict:
    """All-pairs comparison of a batch of clocks [n, m] by broadcasting:
    [n, n] ``a_le_b``, ``concurrent`` and ``fp`` (of "row -> col").  The
    O(n^2 * m) yardstick the tiled all-pairs engines are held against."""
    a = BloomClock(cells=clocks.cells[:, None, :], base=clocks.base[:, None],
                   k=clocks.k)
    b = BloomClock(cells=clocks.cells[None, :, :], base=clocks.base[None, :],
                   k=clocks.k)
    o = ordering(a, b)
    return {"a_le_b": o.a_le_b, "concurrent": o.concurrent,
            "fp": o.fp_a_before_b}
