"""Integer hashing for bloom-clock event ids.

Bit for bit the hash of ``repro.core.hashing``: events are 64-bit ids
carried as (hi, lo) 32-bit lanes; splitmix64 gives h1, murmur3's fmix64
gives h2, and the k probes are ``(h1 + i*h2) mod m`` on 32 bits
(Kirsch-Mitzenmacher double hashing).

torch has no usable uint32 (``>>`` on ``torch.uint32`` is not
implemented on the CPU), so each lane is an int64 tensor masked to 32
bits after every operation.  Products keep the reference's 16-bit split:
a 32x32 product does not fit a signed int64.
"""
from __future__ import annotations

import torch

__all__ = [
    "splitmix64",
    "murmur64",
    "bloom_indices",
    "stable_event_id",
]

_MASK32 = 0xFFFFFFFF


def _lane(x, device=None) -> torch.Tensor:
    """A uint32 lane as a masked int64 tensor."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK32


def _mul32_lo(x, y):
    """Low 32 bits of x*y for 32-bit lanes, no partial product >= 2^49."""
    x0 = x & 0xFFFF
    x1 = x >> 16
    return (x0 * y + ((x1 * (y & 0xFFFF)) << 16)) & _MASK32


def _mul64(a_hi, a_lo, b_hi, b_lo):
    """64x64 -> low 64 bits of the product, on 32-bit lanes."""
    a0 = a_lo & 0xFFFF
    a1 = a_lo >> 16
    b0 = b_lo & 0xFFFF
    b1 = b_lo >> 16
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    carry = mid >> 16
    hi_from_lo = hh + (lh >> 16) + (hl >> 16) + carry
    hi = (_mul32_lo(a_hi, b_lo) + _mul32_lo(a_lo, b_hi) + hi_from_lo) & _MASK32
    return hi, lo


def _add64(a_hi, a_lo, b_hi, b_lo):
    lo = (a_lo + b_lo) & _MASK32
    carry = (lo < a_lo).to(torch.int64)
    hi = (a_hi + b_hi + carry) & _MASK32
    return hi, lo


def _xor64(a_hi, a_lo, b_hi, b_lo):
    return a_hi ^ b_hi, a_lo ^ b_lo


def _shr64(hi, lo, n: int):
    if n == 0:
        return hi, lo
    if n >= 32:
        return torch.zeros_like(hi), hi >> (n - 32)
    lo2 = ((lo >> n) | (hi << (32 - n))) & _MASK32
    return hi >> n, lo2


def _const64(v: int):
    return (v >> 32) & _MASK32, v & _MASK32


def splitmix64(hi, lo):
    """splitmix64 finalizer on (hi, lo) 32-bit lanes."""
    c1 = _const64(0x9E3779B97F4A7C15)
    c2 = _const64(0xBF58476D1CE4E5B9)
    c3 = _const64(0x94D049BB133111EB)
    hi, lo = _add64(hi, lo, *c1)
    x = _xor64(hi, lo, *_shr64(hi, lo, 30))
    hi, lo = _mul64(*x, *c2)
    x = _xor64(hi, lo, *_shr64(hi, lo, 27))
    hi, lo = _mul64(*x, *c3)
    hi, lo = _xor64(hi, lo, *_shr64(hi, lo, 31))
    return hi, lo


def murmur64(hi, lo):
    """murmur3 fmix64 finalizer on (hi, lo) 32-bit lanes."""
    c1 = _const64(0xFF51AFD7ED558CCD)
    c2 = _const64(0xC4CEB9FE1A85EC53)
    hi, lo = _xor64(hi, lo, *_shr64(hi, lo, 33))
    hi, lo = _mul64(hi, lo, *c1)
    hi, lo = _xor64(hi, lo, *_shr64(hi, lo, 33))
    hi, lo = _mul64(hi, lo, *c2)
    hi, lo = _xor64(hi, lo, *_shr64(hi, lo, 33))
    return hi, lo


def bloom_indices(event_hi, event_lo, k: int, m: int, *,
                  device=None) -> torch.Tensor:
    """k bloom-filter indices in [0, m) for each event.

    event_hi/event_lo: uint32 values (ints, numpy arrays or tensors) of
    one shape S.  Returns an int64 tensor of shape S + (k,) on
    ``device`` (default: the device of ``event_hi`` when it is a tensor,
    else the CPU).
    """
    if device is None and isinstance(event_hi, torch.Tensor):
        device = event_hi.device
    event_hi = _lane(event_hi, device)
    event_lo = _lane(event_lo, device)
    h1_hi, h1_lo = splitmix64(event_hi, event_lo)
    h2_hi, h2_lo = murmur64(event_hi, event_lo)
    h1 = h1_hi ^ h1_lo
    # odd stride: coprime with any power-of-two m, never collapses probes
    h2 = (h2_hi ^ h2_lo) | 1
    i = torch.arange(k, dtype=torch.int64, device=event_hi.device)
    idx = (h1[..., None] + i * h2[..., None]) & _MASK32
    return idx % m


def stable_event_id(*parts) -> tuple[int, int]:
    """Deterministically mix python ints / bytes / str into a 64-bit
    event id (FNV-1a); returns (hi, lo) 32-bit python ints."""
    acc = 0xCBF29CE484222325  # FNV offset basis
    for p in parts:
        if isinstance(p, bytes):
            data = p
        elif isinstance(p, str):
            data = p.encode()
        else:
            data = int(p).to_bytes(8, "little", signed=False)
        for b in data:
            acc ^= b
            acc = (acc * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF  # FNV prime
    return (acc >> 32) & 0xFFFFFFFF, acc & 0xFFFFFFFF
