"""Binary wire framing for §4 clock snapshots and anti-entropy digests.

``core.clock.to_wire`` decides WHAT ships — u8 window residuals plus one
int32 base when the §4 moving window fits a byte (the common case the
paper argues for), int32 cells otherwise.  This module decides HOW it
ships between processes: a fixed header, an explicit big-endian payload,
and a CRC32 trailer, so a receiver at the far end of a TCP stream can
reject truncated, corrupted, or future-versioned frames with a clear
error instead of silently reconstructing a garbage clock.

Clock frame layout (``encode_clock`` / ``decode_clock``):

    bytes 0-1    magic ``b"BC"``
    byte  2      wire version (currently 1)
    byte  3      cell dtype code: 0 = uint8 residuals, 1 = int32 cells
    byte  4      k (hash probes per event)
    byte  5      reserved (0)
    bytes 6-9    m (cell count), u32
    bytes 10-13  base (§4 window offset), i32
    ...          cells payload: m bytes (u8) or 4·m bytes (i32)
    last 4       CRC32 over everything before it, u32

Exact-row frames (``encode_exact`` / ``decode_exact``, wire version 2)
carry the hybrid engine's hot-set representation: not bloom cells at all
but the exact causal coordinates of a session relative to its minting
replica's local chain — the chain-prefix length ``v``, the count of
private (post-fork) events, and the private event ids themselves.  A
receiver holding the same chain can then answer ordering queries with
ZERO false positives (integer compares, no Eq. 3 exposure), which is
the whole point of promoting a hot session out of the bloom slab.
Layout:

    bytes 0-1    magic ``b"BE"``
    byte  2      wire version
    byte  3      k (geometry the session's shadow bloom row uses)
    bytes 4-11   v (local-chain prefix length), u64
    bytes 12-15  n_private (private events past the prefix), u32
    ...          n_private × 16 bytes: (event_hi u64, event_lo u64) pairs
    last 4       CRC32 over everything before it, u32

Digest frames (``encode_digest`` / ``decode_digest``) are the tiny
per-peer summaries anti-entropy sessions exchange FIRST: a peer whose
digest matches what the caller already ingested is skipped entirely, so
a quiet fleet costs digest bytes only.  A digest carries the clock sum
(the Eq. 3 / straggler input), the §4 base, and a CRC32 of the logical
cells — the content key delta decisions are made on.  Two clocks with
equal sums are NOT necessarily equal (any two event sets of the same
size tie), so the checksum, not the sum, is what detects a changed row.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

__all__ = [
    "WIRE_VERSION",
    "WireFormatError",
    "ClockDigest",
    "encode_clock",
    "decode_clock",
    "clock_frame_nbytes",
    "encode_exact",
    "decode_exact",
    "exact_frame_nbytes",
    "cells_crc",
    "digest_of",
    "encode_digest",
    "decode_digest",
]

#: version 2 added the exact-row frame kind (``b"BE"``) for the hybrid
#: engine's hot set; clock/digest layouts are unchanged from version 1.
WIRE_VERSION = 2

_CLOCK_MAGIC = b"BC"
_DIGEST_MAGIC = b"BD"
_EXACT_MAGIC = b"BE"
_U8, _I32 = 0, 1

_CLOCK_HDR = struct.Struct("!2sBBBxIi")
#                magic ver k idlen pad m  sum  base crc
_DIGEST_HDR = struct.Struct("!2sBBBxIdiI")
#               magic ver k  v  n_private
_EXACT_HDR = struct.Struct("!2sBBQI")
_EVENT = struct.Struct("!QQ")
_CRC = struct.Struct("!I")


class WireFormatError(ValueError):
    """A frame failed validation: truncated, corrupted, or wrong version."""


def _wrap_i32(value: int) -> int:
    """Fold an integer onto the int32 two's-complement circle.

    Bounded-counter semantics: wire bases are mod-2^32 positions, so a
    host-side counter that ticked past ``INT32_MAX`` (e.g. a ClockNode's
    int64 cells) ships as its wrapped representative instead of crashing
    ``struct.pack`` — the wrap-subtraction compares on the receiving
    side read it back correctly.  Identity for values already in range.
    """
    value = int(value) & 0xFFFFFFFF
    return value - 0x100000000 if value >= 0x80000000 else value


def _check_magic_version(buf: bytes, magic: bytes, kind: str) -> None:
    if len(buf) < 3:
        raise WireFormatError(
            f"truncated {kind} frame: {len(buf)} bytes is too short even "
            f"for the magic + version prefix")
    if buf[:2] != magic:
        raise WireFormatError(
            f"bad {kind} frame magic {buf[:2]!r} (expected {magic!r}) — "
            "not a bloom-clock wire frame, or framing lost sync")
    if buf[2] != WIRE_VERSION:
        raise WireFormatError(
            f"unsupported {kind} wire version {buf[2]} "
            f"(this build speaks version {WIRE_VERSION})")


def cells_crc(cells: np.ndarray, base: int = 0) -> int:
    """CRC32 of the canonical logical cells (base applied, int32 BE).

    Representation-independent: a (u8 residuals, base) row and its
    materialized int32 logical cells hash identically, so digests match
    across the packed and promoted storage forms.
    """
    logical = np.asarray(cells, np.int64) + int(base)
    return zlib.crc32(np.ascontiguousarray(logical.astype(">i4")).tobytes())


# ---------------------------------------------------------------------------
# clock frames
# ---------------------------------------------------------------------------

def encode_clock(snap: dict) -> bytes:
    """Encode a ``core.clock.to_wire`` snapshot dict as one binary frame."""
    cells = np.asarray(snap["cells"])
    if cells.ndim != 1:
        raise ValueError(f"one clock per frame; got cells shape {cells.shape}")
    if cells.dtype == np.uint8:
        code, payload = _U8, cells.tobytes()
    else:
        code = _I32
        payload = np.ascontiguousarray(cells.astype(">i4")).tobytes()
    body = _CLOCK_HDR.pack(_CLOCK_MAGIC, WIRE_VERSION, code,
                           int(snap["k"]), cells.shape[0],
                           _wrap_i32(snap["base"])) + payload
    return body + _CRC.pack(zlib.crc32(body))


def decode_clock(buf: bytes) -> dict:
    """Decode one clock frame back to a ``from_wire``-shaped snapshot dict.

    Raises :class:`WireFormatError` on truncation, trailing garbage,
    checksum mismatch, unknown version, or a dtype code this build does
    not know — never returns a partially-decoded clock.
    """
    buf = bytes(buf)
    _check_magic_version(buf, _CLOCK_MAGIC, "clock")
    if len(buf) < _CLOCK_HDR.size:
        raise WireFormatError(
            f"truncated clock frame: {len(buf)} bytes, need "
            f"{_CLOCK_HDR.size} for the header")
    _, _, code, k, m, base = _CLOCK_HDR.unpack_from(buf)
    if code not in (_U8, _I32):
        raise WireFormatError(f"unknown cell dtype code {code}")
    cell_bytes = m * (1 if code == _U8 else 4)
    expect = _CLOCK_HDR.size + cell_bytes + _CRC.size
    if len(buf) < expect:
        raise WireFormatError(
            f"truncated clock frame: {len(buf)} bytes, header declares "
            f"m={m} ({'u8' if code == _U8 else 'i32'} cells) = {expect}")
    if len(buf) > expect:
        raise WireFormatError(
            f"oversized clock frame: {len(buf)} bytes, header declares "
            f"{expect} — {len(buf) - expect} trailing bytes")
    (crc,) = _CRC.unpack_from(buf, expect - _CRC.size)
    if crc != zlib.crc32(buf[: expect - _CRC.size]):
        raise WireFormatError(
            "corrupted clock frame: CRC32 mismatch over header + cells")
    raw = buf[_CLOCK_HDR.size: _CLOCK_HDR.size + cell_bytes]
    if code == _U8:
        cells = np.frombuffer(raw, np.uint8).copy()
    else:
        cells = np.frombuffer(raw, ">i4").astype(np.int32)
    return {"cells": cells, "base": int(base), "k": int(k)}


def clock_frame_nbytes(m: int, packed: bool = True) -> int:
    """Encoded frame size for an m-cell clock (u8 vs promoted int32)."""
    return _CLOCK_HDR.size + m * (1 if packed else 4) + _CRC.size


# ---------------------------------------------------------------------------
# exact-row frames (hybrid hot set)
# ---------------------------------------------------------------------------

def encode_exact(meta: dict) -> bytes:
    """Encode an exact hot-row snapshot ``{"v", "n_private", "events",
    "k"}`` as one binary frame.

    ``events`` is the sequence of private (event_hi, event_lo) id pairs;
    its length must equal ``n_private`` (when ``n_private`` is present)
    because a receiver reconstructs concurrency verdicts from the count
    and re-mints the session's shadow bloom row from the ids.
    """
    events = [(int(hi), int(lo)) for hi, lo in meta.get("events", ())]
    n_private = int(meta.get("n_private", len(events)))
    if n_private != len(events):
        raise ValueError(
            f"n_private={n_private} disagrees with {len(events)} event ids")
    body = _EXACT_HDR.pack(_EXACT_MAGIC, WIRE_VERSION, int(meta["k"]),
                           int(meta["v"]), n_private)
    body += b"".join(_EVENT.pack(hi & 0xFFFFFFFFFFFFFFFF,
                                 lo & 0xFFFFFFFFFFFFFFFF)
                     for hi, lo in events)
    return body + _CRC.pack(zlib.crc32(body))


def decode_exact(buf: bytes) -> dict:
    """Decode one exact-row frame; same absolute contract as clock
    frames — truncation, trailing garbage, CRC mismatch, or version skew
    raise :class:`WireFormatError`, never a partially-decoded row."""
    buf = bytes(buf)
    _check_magic_version(buf, _EXACT_MAGIC, "exact")
    if len(buf) < _EXACT_HDR.size:
        raise WireFormatError(
            f"truncated exact frame: {len(buf)} bytes, need "
            f"{_EXACT_HDR.size} for the header")
    _, _, k, v, n_private = _EXACT_HDR.unpack_from(buf)
    expect = _EXACT_HDR.size + n_private * _EVENT.size + _CRC.size
    if len(buf) < expect:
        raise WireFormatError(
            f"truncated exact frame: {len(buf)} bytes, header declares "
            f"n_private={n_private} = {expect}")
    if len(buf) > expect:
        raise WireFormatError(
            f"oversized exact frame: {len(buf)} bytes, header declares "
            f"{expect} — {len(buf) - expect} trailing bytes")
    (crc,) = _CRC.unpack_from(buf, expect - _CRC.size)
    if crc != zlib.crc32(buf[: expect - _CRC.size]):
        raise WireFormatError(
            "corrupted exact frame: CRC32 mismatch over header + events")
    events = tuple(
        _EVENT.unpack_from(buf, _EXACT_HDR.size + i * _EVENT.size)
        for i in range(n_private))
    return {"v": int(v), "n_private": int(n_private), "events": events,
            "k": int(k)}


def exact_frame_nbytes(n_private: int) -> int:
    """Encoded frame size for an exact row with ``n_private`` events."""
    return _EXACT_HDR.size + n_private * _EVENT.size + _CRC.size


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClockDigest:
    """Per-peer anti-entropy summary: enough to decide pull-or-skip."""

    peer_id: str
    clock_sum: float          # Eq. 3 / straggler input
    base: int                 # §4 window offset
    m: int                    # cell count (schema check before a pull)
    k: int
    crc: int                  # cells_crc of the logical cells

    @property
    def key(self) -> tuple:
        """Content identity a delta decision compares against."""
        return (self.crc, self.m)

    @property
    def nbytes(self) -> int:
        return _DIGEST_HDR.size + len(self.peer_id.encode()) + _CRC.size


def digest_of(peer_id: str, cells, base: int = 0, k: int = 4) -> ClockDigest:
    """Digest of one clock's host-side cells (any integer dtype)."""
    cells = np.asarray(cells)
    s = float(np.asarray(cells, np.float64).sum()
              + float(base) * cells.shape[-1])
    return ClockDigest(peer_id=str(peer_id), clock_sum=s, base=int(base),
                       m=int(cells.shape[-1]), k=int(k),
                       crc=cells_crc(cells, base))


def encode_digest(d: ClockDigest) -> bytes:
    pid = d.peer_id.encode()
    if len(pid) > 255:
        raise ValueError(f"peer_id too long for wire ({len(pid)} bytes)")
    body = _DIGEST_HDR.pack(_DIGEST_MAGIC, WIRE_VERSION, d.k, len(pid),
                            d.m, d.clock_sum, _wrap_i32(d.base), d.crc) + pid
    return body + _CRC.pack(zlib.crc32(body))


def decode_digest(buf: bytes) -> ClockDigest:
    """Decode one digest frame; like clock frames, a corrupted digest is
    rejected (CRC trailer over header + peer id) rather than steering a
    wrong pull/skip decision."""
    buf = bytes(buf)
    _check_magic_version(buf, _DIGEST_MAGIC, "digest")
    if len(buf) < _DIGEST_HDR.size:
        raise WireFormatError(
            f"truncated digest frame: {len(buf)} bytes, need "
            f"{_DIGEST_HDR.size} for the header")
    _, _, k, idlen, m, s, base, crc = _DIGEST_HDR.unpack_from(buf)
    expect = _DIGEST_HDR.size + idlen + _CRC.size
    if len(buf) != expect:
        raise WireFormatError(
            f"digest frame length {len(buf)} does not match declared "
            f"peer-id length {idlen} (expected {expect})")
    (frame_crc,) = _CRC.unpack_from(buf, expect - _CRC.size)
    if frame_crc != zlib.crc32(buf[: expect - _CRC.size]):
        raise WireFormatError(
            "corrupted digest frame: CRC32 mismatch over header + peer id")
    try:
        pid = buf[_DIGEST_HDR.size: expect - _CRC.size].decode()
    except UnicodeDecodeError as e:
        raise WireFormatError(f"corrupted digest frame: peer id is not "
                              f"valid utf-8 ({e})") from None
    return ClockDigest(peer_id=pid, clock_sum=s, base=base, m=m, k=k, crc=crc)
