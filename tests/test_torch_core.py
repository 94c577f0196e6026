"""Parity of the port's core (hashing, clock, wire, history, vector
clock) with the JAX package, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages.
Tolerances: hash indices, cells, flags and wire bytes identical; float32
sums identical; Eq. 3 fp within a relative 5e-2 (libm ulps in expm1,
see ROADMAP queue 3); below the Eq. 3 clip floor of 1e-30 all values
count as equal, because XLA flushes float32 subnormals to zero and
torch keeps them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clock as jbc  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.core import history as jhist  # noqa: E402
from repro.core import vector_clock as jvc  # noqa: E402
from repro.core import wire as jwire  # noqa: E402
from repro_torch.core import clock as tbc  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core import history as thist  # noqa: E402
from repro_torch.core import vector_clock as tvc  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402

FP_RTOL = 5e-2
FP_FLOOR = 1e-30
I32_MAX = 2 ** 31 - 1


def as_i32(x) -> np.ndarray:
    """Integers folded onto the int32 circle."""
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def pair(cells, base, k=4):
    cells, base = as_i32(cells), as_i32(base)
    return (jbc.BloomClock(jnp.asarray(cells), jnp.asarray(base), k),
            tbc.BloomClock(torch.as_tensor(cells), torch.as_tensor(base), k))


def npy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_fp_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    tiny = (np.abs(a) <= FP_FLOOR) & (np.abs(b) <= FP_FLOOR)
    np.testing.assert_allclose(np.where(tiny, 0.0, a), np.where(tiny, 0.0, b),
                               rtol=FP_RTOL, atol=0)


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

def _event_ids(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2 ** 32, (2, n), dtype=np.uint64).astype(np.uint32)
    ids[:, :4] = [[0, 0xFFFFFFFF, 0x80000000, 1], [0, 0xFFFFFFFF, 1, 0x80000000]]
    return ids


@pytest.mark.parametrize("m,k", [(64, 3), (1000, 4), (1024, 4), (16384, 7)])
def test_bloom_indices_bit_equal(m, k):
    hi, lo = _event_ids()
    want = np.asarray(jh.bloom_indices(jnp.asarray(hi), jnp.asarray(lo), k, m))
    got = th.bloom_indices(hi, lo, k, m).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("fn", ["splitmix64", "murmur64"])
def test_finalizers_bit_equal(fn):
    hi, lo = _event_ids(seed=1)
    jhi, jlo = getattr(jh, fn)(jnp.asarray(hi), jnp.asarray(lo))
    thi, tlo = getattr(th, fn)(th._lane(hi), th._lane(lo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi).astype(np.int64))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo).astype(np.int64))


def test_stable_event_id_equal():
    for parts in [("run0", "step", 3), (b"\x00\xff", 2 ** 63), ("x",), ()]:
        assert th.stable_event_id(*parts) == jh.stable_event_id(*parts)


# ---------------------------------------------------------------------------
# clock
# ---------------------------------------------------------------------------

def test_int32_add_wraps_in_torch():
    x = torch.tensor([I32_MAX], dtype=torch.int32)
    assert int((x + 1)[0]) == -2 ** 31
    assert int((-x - 2)[0]) == I32_MAX


@pytest.mark.parametrize("events", [1, 5])
def test_tick_batched_equal(events):
    rng = np.random.default_rng(2)
    cells = rng.integers(0, 9, (6, 200))
    cells[0] = I32_MAX           # ticks wrap past INT32_MAX
    j, t = pair(cells, np.zeros(6))
    hi, lo = _event_ids(6 * events, seed=3)
    shape = (6,) if events == 1 else (6, events)
    jt = jbc.tick(j, jnp.asarray(hi.reshape(shape)), jnp.asarray(lo.reshape(shape)))
    tt = tbc.tick(t, hi.reshape(shape).astype(np.int64),
                  lo.reshape(shape).astype(np.int64))
    np.testing.assert_array_equal(npy(tt.cells), np.asarray(jt.cells))


def test_tick_scalar_clock_equal():
    j, t = pair(np.zeros(64), 0, k=3)
    for step in range(20):
        hi, lo = jh.stable_event_id("run", step)
        j = jbc.tick(j, jnp.uint32(hi), jnp.uint32(lo))
        t = tbc.tick(t, hi, lo)
    np.testing.assert_array_equal(npy(t.cells), np.asarray(j.cells))


def _near_wrap_pairs():
    rng = np.random.default_rng(4)
    a = I32_MAX - rng.integers(0, 50, (5, 96))
    b = a + rng.integers(-3, 40, (5, 96))          # some cells wrap negative
    b[1] = a[1]
    b[2] = a[2] + 3
    return a, b


def test_clock_sum_wraps_mod_2_32():
    # the reference sums the uint32 view in uint32: 0xF0000000 +
    # 0x20000000 wraps to 0x10000000 before the float cast
    j, t = pair([[0xF0000000, 0x20000000]], [0])
    assert float(npy(tbc.clock_sum(t))[0]) == float(np.asarray(jbc.clock_sum(j))[0])
    assert float(npy(tbc.clock_sum(t))[0]) == 268435456.0
    a, _ = _near_wrap_pairs()
    for base in (0, 7, -5):
        j, t = pair(a, np.full(5, base))
        np.testing.assert_array_equal(npy(tbc.clock_sum(t)),
                                      np.asarray(jbc.clock_sum(j)))


def test_merge_ordering_near_wrap_equal():
    a, b = _near_wrap_pairs()
    ja, ta = pair(a, np.arange(5))
    jb, tb = pair(b, np.arange(5)[::-1])
    jm, tm = jbc.merge(ja, jb), tbc.merge(ta, tb)
    np.testing.assert_array_equal(npy(tm.cells), np.asarray(jm.cells))
    np.testing.assert_array_equal(npy(tm.base), np.asarray(jm.base))
    jo, to = jbc.ordering(ja, jb), tbc.ordering(ta, tb)
    for f in ("a_le_b", "b_le_a", "concurrent", "equal"):
        np.testing.assert_array_equal(npy(getattr(to, f)), np.asarray(getattr(jo, f)))
    assert_fp_close(npy(to.fp_a_before_b), np.asarray(jo.fp_a_before_b))
    assert_fp_close(npy(to.fp_b_before_a), np.asarray(jo.fp_b_before_a))
    np.testing.assert_array_equal(
        npy(tbc.happened_before(ta, tb, 0.5)),
        np.asarray(jbc.happened_before(ja, jb, 0.5)))


def test_compress_decompress_span_near_wrap_equal():
    a, b = _near_wrap_pairs()
    j, t = pair(b, np.full(5, 11))
    for fn in ("compress", "decompress"):
        jc, tc = getattr(jbc, fn)(j), getattr(tbc, fn)(t)
        np.testing.assert_array_equal(npy(tc.cells), np.asarray(jc.cells))
        np.testing.assert_array_equal(npy(tc.base), np.asarray(jc.base))
    np.testing.assert_array_equal(npy(tbc.residual_span(t)),
                                  np.asarray(jbc.residual_span(j)))


@pytest.mark.parametrize("m", [6, 64, 1024])
def test_fp_rate_within_tolerance(m):
    rng = np.random.default_rng(5)
    sa = rng.uniform(0, 5 * m, 500).astype(np.float32)
    sb = rng.uniform(0, 5 * m, 500).astype(np.float32)
    assert_fp_close(tbc.fp_rate(torch.as_tensor(sa), torch.as_tensor(sb), m).numpy(),
                    np.asarray(jbc.fp_rate(jnp.asarray(sa), jnp.asarray(sb), m)))


@pytest.mark.parametrize("span", [10, 400])
def test_to_wire_from_wire_equal(span):
    rng = np.random.default_rng(6)
    cells = rng.integers(0, span, 128) + 1000
    j, t = pair(cells, 5)
    js, ts = jbc.to_wire(j), tbc.to_wire(t)
    assert js["cells"].dtype == ts["cells"].dtype
    np.testing.assert_array_equal(ts["cells"], js["cells"])
    assert (ts["base"], ts["k"]) == (js["base"], js["k"])
    frame = jwire.encode_clock(js)
    back = tbc.from_wire(frame)
    np.testing.assert_array_equal(npy(back.logical_cells()),
                                  np.asarray(j.logical_cells()))


# ---------------------------------------------------------------------------
# wire frames: byte-identical both ways
# ---------------------------------------------------------------------------

def _snaps():
    rng = np.random.default_rng(7)
    u8 = {"cells": rng.integers(0, 256, 64).astype(np.uint8), "base": 12, "k": 4}
    i32 = {"cells": as_i32(rng.integers(-2 ** 31, 2 ** 31, 33)),
           "base": -7, "k": 3}
    wrapped = {"cells": rng.integers(0, 3, 8).astype(np.uint8),
               "base": 2 ** 32 + 5, "k": 4}
    return [u8, i32, wrapped]


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_clock_frames_byte_identical(idx):
    snap = _snaps()[idx]
    fj, ft = jwire.encode_clock(snap), twire.encode_clock(snap)
    assert fj == ft
    dj, dt = jwire.decode_clock(ft), twire.decode_clock(fj)
    np.testing.assert_array_equal(dt["cells"], dj["cells"])
    assert dt["cells"].dtype == dj["cells"].dtype
    assert (dt["base"], dt["k"]) == (dj["base"], dj["k"])


def test_digest_and_exact_frames_byte_identical():
    rng = np.random.default_rng(8)
    cells = rng.integers(0, 300, 50)
    assert twire.cells_crc(cells, 9) == jwire.cells_crc(cells, 9)
    dj = jwire.digest_of("peer-7", cells, 9, 4)
    dt = twire.digest_of("peer-7", cells, 9, 4)
    assert jwire.encode_digest(dj) == twire.encode_digest(dt)
    assert twire.decode_digest(jwire.encode_digest(dj)) == dt
    meta = {"v": 12, "events": [(1, 2), (2 ** 40, 3)], "k": 4}
    assert twire.encode_exact(meta) == jwire.encode_exact(meta)
    assert twire.decode_exact(jwire.encode_exact(meta)) == jwire.decode_exact(
        twire.encode_exact(meta))


def test_damaged_frames_rejected():
    frame = twire.encode_clock(_snaps()[0])
    for bad in (frame[:-1], frame + b"\x00",
                frame[:20] + bytes([frame[20] ^ 1]) + frame[21:]):
        with pytest.raises(twire.WireFormatError):
            twire.decode_clock(bad)
        with pytest.raises(twire.WireFormatError):
            tbc.from_wire(bad)


# ---------------------------------------------------------------------------
# history and vector clock
# ---------------------------------------------------------------------------

def test_history_equal():
    jh_, th_ = jhist.init(4, 64, 3), thist.init(4, 64, 3)
    j, t = pair(np.zeros(64), 0, k=3)
    snaps = []
    for step in range(6):
        hi, lo = jh.stable_event_id("h", step)
        j = jbc.tick(j, jnp.uint32(hi), jnp.uint32(lo))
        t = tbc.tick(t, hi, lo)
        jh_, th_ = jhist.push(jh_, j), thist.push(th_, t)
        snaps.append((j, t))
    np.testing.assert_array_equal(npy(th_.cells), np.asarray(jh_.cells))
    np.testing.assert_array_equal(npy(th_.sums), np.asarray(jh_.sums))
    assert int(th_.count) == int(jh_.count) == 4
    for jo, to in [snaps[1], snaps[3], pair(np.full(64, 50), 0, k=3)]:
        jfp, jidx = jhist.best_predecessor_fp(jh_, jo)
        tfp, tidx = thist.best_predecessor_fp(th_, to)
        assert int(tidx) == int(jidx)
        if np.isinf(float(jfp)):
            assert np.isinf(float(tfp))
        else:
            assert_fp_close([float(tfp)], [float(jfp)])


def test_vector_clock_equal():
    jv, tv = jvc.zeros(5, (2,)), tvc.zeros(5, (2,))
    for node in ([0, 1], [3, 1], [4, 4]):
        jv = jvc.tick(jv, jnp.asarray(node))
        tv = tvc.tick(tv, node)
    np.testing.assert_array_equal(npy(tv.vec), np.asarray(jv.vec))
    other_j, other_t = jvc.tick(jv, jnp.asarray([2, 2])), tvc.tick(tv, [2, 2])
    jm, tm = jvc.merge(jv, other_j), tvc.merge(tv, other_t)
    np.testing.assert_array_equal(npy(tm.vec), np.asarray(jm.vec))
    jo, to = jvc.compare(jv, other_j), tvc.compare(tv, other_t)
    for f in ("a_le_b", "b_le_a", "concurrent", "equal"):
        np.testing.assert_array_equal(npy(getattr(to, f)), np.asarray(getattr(jo, f)))
