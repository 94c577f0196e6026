"""The all-pairs slice of the port against the JAX package on the CPU:
the plain versions of the tri, rect-u8, rect-i32-stats and mxu kernels
against the Pallas kernels (interpret mode), ``CausalEngine.pairs`` on
every dispatch path, ``ClockRegistry.all_pairs`` on a registry carried
across by ``convert``, and ``fleet_health`` / ``fork_components`` /
``watch``.

Tolerances: flags, integers, violation counts, component labels and
float32 sums identical (the JAX side pins blocks with
``CausalPolicy(bm=512, autotune=False)``); Eq. 3 fp within a relative
5e-2, values at or below the 1e-30 clip floor counted as equal and
infinities (wrapped negative sums) equal to themselves; an fp histogram
bin may differ only for a pair whose fp lies within that tolerance of a
bin edge.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import causal as jcausal  # noqa: E402
from repro.core import clock as jbc  # noqa: E402
from repro.fleet import monitor as jmon  # noqa: E402
from repro.fleet import registry as jreg_mod  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.generate import bloom_matrix_mxu_pallas  # noqa: E402
from repro.obs import MetricsRecorder as JMetrics  # noqa: E402
from repro.obs import Observer as JObserver  # noqa: E402
from repro_torch import causal as tcausal  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import clock as tbc  # noqa: E402
from repro_torch.fleet import monitor as tmon  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.obs import MetricsRecorder as TMetrics  # noqa: E402
from repro_torch.obs import Observer as TObserver  # noqa: E402
from repro_torch.obs import Tracer as TTracer  # noqa: E402

M, K, CAP = 128, 4, 48
FP_RTOL = 5e-2
FP_FLOOR = 1e-30
I32_MAX = 2 ** 31 - 1
CPU = "cpu"


def as_i32(x) -> np.ndarray:
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_fp_close(a, b):
    a, b = host(a).astype(np.float64), host(b).astype(np.float64)
    assert a.shape == b.shape
    keep = ~((a == b) | ((np.abs(a) <= FP_FLOOR) & (np.abs(b) <= FP_FLOOR)))
    np.testing.assert_allclose(a[keep], b[keep], rtol=FP_RTOL, atol=0)


def assert_matrix_equal(t, j):
    """A port ``ComparisonMatrix`` against a JAX one (or its dict)."""
    for key in ("a_le_b", "b_le_a", "concurrent", "row_sums", "col_sums"):
        np.testing.assert_array_equal(host(t[key]), np.asarray(j[key]),
                                      err_msg=key)
    assert_fp_close(t["fp"], j["fp"])


def jpolicy(**kw):
    return jcausal.CausalPolicy(bm=512, bn=8, autotune=False, **kw)


def tpolicy(**kw):
    return tcausal.CausalPolicy(bm=512, bn=8, **kw)


def slab_rows(n, m, seed, *, span=40, base_choices=(1000,)):
    """u8 residuals [n, m] and bases [n]: ancestors, descendants, equal,
    forked and unrelated rows around one window, bases drawn from
    ``base_choices``."""
    g = np.random.default_rng(seed)
    local = g.integers(1, span - 2, m)
    kind = np.arange(n) % 5
    up = (g.random((n, m)) < 0.05).astype(np.int64)
    down = (g.random((n, m)) < 0.05).astype(np.int64)
    rows = np.repeat(local[None], n, axis=0)
    rows[kind == 0] -= down[kind == 0]
    rows[kind == 1] += up[kind == 1]
    rows[kind == 3] += up[kind == 3] - down[kind == 3]
    rows[kind == 4] = g.integers(0, span, ((kind == 4).sum(), m))
    base = g.choice(np.asarray(base_choices, np.int64), n)
    return rows.astype(np.uint8), as_i32(base)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------

_BASES = {
    "uniform": (1000,),
    "near": (1000, 1003, 1010),             # |delta| <= 256, span <= 64
    "far": (-2 ** 31, -70000, 1000, 1300, 5000, I32_MAX - 100),
}


@pytest.mark.parametrize("n,m,bases", [(13, 200, "far"), (24, 128, "near"),
                                       (9, 70, "uniform"), (40, 256, "far")])
def test_tri_plain_matches_pallas(n, m, bases):
    cells, base = slab_rows(n, m, 1, base_choices=_BASES[bases])
    uniform = bases == "uniform"
    want = jops._compare_matrix_packed(
        jnp.asarray(cells), jnp.asarray(base), engine="tri", bi=8, bj=8,
        bm=128, uniform_base=uniform, use_autotune=False)
    le, ge = tops.tri_flags(torch.as_tensor(cells), torch.as_tensor(base),
                            with_base=not uniform)
    np.testing.assert_array_equal(le.numpy(), np.asarray(want["a_le_b"]))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(want["b_le_a"]))
    assert le.dtype == torch.bool


def test_tri_departs_from_pallas_only_at_a_2_31_base_gap():
    """A known departure: where two bases are exactly 2^31 apart the
    clipped wrap delta is -256 both ways, so a mirrored flag differs from
    a computed one.  The reference computes its diagonal blocks whole;
    the port computes pairs i <= j and mirrors i > j at any tile size.
    The two agree on every other pair."""
    n, m = 8, 64
    cells, _ = slab_rows(n, m, 16)
    base = as_i32(np.where(np.arange(n) % 2, -2 ** 31, 0))
    want = jops._compare_matrix_packed(
        jnp.asarray(cells), jnp.asarray(base), engine="tri", bi=8, bj=8,
        bm=128, uniform_base=False, use_autotune=False)
    le, ge = tops.tri_flags(torch.as_tensor(cells), torch.as_tensor(base))
    j_le, j_ge = np.asarray(want["a_le_b"]), np.asarray(want["b_le_a"])
    i, j = np.indices((n, n))
    apart = (base[:, None].astype(np.int64) - base[None, :]) % 2 ** 32 == 2 ** 31
    mirrored = apart & (i > j)
    np.testing.assert_array_equal(le.numpy()[~mirrored], j_le[~mirrored])
    np.testing.assert_array_equal(ge.numpy()[~mirrored], j_ge[~mirrored])
    np.testing.assert_array_equal(le.numpy()[mirrored], j_ge.T[mirrored])
    np.testing.assert_array_equal(ge.numpy()[mirrored], j_le.T[mirrored])
    assert j_le[mirrored].all() and not j_ge[mirrored].any()
    assert not le.numpy()[mirrored].any() and ge.numpy()[mirrored].all()


@pytest.mark.parametrize("n,mc,m,bases", [(13, 21, 200, "far"),
                                          (8, 8, 128, "uniform"),
                                          (20, 9, 70, "near"),
                                          (17, 33, 300, "far")])
def test_rect_u8_plain_matches_pallas(n, mc, m, bases):
    rows, rb = slab_rows(n, m, 2, base_choices=_BASES[bases])
    cols, cb = slab_rows(mc, m, 2, base_choices=_BASES[bases])
    cols[: mc // 2] = rows[: mc // 2] if mc // 2 <= n else cols[: mc // 2]
    with_base = bases != "uniform"
    le_j, ge_j = jops._full_rect_flags(
        jnp.asarray(rows), jnp.asarray(rb), jnp.asarray(cols), jnp.asarray(cb),
        8, 8, 128, m, with_base, True)
    le, ge = tops.rect_u8_flags(torch.as_tensor(rows), torch.as_tensor(cols),
                                torch.as_tensor(rb), torch.as_tensor(cb),
                                with_base=with_base)
    np.testing.assert_array_equal(le.numpy(), np.asarray(le_j).astype(bool))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(ge_j).astype(bool))


def _i32_rows(n, m, seed, near_wrap):
    g = np.random.default_rng(seed)
    q = g.integers(100, 400, m)
    if near_wrap:
        q = I32_MAX - g.integers(0, 60, m)
    rows = q + g.integers(-2, 3, (n, 1)) + g.integers(-1, 2, (n, m)) * (
        g.random((n, m)) < 0.05)
    rows[: n // 4] = q
    rows[n // 4] += 1000                                  # span beyond a byte
    return as_i32(rows)


@pytest.mark.parametrize("n,mc,m,near_wrap", [(16, 16, 128, False),
                                              (13, 21, 200, True),
                                              (9, 5, 1000, True),
                                              (24, 12, 640, False)])
def test_rect_i32_stats_plain_matches_pallas(n, mc, m, near_wrap):
    rows = _i32_rows(n, m, 3, near_wrap)
    cols = _i32_rows(mc, m, 4, near_wrap)
    cols[0] = rows[0]
    want = jops._compare_matrix(jnp.asarray(rows), jnp.asarray(cols),
                                engine="i32", bi=8, bj=8, bm=128,
                                use_autotune=False)
    got = tops._compare_matrix(torch.as_tensor(rows), torch.as_tensor(cols),
                               engine="i32", bm=128)
    assert_matrix_equal(got, want)
    assert tops.LAST_DISPATCH["engine"] == "i32"
    if near_wrap:          # wrapped tile sums: negative float sums, inf fp
        assert (got["row_sums"] < 0).any()


@pytest.mark.parametrize("n,mc,m,T,lo", [(13, 21, 200, 8, -5),
                                         (16, 8, 128, 64, 0),
                                         (10, 7, 300, 16, 123456),
                                         (9, 12, 70, 32, -2 ** 31)])
def test_mxu_plain_matches_pallas(n, mc, m, T, lo):
    g = np.random.default_rng(5)
    rows = g.integers(0, T - 3, (n, m)).astype(np.uint8)
    cols = g.integers(0, T - 3, (mc, m)).astype(np.uint8)
    cols[0] = rows[0]
    rb = as_i32(lo + g.integers(0, 3, n))
    cb = as_i32(lo + g.integers(0, 3, mc))
    rows_p, bi, bm = jops.tile2d(jnp.asarray(rows), 8, 128)
    cols_p, bj, _ = jops.tile2d(jnp.asarray(cols), 8, bm)
    cols_p = jops.pad_to(cols_p, rows_p.shape[1], axis=1)
    want = bloom_matrix_mxu_pallas(
        rows_p, cols_p, jops._pad_base(rb, rows_p.shape[0]),
        jops._pad_base(cb, cols_p.shape[0]), n_thresholds=T, lo=lo, bi=bi,
        bj=bj, bm=bm, m_true=m, interpret=True)[:n, :mc]
    got = tops.mxu_viol(torch.as_tensor(rows), torch.as_tensor(cols),
                        torch.as_tensor(rb), torch.as_tensor(cb), lo=lo,
                        n_thresholds=T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32 and (got.numpy() > 0).any()


def _s16x2_viol(rows, cols, rb, cb, lo, T):
    """numpy emulation of the mxu kernel's packed arithmetic
    (``csrc/bloom_mxu.cu``): the per-row offset d = base - lo cut to
    [-257, T + 1] (or moved to the top of 16 bits where u8 + d wraps in
    int32), 16-bit lanes u8 + d clamped to [-1, T] for rows and to
    [0, T + 1] then negated for cols, zero in padded lanes, two lanes a
    uint32 word, one add-relu of a + (-b) with 0 per word; of every 8
    words, the first two go into one packed count by a wrapping 32-bit
    add and the other six into a 32-bit count (their two halves each);
    the packed count's halves go into the 32-bit count every
    floor(65535 / (8 T)) chunks of 64 lanes."""
    words, lanes = 32, 64

    def offsets(base):
        d = as_i32(base.astype(np.int64) - lo).astype(np.int64)
        top = d > I32_MAX - 256
        return np.where(top, d - I32_MAX + 32767, np.clip(d, -257, T + 1))

    def stage(u8, d, lo_c, hi_c, neg):
        n, m = u8.shape
        pad = -m % lanes
        v = (u8.astype(np.int64) + d[:, None]) & 0xFFFF           # __vadd2
        v = v.astype(np.uint16).view(np.int16).astype(np.int64)
        v = np.clip(v, lo_c, hi_c)                                # vmaxs2/vmins2
        v = -v if neg else v
        v = np.pad(v, ((0, 0), (0, pad)))                         # padded: 0
        h = (v & 0xFFFF).astype(np.uint32)
        return h[:, 0::2] | (h[:, 1::2] << np.uint32(16))         # [n, words]

    def add_relu(a, nb):                                          # viaddmax
        out = np.zeros(np.broadcast_shapes(a.shape, nb.shape), np.uint32)
        for shift in (0, 16):
            ha = ((a >> np.uint32(shift)) & np.uint32(0xFFFF)).astype(np.uint16)
            hb = ((nb >> np.uint32(shift)) & np.uint32(0xFFFF)).astype(np.uint16)
            s = ha.view(np.int16).astype(np.int64) + hb.view(np.int16).astype(np.int64)
            assert (s >= -32768).all() and (s <= 32767).all()
            out |= (np.maximum(s, 0).astype(np.uint32) << np.uint32(shift))
        return out

    A = stage(rows, offsets(rb), -1, T, False)[:, None, :]
    NB = stage(cols, offsets(cb), 0, T + 1, True)[None, :, :]
    flush_every = 65535 // (8 * T)
    acc = np.zeros((rows.shape[0], cols.shape[0]), np.uint32)
    total = np.zeros_like(acc, dtype=np.int64)
    n_chunks = A.shape[2] // words
    for chunk in range(n_chunks):
        for w in range(chunk * words, (chunk + 1) * words, 8):
            r = [add_relu(A[:, :, w + k], NB[:, :, w + k]) for k in range(8)]
            acc = acc + r[0] + r[1]                                # IADD3, wraps
            for x in r[2:]:                                        # IDP
                total += (x & np.uint32(0xFFFF)).astype(np.int64) + (x >> np.uint32(16))
        if (chunk + 1) % flush_every == 0 or chunk + 1 == n_chunks:
            total += (acc & np.uint32(0xFFFF)).astype(np.int64) + (acc >> np.uint32(16))
            acc[:] = 0
    return total.astype(np.float32)


def _adversarial_mxu(g, n, mc, m, T, lo):
    """Rows and cols [.., m] u8 with int32 bases around ``lo``: half the
    rows in the window, the rest at bases far below it, far above it, at
    the edges of the [-257, T + 1] offset cut, and where u8 + base - lo
    wraps in int32; the first rows of cols equal those of rows."""
    edge = np.array([-2 ** 30, -300, -258, -257, -256, -2, T + 1, T + 2, 300,
                     2 ** 30], np.int64)
    top = I32_MAX - np.array([0, 1, 100, 200, 254, 255, 256], np.int64)

    def side(n):
        res = g.integers(0, T - 3, (n, m))
        res[1::2] = g.integers(0, 256, (len(res[1::2]), m))
        off = g.integers(0, 3, n).astype(np.int64)
        far = g.random(n) < 0.5
        off[far] = g.choice(np.concatenate([edge, top]), int(far.sum()))
        return res.astype(np.uint8), as_i32(lo + off)

    rows, rb = side(n)
    cols, cb = side(mc)
    k = min(n, mc) // 3
    cols[:k], cb[:k] = rows[:k], rb[:k]
    return rows, cols, rb, cb


@pytest.mark.parametrize("n,mc,m,T,lo", [(9, 12, 2, 8, -5),
                                         (13, 7, 130, 16, 123456),
                                         (6, 10, 1001, 32, I32_MAX - 20),
                                         (8, 5, 640, 64, -2 ** 31),
                                         (7, 9, 256, 64, I32_MAX),
                                         (4, 6, 8192, 64, 77)])
def test_mxu_packed_s16x2_arithmetic_matches_plain_and_pallas(n, mc, m, T, lo):
    """The kernel's 16-bit-lane staging and accumulation, emulated in
    numpy, gives ``ref.mxu_viol_ref``'s counts, and so the Pallas
    kernel's, at ragged m, near-wrap ``lo``, bases far outside the window
    on both sides and identical rows (viol 0)."""
    g = np.random.default_rng(m + T)
    rows, cols, rb, cb = _adversarial_mxu(g, n, mc, m, T, lo)
    want = tops.mxu_viol(torch.as_tensor(rows), torch.as_tensor(cols),
                         torch.as_tensor(rb), torch.as_tensor(cb), lo=lo,
                         n_thresholds=T).numpy()
    np.testing.assert_array_equal(_s16x2_viol(rows, cols, rb, cb, lo, T), want)
    k = min(n, mc) // 3
    assert (np.diag(want[:k, :k]) == 0).all() and (want > 0).any()
    if m <= 1024:
        rows_p, bi, bm = jops.tile2d(jnp.asarray(rows), 8, 128)
        cols_p, bj, _ = jops.tile2d(jnp.asarray(cols), 8, bm)
        cols_p = jops.pad_to(cols_p, rows_p.shape[1], axis=1)
        pallas = bloom_matrix_mxu_pallas(
            rows_p, cols_p, jops._pad_base(rb, rows_p.shape[0]),
            jops._pad_base(cb, cols_p.shape[0]), n_thresholds=T, lo=lo,
            bi=bi, bj=bj, bm=bm, m_true=m, interpret=True)[:n, :mc]
        np.testing.assert_array_equal(want, np.asarray(pallas))


def test_mxu_packed_s16x2_flush_keeps_counts_above_16_bits():
    """Every lane at the largest count (a = T, b = 0) over 8192 lanes at
    T = 64: each packed 16-bit half gains 8 T a chunk, so the flush every
    floor(65535 / 512) = 127 of the 128 chunks is what keeps the 524,288
    exact."""
    m, T, lo = 8192, 64, 1000
    rows = np.full((3, m), 200, np.uint8)
    cols = np.zeros((4, m), np.uint8)
    rb = as_i32(np.full(3, lo))
    cb = as_i32(np.full(4, lo - 5))
    got = _s16x2_viol(rows, cols, rb, cb, lo, T)
    assert (got == m * T).all() and m * T > 65535
    np.testing.assert_array_equal(
        got, tops.mxu_viol(torch.as_tensor(rows), torch.as_tensor(cols),
                           torch.as_tensor(rb), torch.as_tensor(cb), lo=lo,
                           n_thresholds=T).numpy())


def _u16x2_flags(rows, cols, rb=None, cb=None, *, pad_last=True):
    """numpy emulation of the rect-u8 kernel's packed arithmetic
    (``csrc/bloom_matrix.cu``): lanes past m filled with lane m - 1 (or
    0 with ``pad_last=False``) up to a whole 64-lane chunk, two lanes a
    uint32 word, rows as a | a' << 16 and cols as (256 - b) | (256 - b')
    << 16, one 32-bit add a word giving d + 256 in both halves, running
    max and min by three-input u16x2 max/min over two words from 0 and
    0xFFFFFFFF; max(d) is the larger half less 256, min(d) the smaller,
    plus the clipped wrap delta of the bases."""
    lanes = 64

    def stage(u8, neg):
        n, m = u8.shape
        fill = u8[:, -1:] if pad_last else np.zeros((n, 1), np.uint8)
        v = np.concatenate([u8, np.repeat(fill, -m % lanes, 1)], 1)
        v = v.astype(np.uint32)
        v = np.uint32(256) - v if neg else v
        return v[:, 0::2] | (v[:, 1::2] << np.uint32(16))         # [n, words]

    def halves(x):
        return x & np.uint32(0xFFFF), x >> np.uint32(16)

    def fold3(op, x, y, z):                                       # vimax3/vimin3
        out = [op(op(a, b), c) for a, b, c in zip(halves(x), halves(y), halves(z))]
        return out[0] | (out[1] << np.uint32(16))

    A = stage(rows, False)[:, None, :]
    NB = stage(cols, True)[None, :, :]
    S = A + NB                                                    # wrapping add
    lo16, hi16 = halves(S)
    assert (lo16 >= 1).all() and (lo16 <= 511).all()              # no carry
    assert (hi16 >= 1).all() and (hi16 <= 511).all()
    shape = (rows.shape[0], cols.shape[0])
    hi = np.zeros(shape, np.uint32)
    lo = np.full(shape, 0xFFFFFFFF, np.uint32)
    for w in range(0, S.shape[2], 2):
        hi = fold3(np.maximum, hi, S[:, :, w], S[:, :, w + 1])
        lo = fold3(np.minimum, lo, S[:, :, w], S[:, :, w + 1])
    dmax = np.maximum(*halves(hi)).astype(np.int64) - 256
    dmin = np.minimum(*halves(lo)).astype(np.int64) - 256
    delta = 0
    if rb is not None:
        gap = (rb.astype(np.int64)[:, None] - cb.astype(np.int64)[None, :]) % 2 ** 32
        delta = np.clip(np.where(gap >= 2 ** 31, gap - 2 ** 32, gap), -256, 256)
    return dmax + delta <= 0, dmin + delta >= 0


def _u16x2_case(case, m, g):
    """Rows [11, m] and cols [9, m] u8 with int32 bases: "d255" puts
    rows at 255 against cols at 0 and the reverse (d = +-255 in every
    lane), "delta256" bases 256 and 257 apart either way around a window
    row, "wrap" bases 2^31 apart (and 2^31 - 1); the first rows of cols
    equal rows', the rest one lane off either way."""
    local = g.integers(0, 256, m)
    rows = np.repeat(local[None], 11, axis=0)
    cols = np.repeat(local[None], 9, axis=0)
    for x, k in ((rows, 11), (cols, 9)):
        lane = g.integers(0, m, k)
        step = g.choice([-1, 1], k)
        x[np.arange(k), lane] = np.clip(x[np.arange(k), lane] + step, 0, 255)
    cols[:3] = rows[:3]
    rb = np.full(11, 5000, np.int64)
    cb = np.full(9, 5000, np.int64)
    if case == "d255":
        rows[::2], cols[1::2] = 255, 255
        rows[1::2], cols[::2] = 0, 0
    elif case == "delta256":
        rb[4:8] += np.array([256, -256, 257, -257])
        cb[4:7] += np.array([256, -256, 1])
    elif case == "wrap":
        rb[4:8] = np.array([-2 ** 31, 2 ** 31 - 1, -2 ** 31 + 5000, 0])
        cb[5:8] = np.array([5000 + 2 ** 31, -2 ** 31, 2 ** 31 - 1])
    return rows.astype(np.uint8), cols.astype(np.uint8), as_i32(rb), as_i32(cb)


@pytest.mark.parametrize("with_base", [True, False])
@pytest.mark.parametrize("case", ["d255", "delta256", "wrap"])
@pytest.mark.parametrize("m", [1, 2, 3, 63, 65, 1001])
def test_rect_u8_u16x2_arithmetic_matches_plain_and_pallas(m, case, with_base):
    """The rect-u8 kernel's biased 16-bit-lane arithmetic, emulated in
    numpy, gives ``ref.rect_u8_flags_ref``'s flags, and so the Pallas
    rect kernel's, at d = +-255, base deltas at and past the +-256 clip,
    bases 2^31 apart, odd and ragged m."""
    g = np.random.default_rng(m * 7 + len(case))
    rows, cols, rb, cb = _u16x2_case(case, m, g)
    bases = (rb, cb) if with_base else ()
    got = _u16x2_flags(rows, cols, *bases)
    le, ge = tops.rect_u8_flags(torch.as_tensor(rows), torch.as_tensor(cols),
                                torch.as_tensor(rb), torch.as_tensor(cb),
                                with_base=with_base)
    np.testing.assert_array_equal(got[0], le.numpy())
    np.testing.assert_array_equal(got[1], ge.numpy())
    assert got[0].any() and not got[0].all()
    le_j, ge_j = jops._full_rect_flags(
        jnp.asarray(rows), jnp.asarray(rb), jnp.asarray(cols), jnp.asarray(cb),
        8, 8, 128, m, with_base, True)
    np.testing.assert_array_equal(le.numpy(), np.asarray(le_j).astype(bool))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(ge_j).astype(bool))


def test_rect_u8_u16x2_zero_padding_would_flip_flags():
    """Why pad lanes repeat lane m - 1: with a base delta, a zero pad
    lane (d = 0) is not neutral.  Rows 3 above cols in every lane with
    bases 3 apart the other way make every d + delta = 0, both flags
    true; a zero pad lane would add d + delta = -3 and clear ge."""
    rows = np.full((2, 3), 10, np.uint8)
    cols = np.full((2, 3), 7, np.uint8)
    rb, cb = as_i32(np.full(2, 100)), as_i32(np.full(2, 103))
    le, ge = tops.rect_u8_flags(torch.as_tensor(rows), torch.as_tensor(cols),
                                torch.as_tensor(rb), torch.as_tensor(cb))
    assert le.numpy().all() and ge.numpy().all()
    got = _u16x2_flags(rows, cols, rb, cb)
    assert got[0].all() and got[1].all()
    zero = _u16x2_flags(rows, cols, rb, cb, pad_last=False)
    assert zero[0].all() and not zero[1].any()


def _u16x2_tri_flags(cells, base=None):
    """numpy emulation of tri on the rect-u8 body (``rect_u8_u16x2_kernel``
    with TRI): ``_u16x2_flags`` of the slab against itself, taken on
    pairs i <= j and mirrored for i > j, le(i, j) = ge(j, i)."""
    bases = (base, base) if base is not None else ()
    le, ge = _u16x2_flags(cells, cells, *bases)
    upper = np.triu(np.ones(le.shape, bool))
    return np.where(upper, le, ge.T), np.where(upper, ge, le.T)


@pytest.mark.parametrize("with_base", [True, False])
@pytest.mark.parametrize("case", ["d255", "delta256", "wrap"])
@pytest.mark.parametrize("m", [1, 3, 63, 65, 1001])
def test_tri_u16x2_arithmetic_matches_plain_and_pallas(m, case, with_base):
    """tri on rect-u8's biased 16-bit lanes, emulated in numpy, gives
    ``ref.tri_flags_ref``'s flags at d = +-255, base deltas at and past
    the +-256 clip, bases 2^31 apart, odd and ragged m; and the Pallas
    tri kernel's on every pair whose bases are not 2^31 apart (the kept
    departure, ``test_tri_departs_from_pallas_only_at_a_2_31_base_gap``)."""
    g = np.random.default_rng(m * 11 + len(case))
    rows, cols, rb, cb = _u16x2_case(case, m, g)
    cells, base = np.concatenate([rows, cols]), np.concatenate([rb, cb])
    got = _u16x2_tri_flags(cells, base if with_base else None)
    le, ge = tops.tri_flags(torch.as_tensor(cells), torch.as_tensor(base),
                            with_base=with_base)
    np.testing.assert_array_equal(got[0], le.numpy())
    np.testing.assert_array_equal(got[1], ge.numpy())
    assert got[0].any() and not got[0].all()
    want = jops._compare_matrix_packed(
        jnp.asarray(cells), jnp.asarray(base), engine="tri", bi=8, bj=8,
        bm=128, uniform_base=not with_base, use_autotune=False)
    gap = (base[:, None].astype(np.int64) - base[None, :]) % 2 ** 32 == 2 ** 31
    away = ~gap if with_base else np.ones_like(gap)
    assert case != "wrap" or not with_base or gap.any()
    np.testing.assert_array_equal(le.numpy()[away], np.asarray(want["a_le_b"])[away])
    np.testing.assert_array_equal(ge.numpy()[away], np.asarray(want["b_le_a"])[away])


def _prepass_row_sums(rows, bm):
    """numpy emulation of the rect-i32 row-sum pre-pass: per bm-wide
    m-tile, each of 32 lanes sums every 32nd cell as uint32 (wrapping),
    a butterfly adds the lanes, the tile's int32 becomes float32 and is
    added to a float32 sum from 0 in tile order."""
    n, m = rows.shape
    u = rows.view(np.uint32)
    acc = np.zeros(n, np.float32)
    for t0 in range(0, m, bm):
        tile = u[:, t0:min(t0 + bm, m)]
        lanes = [tile[:, k::32].sum(1, dtype=np.uint64) & 0xFFFFFFFF
                 for k in range(32)]
        s = np.zeros(n, np.uint64)
        for x in lanes:
            s = (s + x) & 0xFFFFFFFF
        acc = (acc + s.astype(np.uint32).view(np.int32).astype(np.float32)
               ).astype(np.float32)
    return acc


@pytest.mark.parametrize("n,m,bm,kind", [(9, 1024, 512, "big"),
                                         (7, 1000, 128, "big"),
                                         (12, 1001, 512, "wrap"),
                                         (5, 640, 128, "wrap"),
                                         (6, 3, 128, "big")])
def test_rect_i32_prepass_row_sums_match_plain_and_pallas(n, m, bm, kind):
    """The pre-pass's sum order, emulated in numpy, gives
    ``ref.tile_sums`` bit for bit, and so the Pallas kernel's row sums,
    at sums above 2^24 (float32 rounding in the tile adds) and at tiles
    whose int32 sums wrap."""
    g = np.random.default_rng(m + n)
    if kind == "big":
        rows = 40_000 + g.integers(-3, 4, (n, m)) * g.integers(1, 999, (n, 1))
    else:
        rows = I32_MAX - g.integers(0, 2 ** 20, (n, m))
        rows[::2] = g.integers(-2 ** 31, -2 ** 31 + 2 ** 20, (len(rows[::2]), m))
    rows = as_i32(rows)
    bm_eff = tops.tile_width(m, bm)
    got = _prepass_row_sums(rows, bm_eff)
    want = tref.tile_sums(torch.as_tensor(rows), bm_eff).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if kind == "big" and m >= bm_eff:
        assert (np.abs(got) > 2 ** 24).all()
        exact = rows.astype(np.int64).sum(1).astype(np.float64)
        assert (got.astype(np.float64) != exact).any()        # rounding shows
    cols = rows[: max(1, n // 2)].copy()
    pallas = jops._compare_matrix(jnp.asarray(rows), jnp.asarray(cols),
                                  engine="i32", bi=8, bj=8, bm=bm,
                                  use_autotune=False)
    np.testing.assert_array_equal(np.asarray(pallas["row_sums"]).view(np.uint32),
                                  got.view(np.uint32))


def _mxu_pallas(rows, cols, rb, cb, lo, T):
    rows_p, bi, bm = jops.tile2d(jnp.asarray(rows), 8, 128)
    cols_p, bj, _ = jops.tile2d(jnp.asarray(cols), 8, bm)
    cols_p = jops.pad_to(cols_p, rows_p.shape[1], axis=1)
    return np.asarray(bloom_matrix_mxu_pallas(
        rows_p, cols_p, jops._pad_base(rb, rows_p.shape[0]),
        jops._pad_base(cb, cols_p.shape[0]), n_thresholds=T, lo=lo, bi=bi,
        bj=bj, bm=bm, m_true=rows.shape[1], interpret=True))[:len(rows), :len(cols)]


@pytest.mark.parametrize("T", [8192, 16383])
def test_mxu_plain_matches_pallas_above_16_bit_lanes(T):
    """Past the packed kernel's MXU_T_MAX (8,191) the reference still
    computes (m * T < 2^24): the plain version gives the Pallas mxu's
    counts there, zero and non-zero, with values spread over the window
    and bases far outside it."""
    n, mc, m, lo = 5, 6, 64, -77
    g = np.random.default_rng(T)
    rows = g.integers(0, 256, (n, m)).astype(np.uint8)
    cols = g.integers(0, 256, (mc, m)).astype(np.uint8)
    cols[0] = rows[0]
    rb = as_i32(lo + np.array([0, T - 300, T // 2, -5000, T + 900]))
    cb = as_i32(lo + np.array([0, 0, T - 255, T // 2 + 100, 2 ** 30, -300]))
    assert T > tops.MXU_T_MAX and m * T < 2 ** 24
    got = tops.mxu_viol(torch.as_tensor(rows), torch.as_tensor(cols),
                        torch.as_tensor(rb), torch.as_tensor(cb), lo=lo,
                        n_thresholds=T).numpy()
    np.testing.assert_array_equal(got, _mxu_pallas(rows, cols, rb, cb, lo, T))
    assert (got == 0).any() and (got > 0).any() and got.max() > 255 * m


def test_mxu_plain_matches_brute_force_at_wide_T():
    """At T = 40,000 (m = 8) the plain version is sum_m relu(min(a, T) -
    max(b, 0)) on a = u8 + (base - lo) in int32 wrap, with bases far
    outside the window and where u8 + base - lo wraps past INT32_MAX."""
    T, m, lo = 40_000, 8, 1000
    g = np.random.default_rng(4)
    rows = g.integers(0, 256, (9, m)).astype(np.uint8)
    cols = g.integers(0, 256, (7, m)).astype(np.uint8)
    cols[0] = rows[0]
    off_r = np.array([0, 39_900, 20_000, -70_000, 45_000, I32_MAX - 100,
                      I32_MAX, -2 ** 31, 10])
    off_c = np.array([0, 5, 39_800, I32_MAX - 3, -2 ** 31, 60_000, -1])
    rb, cb = as_i32(lo + off_r), as_i32(lo + off_c)

    def window(u8, base):
        v = u8.astype(np.int64) + (base.astype(np.int64) - lo)[:, None]
        return as_i32(v).astype(np.int64)                 # int32 wrap

    a = np.minimum(window(rows, rb), T)
    b = np.maximum(window(cols, cb), 0)
    want = np.maximum(a[:, None, :] - b[None, :, :], 0).sum(-1)
    wrapped = window(rows, rb) < 0
    assert wrapped[5:7].any()                             # past INT32_MAX
    got = tops.mxu_viol(torch.as_tensor(rows), torch.as_tensor(cols),
                        torch.as_tensor(rb), torch.as_tensor(cb), lo=lo,
                        n_thresholds=T).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert (got == 0).any() and got.max() > 2 ** 16


def test_mxu_refuses_inexact_float_counts():
    cells = torch.zeros((2, 2 ** 18), dtype=torch.uint8)
    base = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^24"):
        tops.mxu_viol(cells, cells, base, base, lo=0, n_thresholds=64)


@pytest.mark.parametrize("engine", ["tri", "full", "mxu"])
def test_compare_matrix_packed_engines_match(engine):
    cells, base = slab_rows(30, 200, 6, base_choices=(1000, 1010, 1020))
    kw = dict(engine=engine, bm=512, uniform_base=False)
    want = jops._compare_matrix_packed(jnp.asarray(cells), jnp.asarray(base),
                                       use_autotune=False, **kw)
    got = tops._compare_matrix_packed(torch.as_tensor(cells),
                                      torch.as_tensor(base), **kw)
    assert_matrix_equal(got, want)
    assert tops.LAST_DISPATCH["engine"] == engine


# ---------------------------------------------------------------------------
# CausalEngine.pairs against the reference
# ---------------------------------------------------------------------------

def _slab(cells, base, wide=None, with_host=True):
    jslab = jcausal.PackedSlab(jnp.asarray(cells), jnp.asarray(base),
                               base_host=np.asarray(base, np.int64)
                               if with_host else None, wide=wide or {})
    tslab = tcausal.PackedSlab(torch.as_tensor(cells), torch.as_tensor(base),
                               base_host=np.asarray(base, np.int64)
                               if with_host else None, wide=wide or {})
    return jslab, tslab


@pytest.mark.parametrize("engine", [None, "tri", "full", "mxu", "i32"])
@pytest.mark.parametrize("bases", ["uniform", "near"])
def test_pairs_packed_slab_engines(engine, bases):
    cells, base = slab_rows(40, M, 7, base_choices=_BASES[bases])
    jslab, tslab = _slab(cells, base)
    jres = jcausal.CausalEngine(jpolicy(engine=engine)).pairs(jslab)
    tres = tcausal.CausalEngine(tpolicy(engine=engine)).pairs(tslab)
    assert_matrix_equal(tres, jres)
    assert tres.engine == jres.engine


def test_pairs_asked_for_mxu_on_a_wide_span_takes_tri():
    """An asked-for mxu engine over a logical span above 64 takes no
    other engine in either package: both raise ``MXU_SPAN_MAX``.  Left
    to itself (no engine asked for), the same slab takes tri in both."""
    cells, base = slab_rows(20, M, 8, span=200)
    jslab, tslab = _slab(cells, base)
    with pytest.raises(ValueError, match="MXU_SPAN_MAX"):
        jcausal.CausalEngine(jpolicy(engine="mxu")).pairs(jslab)
    with pytest.raises(ValueError, match="MXU_SPAN_MAX"):
        tcausal.CausalEngine(tpolicy(engine="mxu")).pairs(tslab)
    with pytest.raises(ValueError, match="MXU_SPAN_MAX"):
        tops._compare_matrix_packed(torch.as_tensor(cells),
                                    torch.as_tensor(base), engine="mxu")
    jres = jcausal.CausalEngine(jpolicy()).pairs(jslab)
    tres = tcausal.CausalEngine(tpolicy()).pairs(tslab)
    assert tres.engine == jres.engine == "tri"
    assert_matrix_equal(tres, jres)


@pytest.mark.parametrize("case", ["span_le_255", "span_gt_255", "pack_off",
                                  "rows_vs_cols", "forced_full",
                                  "forced_mxu"])
def test_pairs_int32_inputs(case):
    g = np.random.default_rng(9)
    cells, base = slab_rows(36, 200, 9, base_choices=(5000,))
    rows = as_i32(cells.astype(np.int64) + base[:, None])
    pol, cols = {}, None
    if case == "span_gt_255":
        rows[3, 7] += 900
    elif case == "pack_off":
        pol = {"pack": False}
    elif case == "rows_vs_cols":
        cols = as_i32(rows[g.permutation(36)[:20]] + g.integers(0, 2, (20, 200)))
    elif case == "forced_full":
        pol = {"engine": "full"}
    elif case == "forced_mxu":
        pol = {"engine": "mxu"}
    jargs = (jnp.asarray(rows),) + (() if cols is None else (jnp.asarray(cols),))
    targs = (torch.as_tensor(rows),) + (() if cols is None
                                        else (torch.as_tensor(cols),))
    jres = jcausal.CausalEngine(jpolicy(**pol)).pairs(*jargs)
    tres = tcausal.CausalEngine(tpolicy(**pol)).pairs(*targs)
    assert_matrix_equal(tres, jres)
    assert tres.engine == jres.engine
    want_engine = {"span_gt_255": "i32", "pack_off": "i32",
                   "rows_vs_cols": "full", "forced_full": "full",
                   "forced_mxu": "mxu"}.get(case, "tri")
    assert tres.engine == want_engine


def test_pairs_batched_bloom_clock_matches_comparability_matrix():
    cells, base = slab_rows(24, M, 10, base_choices=(300,))
    rows = as_i32(cells.astype(np.int64) + base[:, None])
    tclocks = tbc.BloomClock(torch.as_tensor(rows),
                             torch.zeros(24, dtype=torch.int32), K)
    jclocks = jbc.BloomClock(jnp.asarray(rows), jnp.zeros(24, jnp.int32), K)
    tres = tcausal.CausalEngine(tpolicy()).pairs(tclocks)
    tref = tbc.comparability_matrix(tclocks)
    jref = jbc.comparability_matrix(jclocks)
    for key in ("a_le_b", "concurrent"):
        np.testing.assert_array_equal(tref[key].numpy(), np.asarray(jref[key]))
        np.testing.assert_array_equal(tres[key].numpy(), tref[key].numpy())
    assert_fp_close(tref["fp"], jref["fp"])
    assert_fp_close(tres["fp"], tref["fp"])


@pytest.mark.parametrize("with_host", [True, False])
def test_pairs_slab_with_dead_and_promoted_rows(with_host):
    cells, base = slab_rows(CAP, M, 11, base_choices=(1000, 1001))
    logical = as_i32(cells.astype(np.int64) + base[:, None])
    wide = {}
    for s, bump in ((2, 600), (5, 2 ** 31 - 3000)):
        row = logical[s].astype(np.int64)
        row[s] += bump
        wide[s] = as_i32(row)
    alive = np.ones(CAP, bool)
    alive[[7, 11, 5]] = False                 # one promoted row is dead
    jslab, tslab = _slab(cells, base, wide, with_host)
    jres = jcausal.CausalEngine(jpolicy()).pairs(jslab, alive=alive)
    tres = tcausal.CausalEngine(tpolicy()).pairs(tslab, alive=alive)
    assert_matrix_equal(tres, jres)
    assert tres.engine == jres.engine == "tri+wide_rim"
    assert not tres.le.numpy()[~alive].any()
    assert not tres.conc.numpy()[:, ~alive].any()


def test_pairs_slab_alive_compaction_and_empty_fleet():
    cells, base = slab_rows(CAP, M, 12, base_choices=(1000, 1002))
    alive = np.arange(CAP) % 7 != 3
    jslab, tslab = _slab(cells, base)
    jres = jcausal.CausalEngine(jpolicy()).pairs(jslab, alive=alive)
    tres = tcausal.CausalEngine(tpolicy()).pairs(tslab, alive=alive)
    assert_matrix_equal(tres, jres)
    assert tres.engine == jres.engine == "tri"
    dead = np.zeros(CAP, bool)
    jres = jcausal.CausalEngine(jpolicy()).pairs(jslab, alive=dead)
    tres = tcausal.CausalEngine(tpolicy()).pairs(tslab, alive=dead)
    assert_matrix_equal(tres, jres)
    assert tres.engine == jres.engine == "empty"


def test_pairs_rejects_what_the_reference_rejects():
    cells, base = slab_rows(8, M, 13)
    _, tslab = _slab(cells, base)
    eng = tcausal.CausalEngine(tpolicy())
    with pytest.raises(ValueError):
        eng.pairs(tslab, tslab.cells_u8)
    with pytest.raises(ValueError):
        eng.pairs(torch.zeros((4, M), dtype=torch.int32), alive=np.ones(4, bool))
    with pytest.raises(ValueError):
        tcausal.CausalPolicy(engine="ring")
    wide = as_i32(np.arange(4 * M).reshape(4, M) * 3)
    with pytest.raises(ValueError, match="span"):
        tcausal.CausalEngine(tpolicy(engine="tri")).pairs(torch.as_tensor(wide))


def test_comparison_matrix_answers_reference_keys():
    cells, base = slab_rows(10, M, 14)
    _, tslab = _slab(cells, base)
    res = tcausal.CausalEngine(tpolicy()).pairs(tslab)
    assert list(res.keys()) == ["a_le_b", "b_le_a", "concurrent", "fp",
                                "row_sums", "col_sums"]
    assert res["a_le_b"] is res.le and res["concurrent"] is res.conc
    assert dict(res.items())["fp"] is res.fp
    with pytest.raises(KeyError):
        res["le"]
    h = res.to_host()
    assert isinstance(h.fp, np.ndarray) and h.engine == res.engine
    np.testing.assert_array_equal(h.equal(), (res.le & res.ge).numpy())
    np.testing.assert_array_equal(h.confident(1e-4),
                                  (res.le & (res.fp <= 1e-4)).numpy())


def test_pairs_on_cpu_launch_no_kernel():
    before = dict(tops.LAUNCHES)
    cells, base = slab_rows(12, M, 15)
    _, tslab = _slab(cells, base)
    for engine in ("tri", "full", "mxu", "i32"):
        tcausal.CausalEngine(tpolicy(engine=engine)).pairs(tslab)
    assert tops.LAUNCHES == before


# ---------------------------------------------------------------------------
# registry.all_pairs and fleet health
# ---------------------------------------------------------------------------

def _fleet_rows(seed=0):
    """Peer rows like ``chip_smoke.make_peers``: five kinds around one
    clock, two rows wider than a byte, one near-wrap row."""
    cells, base = slab_rows(CAP - 4, M, seed, span=30, base_choices=(40,))
    rows = cells.astype(np.int64) + base[:, None]
    rows[0, 3] += 300
    rows[1, 9] += 400
    rows[2] += 2 ** 31 - 2000
    return as_i32(rows)


def _registries(policy_kw=None, evict=(5, 9, 0)):
    policy_kw = policy_kw or {}
    jreg = jreg_mod.ClockRegistry(CAP, M, K, policy=jpolicy(**policy_kw))
    rows = _fleet_rows()
    jreg.admit_many({f"p{i}": jbc.BloomClock(jnp.asarray(r),
                                             jnp.zeros((), jnp.int32), K)
                     for i, r in enumerate(rows)})
    jreg.evict_many([f"p{i}" for i in evict])
    state = {
        "cells_u8": np.asarray(jreg.cells_u8), "base": np.asarray(jreg.base),
        "sums": np.asarray(jreg.sums), "alive": np.asarray(jreg.alive),
        "slot_of": dict(jreg._slot_of),
        "wide": {s: np.asarray(r) for s, r in jreg._wide.items()},
        "crc": jreg._crc_host.copy(), "free": list(jreg._free),
    }
    treg = convert.registry_from_state(state, M, K, policy=tpolicy(**policy_kw),
                                       device=CPU)
    return jreg, treg


@pytest.mark.parametrize("engine", [None, "full", "mxu"])
def test_registry_all_pairs_matches(engine):
    jreg, treg = _registries()
    assert len(treg._wide) == 2                 # one wide row was evicted
    jres = jreg.all_pairs(engine=engine)
    tres = treg.all_pairs(engine=engine)
    assert_matrix_equal(tres, jres)
    assert tres.engine == jres.engine


def _strict_fps(res, alive):
    pair = alive[:, None] & alive[None, :]
    np.fill_diagonal(pair, False)
    le = host(res["a_le_b"])
    strict = le & ~(le & host(res["b_le_a"])) & pair
    return host(res["fp"])[strict]


def assert_hist_close(th, jh, tfps, jfps, edges):
    """Histograms equal, or differing only by pairs whose fp lies within
    the fp tolerance of a bin edge."""
    assert th.sum() == jh.sum()
    if np.array_equal(th, jh):
        return
    tb = np.digitize(np.log10(np.clip(tfps, 1e-30, 1.0)), edges)
    jb = np.digitize(np.log10(np.clip(jfps, 1e-30, 1.0)), edges)
    moved = jfps[tb != jb].astype(np.float64)
    fe = 10.0 ** edges
    rel = np.abs(moved[:, None] - fe[None, :]) / fe[None, :]
    assert (rel.min(axis=1) <= FP_RTOL).all()


def assert_health_equal(th, jh):
    assert th.n_alive == jh.n_alive
    assert th.n_components == jh.n_components
    assert th.comparable_fraction == jh.comparable_fraction
    np.testing.assert_array_equal(th.component, jh.component)
    np.testing.assert_array_equal(th.straggler_mask, jh.straggler_mask)
    np.testing.assert_array_equal(th.sums, jh.sums)
    np.testing.assert_array_equal(th.fp_bin_edges, jh.fp_bin_edges)
    assert_fp_close(np.float32(th.mean_strict_fp), np.float32(jh.mean_strict_fp))


@pytest.mark.parametrize("policy_kw,straggler_gap", [({}, 64.0),
                                                     ({"engine": "full"}, 8.0)])
def test_fleet_health_matches(policy_kw, straggler_gap):
    jreg, treg = _registries(policy_kw)
    jh = jmon.fleet_health(jreg, straggler_gap=straggler_gap)
    th = tmon.fleet_health(treg, straggler_gap=straggler_gap)
    assert_health_equal(th, jh)
    alive = treg._alive_host
    assert_hist_close(th.fp_hist, jh.fp_hist,
                      _strict_fps(treg.all_pairs(), alive),
                      _strict_fps(jreg.all_pairs(), alive), th.fp_bin_edges)
    assert th.n_components >= 1 and th.fp_hist.sum() > 0


def test_fork_components_scipy_matches_union_find():
    if tmon._scipy_cc is None:
        pytest.skip("scipy is not installed")
    g = np.random.default_rng(16)
    for trial in range(6):
        n = 40
        comp = g.random((n, n)) < (0.01 + 0.02 * trial)
        comp |= comp.T
        alive = g.random(n) < 0.85
        labels, count = tmon.fork_components(comp, alive)
        py_labels, py_count = tmon._fork_components_py(comp, alive)
        j_labels, j_count = jmon.fork_components(comp, alive)
        np.testing.assert_array_equal(labels, py_labels)
        np.testing.assert_array_equal(labels, j_labels)
        assert count == py_count == j_count
    labels, count = tmon.fork_components(comp, np.zeros(n, bool))
    assert count == 0 and (labels == -1).all()


def test_watch_records_into_an_observer():
    jreg, treg = _registries()
    jobs = JObserver(metrics=JMetrics())
    tobs = TObserver(trace=TTracer(), metrics=TMetrics())
    jsnaps = list(jmon.watch(jreg, interval=0.0, samples=2, observer=jobs))
    tsnaps = list(tmon.watch(treg, interval=0.0, samples=2, observer=tobs))
    assert len(tsnaps) == len(jsnaps) == 2
    assert_health_equal(tsnaps[1], jsnaps[1])
    tdump = {(r["kind"], r["name"]): r for r in tobs.metrics.dump()}
    jdump = {(r["kind"], r["name"]): r for r in jobs.metrics.dump()}
    assert tdump.keys() == jdump.keys()
    for key in (("counter", "fleet_health_samples"), ("gauge", "fleet_alive"),
                ("gauge", "fleet_components"), ("gauge", "fleet_stragglers")):
        assert tdump[key] == jdump[key]
    assert tdump[("histogram", "fleet_fp")]["edges"] == \
        jdump[("histogram", "fleet_fp")]["edges"]
    names = [ev["name"] for ev in tobs.trace.events()]
    assert names.count("fleet.health") == 2
