"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode through ``repro.kernels.ops``) on the CPU.  The
CUDA kernels are held against these plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Tolerances: cells, flags, merged rows, packed residuals and bases
identical; float32 sums identical at the reference's bm=512, bn=8 (the
JAX side pins them, ``use_autotune=False``); Eq. 3 fp within a relative
5e-2, with values below the 1e-30 clip floor counted as equal (XLA
flushes float32 subnormals to zero, torch does not).
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pack as jpack  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import pack as tpack  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

FP_RTOL = 5e-2
FP_FLOOR = 1e-30
I32_MAX = 2 ** 31 - 1
ROOT = pathlib.Path(__file__).resolve().parents[1]


def as_i32(x) -> np.ndarray:
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def assert_fp_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    tiny = (np.abs(a) <= FP_FLOOR) & (np.abs(b) <= FP_FLOOR)
    np.testing.assert_allclose(np.where(tiny, 0.0, a), np.where(tiny, 0.0, b),
                               rtol=FP_RTOL, atol=0)


def assert_classify_equal(got: dict, want: dict):
    for key in ("q_le_p", "p_le_q", "sum_q", "sum_p"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for key in ("fp_q_before_p", "fp_p_before_q"):
        assert_fp_close(got[key].numpy(), np.asarray(want[key]))


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [64, 200, 256, 640, 1000])
def test_tile_width_matches_tile_plan(m):
    x = jnp.zeros((3, m), jnp.int32)
    _, _, bm = jops.tile2d(x, 8, 512)
    assert tops.tile_width(m, 512) == bm


@pytest.mark.parametrize("m", [128, 200])
def test_tick_plain_matches_pallas(m):
    rng = np.random.default_rng(0)
    cells = rng.integers(0, 50, (5, m)).astype(np.int32)
    cells[0] = I32_MAX
    hi = rng.integers(0, 2 ** 32, (5, 7), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2 ** 32, (5, 7), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jops.tick(jnp.asarray(cells), jnp.asarray(hi),
                                jnp.asarray(lo), k=4))
    got = tops.tick(torch.as_tensor(cells), hi.astype(np.int64),
                    lo.astype(np.int64), k=4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tick_plain_int16_accumulates_in_int32():
    cells = torch.tensor([[32767, 0, 5]], dtype=torch.int16)
    probes = torch.tensor([[0, 0, 2]], dtype=torch.int32)
    got = ref.bloom_tick_ref(cells, probes)
    assert got.dtype == torch.int16
    assert got.tolist() == [[-32767, 0, 6]]


def _merge_cases():
    rng = np.random.default_rng(1)
    out = []
    for m in (64, 200, 640):
        a = rng.integers(0, 40, (6, m))
        b = a + rng.integers(0, 2, (6, m)) * (np.arange(6)[:, None] % 2)
        b[2] = rng.integers(0, 40, m)
        out.append((a, b))
    a = I32_MAX - rng.integers(0, 100, (4, 256))       # sums wrap
    out.append((a, np.minimum(a + rng.integers(0, 3, a.shape), I32_MAX)))
    return out


@pytest.mark.parametrize("case", range(4))
def test_merge_compare_plain_matches_pallas(case):
    a, b = (as_i32(x) for x in _merge_cases()[case])
    want = jops.merge_compare(jnp.asarray(a), jnp.asarray(b))
    got = tops.merge_compare(torch.as_tensor(a), torch.as_tensor(b))
    for key in ("merged", "a_le_b", "b_le_a", "sum_a", "sum_b"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for key in ("fp_a_before_b", "fp_b_before_a"):
        assert_fp_close(got[key].numpy(), np.asarray(want[key]))


def _query_and_peers(n, m, seed, near_wrap=False):
    rng = np.random.default_rng(seed)
    q = rng.integers(100, 300, m)
    if near_wrap:
        q = I32_MAX - rng.integers(0, 60, m)
    step = rng.integers(-2, 3, (n, 1))
    noise = rng.integers(-1, 2, (n, m)) * (rng.random((n, m)) < 0.02)
    peers = q + step + noise
    peers[: n // 4] = q
    return as_i32(q), as_i32(peers)


@pytest.mark.parametrize("n,m,near_wrap", [(16, 64, False), (13, 200, False),
                                           (24, 256, True), (9, 1000, True)])
def test_one_vs_many_i32_plain_matches_pallas(n, m, near_wrap):
    q, peers = _query_and_peers(n, m, 2, near_wrap)
    want = jops._classify_vs_many(jnp.asarray(q), jnp.asarray(peers))
    got = tops._classify_vs_many(torch.as_tensor(q), torch.as_tensor(peers))
    assert_classify_equal(got, want)


@pytest.mark.parametrize("n,m", [(16, 64), (13, 200), (40, 256), (9, 640)])
def test_one_vs_many_packed_plain_matches_pallas(n, m):
    q, peers = _query_and_peers(n, m, 3)
    peers[-1, 0] += 400                      # clipped residuals: garbage row
    u8, base, _ = jpack.pack_rows(jnp.asarray(peers))
    want = jops._classify_vs_many_packed(jnp.asarray(q), u8, base, bn=8,
                                         bm=512, use_autotune=False)
    got = tops._classify_vs_many_packed(
        torch.as_tensor(q), torch.as_tensor(np.array(u8)),
        torch.as_tensor(np.array(base)))
    assert_classify_equal(got, want)
    assert tops.LAST_DISPATCH == {"op": "one_vs_many", "engine": "packed",
                                  "bn": 8, "bm": 512}


def test_overlay_wide_matches_pallas():
    q, peers = _query_and_peers(12, 128, 4)
    peers[[3, 7], 5] += 1000
    u8, base, _ = jpack.pack_rows(jnp.asarray(peers))
    jout = jops._classify_vs_many_packed(jnp.asarray(q), u8, base, bn=8,
                                         bm=512, use_autotune=False)
    want = jops._overlay_wide_classify(jout, jnp.asarray(q), [3, 7],
                                       jnp.asarray(peers[[3, 7]]))
    tq = torch.as_tensor(q)
    tout = tops._classify_vs_many_packed(
        tq, torch.as_tensor(np.array(u8)), torch.as_tensor(np.array(base)))
    got = tops._overlay_wide_classify(tout, tq, [3, 7],
                                      torch.as_tensor(peers[[3, 7]]))
    assert_classify_equal(got, want)


def test_pack_rows_matches_reference():
    rng = np.random.default_rng(5)
    cells = as_i32(rng.integers(0, 300, (10, 96)) + np.arange(10)[:, None] * 1000)
    cells[3] = as_i32(I32_MAX - rng.integers(0, 20, 96))
    base = as_i32(rng.integers(-5, 5, 10))
    ju8, jbase, jok = jpack.pack_rows(jnp.asarray(cells), jnp.asarray(base))
    tu8, tbase, tok = tpack.pack_rows(torch.as_tensor(cells), torch.as_tensor(base))
    np.testing.assert_array_equal(tu8.numpy(), np.asarray(ju8))
    np.testing.assert_array_equal(tbase.numpy(), np.asarray(jbase))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(
        tpack.unpack_rows(tu8, tbase).numpy(),
        np.asarray(jpack.unpack_rows(ju8, jbase)))
    np.testing.assert_array_equal(
        tpack.rows_fit_u8(torch.as_tensor(cells)).numpy(),
        np.asarray(jpack.rows_fit_u8(jnp.asarray(cells))))


# ---------------------------------------------------------------------------
# the CUDA kernels' arithmetic, emulated in numpy step by step
# ---------------------------------------------------------------------------

def _u32(x) -> np.ndarray:
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32)


def _f32_tile(tot) -> np.float32:
    """tile_sum_f32: a wrapped uint32 tile sum as the float the reference
    adds."""
    return np.float32(np.uint32(int(tot) & 0xFFFFFFFF).view(np.int32))


def emulate_one_vs_many(q, peers, base, bm, cpl=tops.OVM_CHUNKS_PER_LANE):
    """``one_vs_many.cu``'s row body, lane by lane: stages of ``cpl``
    groups of 32 chunks (16 packed or 4 int32 cells a chunk, one a lane);
    the running min and max of the wrapped d = p - q start at 0 and take
    d = 0 past m; a chunk's sum is __dp4a of its words (packed) or their
    sum (int32); a tile is reduced over the lanes, plus n·base, in uint32,
    and added as float in order, in the stage where it ends, each chunk
    added to its own tile.  Returns (flags [N, 2] bool, Σp [N] float32,
    Σq float32)."""
    N, m = peers.shape
    packed = base is not None
    vec = 16 if packed else 4
    stage = 32 * vec * cpl
    qu = np.zeros(-(-m // vec) * vec + stage, np.uint32)
    qu[:m] = _u32(q)
    flags = np.zeros((N, 2), bool)
    sp = np.zeros(N, np.float32)
    for r in range(N):
        b = np.uint32(_u32(base[r])) if packed else np.uint32(0)
        lo = np.zeros(32, np.int64)
        hi = np.zeros(32, np.int64)
        run = np.zeros(32, np.uint64)
        acc = np.float32(0.0)
        tile = [0, min(bm, m)]

        def close():
            nonlocal acc
            tot = (int(run.sum()) + (tile[1] - tile[0]) * int(b)) & 0xFFFFFFFF
            acc = np.float32(acc + _f32_tile(tot))
            run[:] = 0
            tile[:] = tile[1], min(tile[1] + bm, m)

        for s0 in range(0, m, stage):
            c0 = s0 + (np.arange(cpl)[:, None] * 32 + np.arange(32)) * vec
            part = np.zeros((cpl, 32), np.uint64)
            has = c0 < m
            for j, lane in zip(*np.nonzero(has)):
                nv = min(vec, m - c0[j, lane])
                raw = np.zeros(vec, np.int64)
                raw[:nv] = np.asarray(peers[r, c0[j, lane]:c0[j, lane] + nv], np.int64)
                p = _u32(raw + int(b))
                d = (p - qu[c0[j, lane]:c0[j, lane] + vec]).view(np.int32).astype(np.int64)
                d[nv:] = 0                                 # neutral padding
                lo[lane] = min(lo[lane], d.min())
                hi[lane] = max(hi[lane], d.max())
                if packed:                                 # __dp4a a word
                    words = raw.astype(np.uint8).view(np.uint32)
                    part[j, lane] = sum((int(w) >> (8 * e)) & 0xFF
                                        for w in words for e in range(4))
                else:
                    part[j, lane] = int(_u32(raw).astype(np.uint64).sum())
            while tile[0] < m and tile[1] <= min(s0 + stage, m):
                mine = has & (c0 < tile[1])
                run += (part * mine).sum(0)
                part[mine] = 0
                close()
            run += part.sum(0)
        flags[r] = (lo >= 0).all(), (hi <= 0).all()
        sp[r] = acc
    sq = np.float32(0.0)
    for t0 in range(0, m, bm):
        sq = np.float32(sq + _f32_tile(int(_u32(q[t0:t0 + bm]).astype(np.uint64).sum())))
    return flags, sp, sq


def _row_body_case(m, packed, near_wrap, seed, wide=False):
    """A query (around 1,000, or within 255 of INT32_MAX; ``wide``: every
    fifth cell 70,000 higher, a span past 16 bits) and rows
    around it: equal, ancestors, descendants, forked, random, and rows
    whose base is -2^31 or 2^31 - 256 (packed) or that sit across the
    int32 wrap point (int32)."""
    g = np.random.default_rng(seed)
    q0 = I32_MAX - 70255 if near_wrap and wide else I32_MAX - 255 if near_wrap else 1000
    qr = g.integers(0, 200, m)
    if wide:
        qr[::5] += 70000
    q = as_i32(q0 + qr)
    kinds = 8
    rows = np.repeat(qr[None], kinds, axis=0)
    flip = g.random((kinds, m)) < 0.05
    rows[1] += flip[1]
    rows[2] -= flip[2] & (rows[2] > 0)
    rows[3] += flip[3] * g.integers(-1, 2, m)
    rows[4] = g.integers(0, 256, m)
    rows = np.clip(rows, 0, 255)
    base = np.full(kinds, q0, np.int64)
    base[5], base[6], base[7] = -2 ** 31, 2 ** 31 - 256, q0 + 2 ** 31
    rows[5:] = g.integers(0, 256, (3, m))
    if wide:
        rows[:4] = g.integers(0, 256, (4, m))      # the residuals cannot follow
    if packed:
        return q, rows.astype(np.uint8), as_i32(base)
    return q, as_i32(rows + base[:, None]), None


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "i32"])
@pytest.mark.parametrize("m", [1024, 1000, 1008, 520, 7, 1920])
def test_one_vs_many_row_body_emulation(m, packed, wide):
    """The CUDA row body's arithmetic (dp4a byte sums plus n·base in
    uint32, running min/max of the wrapped delta with neutral padding,
    tiles closed in the stage where they end: m = 520 and 1920 take 128-
    and 384-cell tiles, several to a packed stage or across two; queries
    whose span fits 16 bits and ``wide`` ones past it) gives the plain
    version's and the Pallas kernel's flags and sums bit for bit."""
    bm = tops.tile_width(m, 512)
    for near_wrap in (False, True):
        q, peers, base = _row_body_case(m, packed, near_wrap, seed=m, wide=wide)
        flags, sp, sq = emulate_one_vs_many(q, peers, base, bm)
        tq, tp = torch.as_tensor(q), torch.as_tensor(peers)
        tb = None if base is None else torch.as_tensor(base)
        w_flags, w_sums, _ = ref.one_vs_many_ref(tq, tp, tb, bm=bm)
        np.testing.assert_array_equal(flags, w_flags.numpy())
        np.testing.assert_array_equal(sp, w_sums[:, 1].numpy())
        np.testing.assert_array_equal(np.full(len(sp), sq), w_sums[:, 0].numpy())
        if packed:
            want = jops._classify_vs_many_packed(
                jnp.asarray(q), jnp.asarray(peers), jnp.asarray(base), bn=8,
                bm=512, use_autotune=False)
        else:
            want = jops._classify_vs_many(jnp.asarray(q), jnp.asarray(peers))
        np.testing.assert_array_equal(flags[:, 0], np.asarray(want["q_le_p"]))
        np.testing.assert_array_equal(flags[:, 1], np.asarray(want["p_le_q"]))
        np.testing.assert_array_equal(sp, np.asarray(want["sum_p"]))
        assert sq == np.float32(want["sum_q"])
        assert not flags[4].any()                     # the cases bite
        assert flags[0].all() or wide


def emulate_merge_compare(a, b, bm):
    """``bloom_compare.cu``: lanes walk groups of 128 cells (4 a lane)
    where m is a multiple of 4, else 32 cells (1 a lane); a tile closes
    after the group that reaches its end and is reduced in uint32 and
    added as float in order.  Returns (flags [B, 2] bool, sums [B, 2])."""
    B, m = a.shape
    group = 128 if m % 4 == 0 else 32
    flags = np.zeros((B, 2), bool)
    sums = np.zeros((B, 2), np.float32)
    for r in range(B):
        x, y = a[r].astype(np.int64), b[r].astype(np.int64)
        acc = [np.float32(0.0), np.float32(0.0)]
        run = [0, 0]
        tile_end = min(bm, m)
        for g0 in range(0, m, group):
            run[0] += int(_u32(x[g0:g0 + group]).astype(np.uint64).sum())
            run[1] += int(_u32(y[g0:g0 + group]).astype(np.uint64).sum())
            if g0 + group >= tile_end:
                for i in range(2):
                    acc[i] = np.float32(acc[i] + _f32_tile(run[i] & 0xFFFFFFFF))
                run = [0, 0]
                tile_end = min(tile_end + bm, m)
        flags[r] = (x <= y).all(), (x >= y).all()
        sums[r] = acc
    return flags, sums


@pytest.mark.parametrize("m", [1024, 1000, 640, 7])
def test_merge_compare_emulation(m):
    """merge_compare's walk (128-cell groups or 32-cell ones, tiles closed
    after the group that reaches their end) gives the plain version's and
    the Pallas kernel's flags and sums bit for bit, sums wrapping."""
    g = np.random.default_rng(m)
    a = I32_MAX - g.integers(0, 60, (5, m))
    b = np.minimum(a + g.integers(0, 2, a.shape) * (np.arange(5)[:, None] % 2), I32_MAX)
    b[4] = a[4] - g.integers(0, 2, m)
    a, b = as_i32(a), as_i32(b)
    flags, sums = emulate_merge_compare(a, b, tops.tile_width(m, 512))
    _, w_flags, w_sums, _ = ref.bloom_merge_compare_ref(
        torch.as_tensor(a), torch.as_tensor(b), bm=tops.tile_width(m, 512))
    np.testing.assert_array_equal(flags, w_flags.numpy())
    np.testing.assert_array_equal(sums, w_sums.numpy())
    want = jops.merge_compare(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(flags[:, 0], np.asarray(want["a_le_b"]))
    np.testing.assert_array_equal(sums[:, 1], np.asarray(want["sum_b"]))


def test_plain_versions_return_bool_flags():
    """The plain versions give the kernels' dtypes: flags torch.bool, so
    a wrapper's raw (flags, sums, fp) compares with torch.equal on both
    devices, and the classify dicts hold views of the flags."""
    q, peers = _query_and_peers(6, 64, 7)
    tq, tp = torch.as_tensor(q), torch.as_tensor(peers)
    flags, sums, fp = ref.one_vs_many_ref(tq, tp, bm=128)
    assert flags.dtype == torch.bool and sums.dtype == fp.dtype == torch.float32
    _, mflags, _, _ = ref.bloom_merge_compare_ref(tp, tp, bm=128)
    assert mflags.dtype == torch.bool
    out = tops._classify_vs_many(tq, tp)
    assert out["q_le_p"].dtype == torch.bool
    assert (out["q_le_p"].untyped_storage().data_ptr()
            == out["p_le_q"].untyped_storage().data_ptr())


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain version and launch nothing
# ---------------------------------------------------------------------------

def test_cpu_tensors_launch_no_kernel():
    before = dict(tops.LAUNCHES)
    q, peers = _query_and_peers(8, 64, 6)
    tops._classify_vs_many(torch.as_tensor(q), torch.as_tensor(peers))
    tops.merge_compare(torch.as_tensor(peers), torch.as_tensor(peers))
    assert tops.LAUNCHES == before
    assert not _build._LIBS           # nothing was built or loaded


def test_cuda_sources_name_the_replaced_kernel():
    for lib_name, (src, entries) in _build.SOURCES.items():
        text = (_build._CSRC / src).read_text()
        assert "Replaces the TPU kernel repro/kernels/" in text, src
        assert "Bound on this card:" in text, src
        for fn in entries:
            assert f'extern "C" int {fn}(' in text, (src, fn)


def test_cuda_entry_points_match_argtypes():
    """Each C entry point's parameter count equals its ctypes argtypes."""
    for _, (src, entries) in _build.SOURCES.items():
        text = (_build._CSRC / src).read_text()
        for fn, argtypes in entries.items():
            sig = text.split(f'extern "C" int {fn}(')[1].split(")")[0]
            assert len(sig.split(",")) == len(argtypes), fn


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
