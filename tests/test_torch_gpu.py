"""The port's CUDA kernels against their plain PyTorch versions, on the
card: tick, merge-compare, one-vs-many, the hybrid sweep, and the
all-pairs tri, rect-u8, rect-i32-stats and mxu kernels (mxu on both
sides of its dispatch point ``ops.MXU_T_MAX``); the paths above them
(sharded registries, the mesh transport, socket sessions, the chaos
sim, model serving and training, the MoE, SSM, hybrid and enc-dec
families) on the card against the CPU; the model mesh on NCCL groups
(one rank, and 2 x 2 over four cards) against the plain port.  Every test here carries the
``gpu`` marker and skips without a CUDA device (decided in a fixture,
never at import time).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: cells, flags, merged rows, violation counts and float32 sums
identical (same bm tiling, integer tile sums, float adds in tile order);
Eq. 3 fp within a relative 5e-2 (libm ulps), values at or below the
1e-30 clip floor counted as equal, and infinities (wrapped negative
sums) equal to themselves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, pack, ref  # noqa: E402

FP_RTOL = 5e-2
FP_FLOOR = 1e-30
I32_MAX = 2 ** 31 - 1


@pytest.fixture
def cuda():
    """The card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def as_i32(x) -> np.ndarray:
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def assert_fp_close(a, b):
    a = a.cpu().numpy().astype(np.float64)
    b = b.cpu().numpy().astype(np.float64)
    same = a == b
    tiny = (np.abs(a) <= FP_FLOOR) & (np.abs(b) <= FP_FLOOR)
    keep = ~(same | tiny)
    np.testing.assert_allclose(a[keep], b[keep], rtol=FP_RTOL, atol=0)


def query_and_peers(n, m, seed, near_wrap=False, wide=False):
    """A query and n peers around it; ``wide``: every fifth query cell
    70,000 higher (a query span past 16 bits)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(100, 300, m)
    if near_wrap:
        q = I32_MAX - 70100 - rng.integers(0, 60, m) if wide else I32_MAX - rng.integers(0, 60, m)
    if wide:
        q[::5] += 70000
    step = rng.integers(-2, 3, (n, 1))
    noise = rng.integers(-1, 2, (n, m)) * (rng.random((n, m)) < 0.02)
    peers = q + step + noise
    peers[: n // 4] = q
    return as_i32(q), as_i32(peers)


#: aten ops a wrapper may issue on the card besides its one kernel:
#: allocations and views, none of which launches anything
_NO_LAUNCH = {"empty", "empty_like", "empty_strided", "select", "slice",
              "view", "alias", "_reshape_alias", "as_strided", "expand",
              "unsqueeze", "squeeze", "t", "transpose", "detach"}


def card_ops(fn):
    """``fn()`` and the names of the aten ops it ran on CUDA tensors."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    names = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            leaves = tree_flatten((args, kwargs, out))[0]
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
                names.append(func.overloadpacket.__name__)
            return out

    with Record():
        result = fn()
    return result, names


def one_launch(fn, name):
    """``fn()``, checked to be one launch of kernel ``name`` and nothing
    else on the card (no conversion or copy kernel around it)."""
    n0 = ops.LAUNCHES[name]
    out, names = card_ops(fn)
    assert ops.LAUNCHES[name] == n0 + 1, name
    assert set(names) <= _NO_LAUNCH, (name, sorted(set(names) - _NO_LAUNCH))
    return out


def assert_flag_views(lo, hi):
    """Two flag columns: torch.bool views of one [N, 2] kernel output."""
    assert lo.dtype == hi.dtype == torch.bool
    assert lo.untyped_storage().data_ptr() == hi.untyped_storage().data_ptr()
    assert hi.data_ptr() == lo.data_ptr() + 1 and lo.stride() == (2,)


def offset_view(x, offset):
    """``x`` copied into a buffer ``offset`` elements in: contiguous, its
    data pointer not aligned to more than one element."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def tick_plain(cells, probes, rows=512):
    """``ref.bloom_tick_ref`` a few rows at a time (its one-hot compare
    takes B * P * m bytes)."""
    return torch.cat([ref.bloom_tick_ref(cells[i:i + rows], probes[i:i + rows])
                      for i in range(0, cells.shape[0], rows)])


@pytest.mark.gpu
@pytest.mark.parametrize("P", [4, 64, 1000])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("m", [1024, 1000, 1001, 7])
@pytest.mark.parametrize("B", [1, 3, 4096 + 5])
def test_cuda_tick_matches_plain(cuda, B, m, dtype, P):
    """One warp a row over a grid of fewer warps than 4,101 rows; 16-byte
    vectors where rows are 16-byte aligned (m = 1024, 1000 for both
    types), scalar cells where they are not (m = 1001, 7, and every case
    again from a buffer one cell in); 16-bit cells wrapping at their
    maximum; probes at -1 and m hitting nothing."""
    rng = np.random.default_rng(7)
    info = torch.iinfo(dtype)
    cells = torch.as_tensor(rng.integers(0, 100, (B, m)), dtype=dtype,
                            device=cuda)
    cells[0] = info.max
    cells[-1, ::2] = info.max - 1
    probes = rng.integers(0, m, (B, P))
    probes[:, 0] = -1
    probes[:, -1] = m
    probes[-1, : P // 2] = 0                 # many probes on one cell
    probes = torch.as_tensor(probes, dtype=torch.int32, device=cuda)
    want = tick_plain(cells, probes)
    n0 = ops.LAUNCHES["bloom_tick"]
    got = ops.tick_probes(cells, probes)
    assert ops.LAUNCHES["bloom_tick"] == n0 + 1
    assert torch.equal(got, want)
    shifted = torch.empty(B * m + 1, dtype=dtype, device=cuda)[1:].view(B, m)
    shifted.copy_(cells)
    assert torch.equal(ops.tick_probes(shifted, probes), want)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 300, 4101])
@pytest.mark.parametrize("m,near_wrap", [(1024, False), (1000, False),
                                         (640, True), (7, True)])
def test_cuda_merge_compare_matches_plain(cuda, m, near_wrap, B):
    """One warp a row: 16-byte vectors where rows are 16-byte aligned,
    scalar cells where m is not a multiple of 4 or the rows sit one cell
    into their buffer; B = 1 (the receive path) up to more rows than the
    grid has CTAs; one launch, flags torch.bool."""
    rng = np.random.default_rng(8)
    a = rng.integers(0, 40, (B, m))
    if near_wrap:
        a = I32_MAX - a
    b = np.minimum(a + rng.integers(0, 2, a.shape) * (rng.random((B, 1)) < 0.5),
                   I32_MAX)
    b[::3] = a[::3] - rng.integers(0, 2, (len(a[::3]), m))
    ta = torch.as_tensor(as_i32(a), device=cuda)
    tb = torch.as_tensor(as_i32(b), device=cuda)
    merged, flags, sums, fp = ref.bloom_merge_compare_ref(
        ta, tb, bm=ops.tile_width(m, 512))
    assert flags.dtype == torch.bool
    for xa, xb in ((ta, tb), (offset_view(ta, 1), offset_view(tb, 1))):
        got = one_launch(lambda: ops.merge_compare(xa, xb), "bloom_merge_compare")
        assert_flag_views(got["a_le_b"], got["b_le_a"])
        assert torch.equal(got["merged"], merged)
        assert torch.equal(got["a_le_b"], flags[:, 0])
        assert torch.equal(got["b_le_a"], flags[:, 1])
        assert torch.equal(got["sum_a"], sums[:, 0])
        assert torch.equal(got["sum_b"], sums[:, 1])
        assert_fp_close(got["fp_a_before_b"], fp[:, 0])
        assert_fp_close(got["fp_b_before_a"], fp[:, 1])


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,near_wrap", [(300, 1024, False), (77, 1000, True),
                                           (65, 1008, True), (9, 520, False),
                                           (1, 1024, False), (7, 1000, True),
                                           (7, 7, True), (65539, 1024, False),
                                           (65, 640, True), (33, 1920, False)])
@pytest.mark.parametrize("wide", [False, True])
def test_cuda_one_vs_many_matches_plain(cuda, n, m, near_wrap, wide):
    """Both instances from one row to more rows than the grid has warps
    (65,539: batches of 32 rows a warp, the last one short), aligned rows
    through the cp.async ring and rows one element into their buffer
    through scalar loads, m-tiles that hold whole chunk groups (bm = 512)
    and tiles that end inside one (m = 640 and 1920: bm = 128 and 384),
    queries whose span fits 16 bits and ``wide`` ones past it; one
    launch a call, flags torch.bool."""
    q, peers = query_and_peers(n, m, 9, near_wrap, wide)
    tq = torch.as_tensor(q, device=cuda)
    tp = torch.as_tensor(peers, device=cuda)
    u8, base, _ = pack.pack_rows(tp)
    bm = ops.tile_width(m, ops._one_vs_many_blocks(n, m, None, None, "cuda")[1])
    for name, got, (flags, sums, fp) in (
            ("one_vs_many_i32", lambda p, b: ops._classify_vs_many(tq, p),
             ref.one_vs_many_ref(tq, tp, bm=ops.tile_width(m, 512))),
            ("one_vs_many_packed",
             lambda p, b: ops._classify_vs_many_packed(tq, p, b),
             ref.one_vs_many_ref(tq, u8, base, bm=bm))):
        assert flags.dtype == torch.bool
        rows = tp if name == "one_vs_many_i32" else u8
        for p, b in ((rows, base), (offset_view(rows, 1), offset_view(base, 1))):
            out = one_launch(lambda: got(p, b), name)
            assert_flag_views(out["q_le_p"], out["p_le_q"])
            assert torch.equal(out["q_le_p"], flags[:, 0]), name
            assert torch.equal(out["p_le_q"], flags[:, 1]), name
            assert torch.equal(out["sum_p"], sums[:, 1]), name
            assert torch.equal(out["sum_q"], sums[0, 0]), name
            assert_fp_close(out["fp_q_before_p"], fp[:, 0])
            assert_fp_close(out["fp_p_before_q"], fp[:, 1])


@pytest.mark.gpu
def test_cuda_wrappers_reject_bad_inputs(cuda):
    cells = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ops.tick_probes(cells, torch.zeros((4, 8), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        ops.merge_compare(cells[:, ::2], cells[:, ::2])
    with pytest.raises(ValueError):
        ops._classify_vs_many(cells[0], cells, bn=64)


@pytest.mark.gpu
def test_cuda_main_path_matches_cpu(cuda):
    from repro_torch.core import clock as bc
    from repro_torch.runtime import ClockConfig, ClockRuntime

    def run(device):
        rt = ClockRuntime(ClockConfig(m=256, k=4), device=device)
        for s in range(64):
            rt.tick_step(s)
        q, peers = query_and_peers(500, 256, 10)
        peers = peers + rt.clock.logical_cells().cpu().numpy() - q
        peers[0, 3] += 400                   # one promoted row
        reg = rt.make_registry(512)
        zero = torch.zeros((), dtype=torch.int32)
        reg.admit_many({i: bc.BloomClock(torch.as_tensor(r), zero, 4)
                        for i, r in enumerate(peers)})
        view = rt.classify_fleet(reg)
        lineage = [rt.lineage(reg.get(i)) for i in range(0, 500, 50)]
        reports = [rt.gossip(reg) for _ in range(3)]
        return view, lineage, reports, rt.clock.logical_cells().cpu(), reg

    gv, glin, grep_, gclock, greg = run(cuda)
    cv, clin, crep, cclock, creg = run("cpu")
    assert [s for s, _ in glin] == [s for s, _ in clin]
    np.testing.assert_allclose([f for _, f in glin], [f for _, f in clin],
                               rtol=FP_RTOL)
    np.testing.assert_array_equal(gv.status, cv.status)
    np.testing.assert_array_equal(np.asarray(gv.sums), np.asarray(cv.sums))
    for g, c in zip(grep_, crep):
        np.testing.assert_array_equal(g.accepted, c.accepted)
        np.testing.assert_array_equal(g.quarantined, c.quarantined)
        assert g.pushback_bytes == c.pushback_bytes
    assert torch.equal(gclock, cclock)
    assert torch.equal(greg.cells_u8.cpu(), creg.cells_u8)
    assert torch.equal(greg.base.cpu(), creg.base)


# ---------------------------------------------------------------------------
# all-pairs kernels
# ---------------------------------------------------------------------------

def packed_slab(n, m, seed, bases):
    rng = np.random.default_rng(seed)
    local = rng.integers(1, 38, m)
    rows = np.repeat(local[None], n, axis=0)
    rows += rng.integers(-1, 2, (n, m)) * (rng.random((n, m)) < 0.03)
    rows[::4] = rng.integers(0, 40, (len(rows[::4]), m))
    return (torch.as_tensor(np.clip(rows, 0, 255), dtype=torch.uint8),
            torch.as_tensor(as_i32(rng.choice(np.asarray(bases), n))))


_FAR = (-2 ** 31, -70000, 1000, 1300, 5000, I32_MAX - 100)


@pytest.mark.gpu
@pytest.mark.parametrize("n,mc,m,bi,bj", [(1000, 777, 640, 64, 64),
                                           (130, 70, 1, 32, 32),
                                           (200, 300, 1024, 128, 64),
                                           (33, 100, 67, 32, 128),
                                           (131, 50, 3, 64, 64),
                                           (97, 40, 1001, 32, 64)])
def test_cuda_tri_and_rect_u8_match_plain(cuda, n, mc, m, bi, bj):
    """tri runs rect-u8's 16-bit-lane body over upper-triangle tiles:
    odd m, rows one byte into their buffer, N ragged against bt 32 and
    64, and bases 2^31 apart, where tri's mirrored flags depart from the
    directly computed ones (``ref.tri_flags_ref`` keeps the departure)."""
    rows, rb = packed_slab(n, m, 11, _FAR + (-2 ** 31 + 1000,))
    cols, cb = packed_slab(mc, m, 12, _FAR)
    rb[0], rb[1] = 1000, -2 ** 31 + 1000                  # 2^31 apart
    cols[: min(n, mc) // 2] = rows[: min(n, mc) // 2]
    base = rb.numpy().astype(np.int64)
    i, j = np.indices((n, n))
    mirrored = ((base[:, None] - base[None, :]) % 2 ** 32 == 2 ** 31) & (i > j)
    mirrored = torch.as_tensor(mirrored, device=cuda)
    rows, rb, cols, cb = (t.to(cuda) for t in (rows, rb, cols, cb))
    for offset in (0, 1):
        r, c = (offset_view(t, offset) for t in (rows, cols))
        assert offset == 0 or r.data_ptr() % 4 != 0
        for with_base in (True, False):
            n0 = ops.LAUNCHES["matrix_rect_u8"]
            le, ge = ops.rect_u8_flags(r, c, rb, cb, bi=bi, bj=bj,
                                       with_base=with_base)
            assert ops.LAUNCHES["matrix_rect_u8"] == n0 + 1
            want = ref.rect_u8_flags_ref(r, c, *((rb, cb) if with_base else ()))
            assert torch.equal(le, want[0]) and torch.equal(ge, want[1])
            for bt in (32, 64):
                n0 = ops.LAUNCHES["matrix_tri"]
                le, ge = ops.tri_flags(r, rb, bt=bt, with_base=with_base)
                assert ops.LAUNCHES["matrix_tri"] == n0 + 1
                want = ref.tri_flags_ref(r, rb if with_base else None)
                assert torch.equal(le, want[0]) and torch.equal(ge, want[1])
                if not with_base:
                    continue
                # the rect-u8 kernel computes every pair directly: tri
                # agrees with it except on mirrored pairs 2^31 apart
                d_le, d_ge = ops.rect_u8_flags(r, r, rb, rb, bi=bt, bj=bt)
                assert torch.equal(le[~mirrored], d_le[~mirrored])
                assert torch.equal(ge[~mirrored], d_ge[~mirrored])
                assert torch.equal(le[mirrored], d_ge.T[mirrored])
                assert torch.equal(ge[mirrored], d_le.T[mirrored])
                assert bool(d_le[mirrored].all()) and not bool(d_ge[mirrored].any())
                assert not bool(le[mirrored].any()) and bool(ge[mirrored].all())


@pytest.mark.gpu
@pytest.mark.parametrize("n,mc,m,bi,bj", [(300, 77, 1024, 64, 64),
                                           (77, 300, 1000, 32, 32),
                                           (65, 129, 520, 128, 64)])
def test_cuda_rect_i32_stats_matches_plain(cuda, n, mc, m, bi, bj):
    _, rows = query_and_peers(n, m, 13, near_wrap=True)
    _, cols = query_and_peers(mc, m, 14, near_wrap=True)
    rows = rows.astype(np.int64)
    rows[1, 5] += 1000                       # span beyond a byte, wraps
    rows = as_i32(rows)
    rows = torch.as_tensor(rows, device=cuda)
    cols = torch.as_tensor(cols, device=cuda)
    col_sums = ref.wrap_sum_i32(cols).to(torch.float32)
    n0 = ops.LAUNCHES["matrix_rect_i32"]
    le, ge, sums, fp = ops.rect_i32_stats(rows, cols, col_sums, bi=bi, bj=bj)
    assert ops.LAUNCHES["matrix_rect_i32"] == n0 + 1
    w_le, w_ge, w_sums, w_fp = ref.rect_i32_stats_ref(
        rows, cols, col_sums, bm=ops.tile_width(m, 512))
    assert torch.equal(le, w_le) and torch.equal(ge, w_ge)
    assert torch.equal(sums, w_sums)
    assert_fp_close(fp, w_fp)


_TILES = [(32, 32), (32, 64), (32, 128), (64, 32), (64, 64), (64, 128),
          (128, 32), (128, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("bi,bj", _TILES)
@pytest.mark.parametrize("m", [1, 3, 63, 65, 1001])
def test_cuda_rect_u8_u16x2_edges(cuda, m, bi, bj):
    """Two 16-bit lanes a word: odd m (lane m - 1 pads the last word and
    chunk), m off a multiple of 64, rows and cols one byte into their
    buffer (byte reads), N and M ragged against every tile, d = +-255,
    bases far apart, 2^31 apart and at the +-256 clip."""
    bases = _FAR + (-2 ** 31 + 5000, 5256, 4744, 5257)
    rows, rb = packed_slab(133, m, 21, bases)
    cols, cb = packed_slab(71, m, 22, bases)
    cols[:40], cb[:40] = rows[:40], rb[:40]
    rows[5], rows[7], cols[6], cols[8] = 255, 0, 255, 0
    rb, cb = rb.to(cuda), cb.to(cuda)
    for offset in (0, 1):
        r, c = (offset_view(t.to(cuda), offset) for t in (rows, cols))
        assert offset == 0 or r.data_ptr() % 4 != 0
        for with_base in (True, False):
            n0 = ops.LAUNCHES["matrix_rect_u8"]
            le, ge = ops.rect_u8_flags(r, c, rb, cb, bi=bi, bj=bj,
                                       with_base=with_base)
            assert ops.LAUNCHES["matrix_rect_u8"] == n0 + 1
            want = ref.rect_u8_flags_ref(r, c, *((rb, cb) if with_base else ()))
            assert torch.equal(le, want[0]) and torch.equal(ge, want[1])
            assert bool(le.any()) and not bool(le.all())


@pytest.mark.gpu
@pytest.mark.parametrize("bi,bj", _TILES)
@pytest.mark.parametrize("m", [1, 3, 64, 1001, 1024])
def test_cuda_rect_i32_stats_edges(cuda, m, bi, bj):
    """cp.async staging and the row-sum pre-pass: 16-byte copies where
    rows are 16-byte aligned, 4-byte copies at odd m and for rows one
    int32 into their buffer; near-wrap rows (wrapping tile sums), rows
    whose sums exceed 2^24, N and M ragged against every tile."""
    _, rows = query_and_peers(133, m, 23, near_wrap=True)
    _, cols = query_and_peers(71, m, 24, near_wrap=True)
    rng = np.random.default_rng(m)
    rows = rows.astype(np.int64)
    rows[2::3] = 40_000 + rng.integers(-3, 4, (len(rows[2::3]), m)) * 997
    rows = as_i32(rows)
    cols[:20] = rows[:20]
    col_sums = ref.wrap_sum_i32(torch.as_tensor(cols)).to(torch.float32).to(cuda)
    bm = ops.tile_width(m, 512)
    for offset in (0, 1):
        r, c = (offset_view(torch.as_tensor(x, device=cuda), offset)
                for x in (rows, cols))
        n0 = ops.LAUNCHES["matrix_rect_i32"]
        le, ge, sums, fp = ops.rect_i32_stats(r, c, col_sums, bi=bi, bj=bj)
        assert ops.LAUNCHES["matrix_rect_i32"] == n0 + 1
        w_le, w_ge, w_sums, w_fp = ref.rect_i32_stats_ref(r, c, col_sums, bm=bm)
        assert torch.equal(le, w_le) and torch.equal(ge, w_ge)
        assert torch.equal(sums, w_sums)
        assert_fp_close(fp, w_fp)
        assert bool(le.any()) and not bool(le.all())
        if m >= 1001:
            assert bool((sums[2::3].abs() > 2 ** 24).all())
            exact = torch.as_tensor(rows.astype(np.int64).sum(1), dtype=torch.float64)
            assert bool((sums[::3].cpu().double() != exact[::3]).all())   # wrapped


def adversarial_mxu(rng, n, mc, m, T, lo):
    """u8 rows and cols with int32 bases around ``lo``: half in the
    window, the rest far below or above it, at the edges of the kernel's
    [-257, T + 1] offset cut, or where u8 + base - lo wraps in int32; the
    first third of cols equal to rows (viol 0)."""
    far = np.array([-2 ** 30, -300, -258, -257, -256, -2, T + 1, T + 2, 300,
                    2 ** 30] + [I32_MAX - t for t in (0, 1, 100, 200, 254, 255,
                                                       256)], np.int64)

    def side(n):
        res = rng.integers(0, T - 3, (n, m))
        res[1::2] = rng.integers(0, 256, (len(res[1::2]), m))
        off = rng.integers(0, 3, n).astype(np.int64)
        pick = rng.random(n) < 0.5
        off[pick] = rng.choice(far, int(pick.sum()))
        return res.astype(np.uint8), as_i32(lo + off)

    rows, rb = side(n)
    cols, cb = side(mc)
    k = min(n, mc) // 3
    cols[:k], cb[:k] = rows[:k], rb[:k]
    return rows, cols, rb, cb


@pytest.mark.gpu
@pytest.mark.parametrize("bi,bj", [(64, 64), (32, 128), (128, 64)])
@pytest.mark.parametrize("T,lo", [(8, -5), (16, I32_MAX - 20),
                                  (32, -2 ** 31 + 3), (64, 0), (64, I32_MAX)])
@pytest.mark.parametrize("m", [2, 130, 1001, 8192])
def test_cuda_mxu_matches_plain(cuda, m, T, lo, bi, bj):
    """Two 16-bit lanes a word: ragged m (byte reads where rows are not
    4-byte aligned), N and M ragged against the tile, near-wrap ``lo``,
    bases far outside the window on both sides, identical rows, and at
    m = 8192, T = 64 counts far above 16 bits (several flushes)."""
    rng = np.random.default_rng(15)
    rows, cols, rb, cb = (torch.as_tensor(x, device=cuda)
                          for x in adversarial_mxu(rng, 300, 77, m, T, lo))
    n0 = ops.LAUNCHES["matrix_mxu"]
    got = ops.mxu_viol(rows, cols, rb, cb, lo=lo, n_thresholds=T, bi=bi, bj=bj)
    assert ops.LAUNCHES["matrix_mxu"] == n0 + 1
    want = ref.mxu_viol_ref(rows, cols, rb, cb, lo=lo, n_thresholds=T)
    assert torch.equal(got, want)
    assert (torch.diagonal(got[:25, :25]) == 0).all() and (got > 0).any()
    if m == 8192 and T == 64:
        assert want.max() > 65535


@pytest.mark.gpu
@pytest.mark.parametrize("bi,bj", [(64, 64), (128, 32)])
@pytest.mark.parametrize("lo", [-2 ** 31 + 3, I32_MAX - 20])
@pytest.mark.parametrize("m,T", [(1024, ops.MXU_T_MAX), (1024, ops.MXU_T_MAX + 1),
                                 (1024, 16383), (300, 50_000)])
def test_cuda_mxu_wide_t_matches_plain(cuda, m, T, lo, bi, bj):
    """Both sides of MXU_T_MAX, the dispatch point between the packed
    16-bit-lane kernel and the 32-bit-lane one, up to the reference's
    m * T < 2^24: counts identical to ``ref.mxu_viol_ref`` over N and M
    ragged against two tiles, ``lo`` near both ends of int32, bases far
    outside the window and where u8 + base - lo wraps, identical rows."""
    rng = np.random.default_rng(T)
    rows, cols, rb, cb = (torch.as_tensor(x, device=cuda)
                          for x in adversarial_mxu(rng, 300, 77, m, T, lo))
    n0 = ops.LAUNCHES["matrix_mxu"]
    got = ops.mxu_viol(rows, cols, rb, cb, lo=lo, n_thresholds=T, bi=bi, bj=bj)
    assert ops.LAUNCHES["matrix_mxu"] == n0 + 1
    want = ref.mxu_viol_ref(rows, cols, rb, cb, lo=lo, n_thresholds=T)
    assert torch.equal(got, want)
    assert (torch.diagonal(got[:25, :25]) == 0).all() and (got > 0).any()


@pytest.mark.gpu
def test_cuda_pair_wrappers_reject_bad_inputs(cuda):
    u8 = torch.zeros((8, 64), dtype=torch.uint8, device=cuda)
    base = torch.zeros((8,), dtype=torch.int32, device=cuda)
    i32 = torch.zeros((8, 64), dtype=torch.int32, device=cuda)
    sums = torch.zeros((8,), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        ops.tri_flags(i32, base)
    with pytest.raises(ValueError):
        ops.tri_flags(u8, base[:4])
    with pytest.raises(ValueError):
        ops.rect_u8_flags(u8, u8.cpu(), base, base)
    with pytest.raises(ValueError):
        ops.rect_u8_flags(u8, u8, base, base, bi=48)
    with pytest.raises(ValueError):
        ops.tri_flags(u8, base, bt=128)           # 1024 threads a block
    with pytest.raises(TypeError):
        ops.rect_i32_stats(i32, i32, sums.to(torch.float64))
    with pytest.raises(ValueError):
        ops.rect_i32_stats(i32, i32[:, ::2], sums)
    with pytest.raises(TypeError):
        ops.mxu_viol(u8, u8, base, base.to(torch.int64), lo=0, n_thresholds=8)
    with pytest.raises(ValueError):
        ops.mxu_viol(u8, u8, base.cpu(), base, lo=0, n_thresholds=8)
    with pytest.raises(ValueError, match="2\\^24"):  # m * T = 2^24, as the reference
        ops.mxu_viol(u8, u8, base, base, lo=0, n_thresholds=2 ** 24 // 64)


@pytest.mark.gpu
def test_cuda_fleet_health_matches_cpu(cuda):
    from repro_torch.core import clock as bc
    from repro_torch.fleet import ClockRegistry, fleet_health

    q, peers = query_and_peers(250, 256, 16)
    peers[0, 3] += 400                       # promoted: span beyond a byte
    peers[1] = as_i32(peers[1].astype(np.int64) + 2 ** 31 - 2000)   # near wrap
    zero = torch.zeros((), dtype=torch.int32)

    def run(device):
        reg = ClockRegistry(256, 256, 4, device=device)
        reg.admit_many({i: bc.BloomClock(torch.as_tensor(r), zero, 4)
                        for i, r in enumerate(peers)})
        reg.evict_many([5, 17])
        return reg.all_pairs().to_host(), fleet_health(reg)

    (gp, gh), (cp, ch) = run(cuda), run("cpu")
    for key in ("a_le_b", "b_le_a", "concurrent", "row_sums"):
        np.testing.assert_array_equal(gp[key], cp[key])
    assert gp.engine == cp.engine == "tri+wide_rim"
    np.testing.assert_array_equal(gh.component, ch.component)
    np.testing.assert_array_equal(gh.straggler_mask, ch.straggler_mask)
    assert gh.n_components == ch.n_components
    assert_fp_close(torch.as_tensor(gp.fp), torch.as_tensor(cp.fp))


# ---------------------------------------------------------------------------
# the hybrid kernel
# ---------------------------------------------------------------------------

def hybrid_case(H, T, m, seed, near_wrap, device):
    """A query, V, [H, 2] hot metadata and [H] sums, and a packed tail of
    T rows around the query, on ``device``."""
    q, peers = query_and_peers(T, m, seed, near_wrap)
    rng = np.random.default_rng(seed)
    V = 20
    meta = np.stack([rng.integers(0, 40, H), rng.integers(0, 3, H)], 1)
    meta[: min(H, 2), 0] = V
    hot_sums = (4.0 * meta.sum(1)).astype(np.float32)
    tp = torch.as_tensor(peers, device=device)
    u8, base, _ = pack.pack_rows(tp)
    return (torch.as_tensor(q, device=device), V,
            torch.as_tensor(meta.astype(np.int32), device=device),
            torch.as_tensor(hot_sums, device=device), u8, base)


@pytest.mark.gpu
@pytest.mark.parametrize("H,T,m,near_wrap", [(4096, 2000, 1024, False),
                                             (13, 1001, 200, True),
                                             (4095, 77, 1000, True),
                                             (1, 9, 520, False),
                                             (1, 1, 1024, False),
                                             (4089, 1, 1000, True),
                                             (1, 65539, 1024, True),
                                             (4089, 65539, 1024, False),
                                             (5, 300, 640, False)])
def test_cuda_hybrid_matches_plain_and_packed(cuda, H, T, m, near_wrap):
    """Hot and tail sides from one row each to the path's 4,089 over
    65,539, aligned and one element into their buffers; one launch a
    call, flags torch.bool; tail rows bit-identical to the packed
    one-vs-many kernel."""
    q, V, meta, hs, u8, base = hybrid_case(H, T, m, 11, near_wrap, cuda)
    bm = ops.tile_width(m, 512)
    w_flags, w_sums, w_fp = ref.hybrid_classify_ref(q, V, meta, hs, u8, base,
                                                    bm=bm)
    assert w_flags.dtype == torch.bool
    for tail in (u8, offset_view(u8, 1)):
        flags, sums, fp = one_launch(
            lambda: ops.hybrid(q, V, meta, hs, tail, base), "hybrid")
        assert flags.dtype == torch.bool
        assert torch.equal(flags, w_flags)
        assert torch.equal(sums, w_sums)
        assert_fp_close(fp, w_fp)
        assert bool((fp[:H] == 0).all())
        # the tail rows are the packed one-vs-many kernel's, bit for bit
        flat = ops._classify_vs_many_packed(q, tail, base, bm=512)
        out = ops._classify_dict(flags, sums, fp)
        assert_flag_views(out["q_le_p"], out["p_le_q"])
        for key in ("q_le_p", "p_le_q", "sum_p", "fp_q_before_p",
                    "fp_p_before_q"):
            assert torch.equal(out[key][H:], flat[key]), key
        assert torch.equal(out["sum_q"], flat["sum_q"])


@pytest.mark.gpu
def test_cuda_hybrid_rejects_bad_inputs(cuda):
    q, V, meta, hs, u8, base = hybrid_case(8, 16, 256, 12, False, cuda)
    with pytest.raises(ValueError):
        ops.hybrid(q, V, meta[:0], hs[:0], u8, base)
    with pytest.raises(ValueError):
        ops.hybrid(q, V, meta, hs, u8[:0], base[:0])
    with pytest.raises(TypeError):
        ops.hybrid(q, V, meta.to(torch.int64), hs, u8, base)
    with pytest.raises(ValueError):
        ops.hybrid(q, V, meta, hs, u8, base, bn=64)
    with pytest.raises(ValueError):
        ops.hybrid(q.cpu(), V, meta, hs, u8, base)


@pytest.mark.gpu
def test_cuda_hybrid_engine_matches_cpu(cuda):
    from repro_torch.core.hashing import stable_event_id
    from repro_torch.hybrid import HybridConfig, HybridEngine

    def run(device):
        eng = HybridEngine(HybridConfig(m=512, k=4, hot_capacity=16,
                                        tail_capacity=256, promote_after=2,
                                        min_residency=0), device=device)
        eng.advance_local(96)
        rng = np.random.default_rng(13)
        eng.admit_many(
            [(f"s{i}", int(rng.integers(0, 96)),
              [stable_event_id(b"gpu/priv", i, j)
               for j in range(rng.integers(0, 3))]) for i in range(200)]
            + [("wide", 3, [stable_event_id(b"gpu/priv", 0, 0)] * 300)])
        for i in range(12):
            eng.touch(f"s{i}")
            eng.touch(f"s{i}")
        views = [eng.classify()]
        res, order = eng.pairs()
        eng.resize_tail(256)
        views.append(eng.classify())
        return views, res.to_host(), order

    n0 = ops.LAUNCHES["hybrid"]
    gviews, gres, gorder = run(cuda)
    assert ops.LAUNCHES["hybrid"] == n0 + 2
    cviews, cres, corder = run("cpu")
    assert gorder == corder
    for g, c in zip(gviews, cviews):
        assert g.sids == c.sids and g.engine == c.engine
        assert g.engine == "fused_hot_tail+wide_overlay"
        for key in ("hot", "q_le_p", "p_le_q", "sum_p"):
            np.testing.assert_array_equal(getattr(g, key), getattr(c, key))
        assert g.sum_q == c.sum_q
    for key in ("a_le_b", "b_le_a", "concurrent", "row_sums"):
        np.testing.assert_array_equal(gres[key], cres[key])
    assert gres.engine == cres.engine


# ---------------------------------------------------------------------------
# the serving tier (repro_torch.serve) on the card against the CPU
# ---------------------------------------------------------------------------

SERVE_M = 256


@pytest.mark.gpu
@pytest.mark.parametrize("B,E", [(3906, 3), (1, 4), (4101, 3)])
def test_cuda_tick_at_serving_shapes_matches_plain(cuda, B, E):
    """The churn's batched mint (B ≈ 3,906 rows, 3 events of k = 4
    probes) and the replica's B = 1 tick of 4 events, at m = 256."""
    from repro_torch.core.hashing import bloom_indices
    rng = np.random.default_rng(19)
    cells = torch.as_tensor(rng.integers(0, 50, (B, SERVE_M)), dtype=torch.int32,
                            device=cuda)
    cells[0] = I32_MAX
    ev = rng.integers(0, 2 ** 32, (2, B, E), dtype=np.uint64).astype(np.int64)
    probes = bloom_indices(ev[0], ev[1], 4, SERVE_M, device=cuda)
    probes = probes.reshape(B, -1).to(torch.int32).contiguous()
    got = one_launch(lambda: ops.tick_probes(cells, probes), "bloom_tick")
    assert torch.equal(got, tick_plain(cells, probes))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 256, 4096, 16384, 65536])
@pytest.mark.parametrize("near_wrap", [False, True])
def test_cuda_one_vs_many_at_m256_matches_plain(cuda, n, near_wrap):
    """Packed one-vs-many at the serving width m = 256 (one m-tile of
    256 lanes): a pipeline batch, the hot tier, a cold chunk, the warm
    tier."""
    q, peers = query_and_peers(n, SERVE_M, 23, near_wrap)
    tq = torch.as_tensor(q, device=cuda)
    u8, base, _ = pack.pack_rows(torch.as_tensor(peers, device=cuda))
    bm = ops._one_vs_many_blocks(n, SERVE_M, None, None, "cuda")[1]
    flags, sums, fp = ref.one_vs_many_ref(tq, u8, base,
                                          bm=ops.tile_width(SERVE_M, bm))
    out = one_launch(lambda: ops._classify_vs_many_packed(tq, u8, base),
                     "one_vs_many_packed")
    assert torch.equal(out["q_le_p"], flags[:, 0])
    assert torch.equal(out["p_le_q"], flags[:, 1])
    assert torch.equal(out["sum_p"], sums[:, 1])
    assert_fp_close(out["fp_q_before_p"], fp[:, 0])
    assert_fp_close(out["fp_p_before_q"], fp[:, 1])


def serve_clock(rng, m, hi=6, base=0):
    from repro_torch.core import clock as bc
    cells = ((rng.integers(0, hi, m).astype(np.int64) + base)
             & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return bc.compress(bc.BloomClock(cells=torch.as_tensor(cells),
                                     base=torch.zeros((), dtype=torch.int32), k=3))


def serve_tiers(device, tmp_path, m=32):
    from repro_torch.serve import TierConfig, TieredRegistry
    return TieredRegistry(
        TierConfig(hot_capacity=6, warm_capacity=10, promote_after=2,
                   demote_batch=2, spill_batch=4, cold_batch=4,
                   spill_dir=str(tmp_path / str(device))),
        m=m, k=3, device=device)


def assert_tier_views_equal(g, c):
    assert g.sids == c.sids and g.tier == c.tier
    np.testing.assert_array_equal(g.status, c.status)
    np.testing.assert_array_equal(g.sums, c.sums)
    assert_fp_close(torch.as_tensor(g.fp), torch.as_tensor(c.fp))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_tiers_match_cpu(cuda, tmp_path, seed):
    """Interleaved admit / release / touch (near-wrap rows among them)
    on a card registry and a CPU one: the same tiers, verdicts, sums and
    stored clocks; fp within tolerance."""
    I = 2 ** 31 - 1
    tiers = {d: serve_tiers(d, tmp_path) for d in (cuda, "cpu")}
    g = np.random.default_rng(100 + seed)
    live = set()
    for _ in range(80):
        op = int(g.integers(0, 3))
        sid = f"s{int(g.integers(0, 40))}"
        if op == 0:
            base = I - int(g.integers(5, 60)) if g.integers(0, 4) == 0 else 0
            c = serve_clock(np.random.default_rng(int(g.integers(1 << 30))), 32,
                            base=base)
            for t in tiers.values():
                t.admit(sid, c)
            live.add(sid)
        elif sid in live:
            for t in tiers.values():
                (t.release if op == 1 else t.touch)(sid)
            if op == 1:
                live.discard(sid)
    gt, ct = tiers[cuda], tiers["cpu"]
    assert gt._tier_of == ct._tier_of and set(gt.sids()) == live
    assert gt._w_u8_t.is_pinned() and not ct._w_u8_t.is_pinned()
    q = serve_clock(g, 32, hi=10)
    assert_tier_views_equal(gt.classify(q), ct.classify(q))
    for sid in live:
        got = gt.get(sid, count=False)
        assert got.device.type == "cuda"
        assert torch.equal(got.logical_cells().cpu(),
                           ct.get(sid, count=False).logical_cells())
    for t in tiers.values():
        t.close()


@pytest.mark.gpu
def test_cuda_warm_write_after_nonblocking_classify(cuda, tmp_path):
    """A classify copies the pinned warm slab to the card without
    blocking, queued behind a sleeping card; admits straight after it
    demote rows into the same warm slots.  The classify must see the
    rows before the write, the next one the rows after it."""
    tiers = {d: serve_tiers(d, tmp_path) for d in (cuda, "cpu")}
    rng = np.random.default_rng(5)
    first = {f"s{i}": serve_clock(rng, 32) for i in range(14)}
    more = {f"n{i}": serve_clock(rng, 32, hi=20) for i in range(8)}
    q = serve_clock(rng, 32, hi=12)
    views = {}
    for d, t in tiers.items():
        t.admit_many(first)
        if d == cuda:
            torch.cuda._sleep(50_000_000)
        views[d] = [t.classify(q)]
        t.admit_many(more)
        views[d].append(t.classify(q))
    assert tiers[cuda].demotions > len(first) - 6
    for g, c in zip(views[cuda], views["cpu"]):
        assert_tier_views_equal(g, c)
    for t in tiers.values():
        t.close()


@pytest.mark.gpu
def test_cuda_pipeline_matches_cpu(cuda, tmp_path):
    """The admission pipeline on the card and on the CPU, fed the same
    admits (related, forked, wide and near-wrap rows) and queries: the
    same verdicts and admissions, fp within tolerance, the same stored
    clocks."""
    from repro_torch.causal import CausalPolicy
    from repro_torch.core import clock as bc
    from repro_torch.core import wire
    from repro_torch.serve import (AdmissionPipeline, PipelineConfig,
                                   TierConfig, TieredRegistry)
    m = SERVE_M

    def chain(n, salt=0, device="cpu"):
        c = bc.zeros(m, 4, device=device)
        for i in range(n):
            c = bc.tick(c, np.uint32(salt), np.uint32(i + 1))
        return c

    rng = np.random.default_rng(8)
    frames = [wire.encode_clock(bc.to_wire(chain(int(rng.integers(1, 30)),
                                                 int(rng.integers(0, 2)))))
              for _ in range(300)]
    frames.append(wire.encode_clock({"cells": rng.integers(0, 900, m).astype(
        np.int32), "base": 0, "k": 4}))
    frames.append(wire.encode_clock({"cells": rng.integers(0, 5, m).astype(
        np.uint8), "base": I32_MAX - 10, "k": 4}))
    queried = rng.permutation(len(frames))[:200]
    out = {}
    for d in (cuda, "cpu"):
        tiers = TieredRegistry(TierConfig(hot_capacity=64, warm_capacity=128,
                                          spill_dir=str(tmp_path / str(d))),
                               m=m, k=4, policy=CausalPolicy(fp_threshold=1.0),
                               device=d)
        local = chain(24, device=d)
        pipe = AdmissionPipeline(tiers, lambda: local,
                                 PipelineConfig(batch_size=32))
        tickets = [pipe.submit(f"s{i}", frame=f) for i, f in enumerate(frames)]
        pipe.drain(timeout=300)
        tickets += [pipe.submit(f"s{i}", kind="query") for i in queried]
        pipe.drain(timeout=300)
        pipe.close()
        out[d] = ([t.result(1) for t in tickets],
                  {s: tiers.get(s, count=False).logical_cells().cpu()
                   for s in tiers.sids()})
        tiers.close()
    (gv, gs), (cv, cs) = out[cuda], out["cpu"]
    for g, c in zip(gv, cv):
        assert (g.sid, g.kind, g.verdict, g.admitted) == \
            (c.sid, c.kind, c.verdict, c.admitted)
        assert_fp_close(torch.tensor([g.fp]), torch.tensor([c.fp]))
    assert {v.verdict for v in gv} >= {"ancestor", "forked"}
    assert gs.keys() == cs.keys()
    for s in gs:
        assert torch.equal(gs[s], cs[s]), s


@pytest.mark.gpu
def test_cuda_quick_churn_matches_cpu(cuda):
    """The audited quick churn on the card and the CPU: the fields the
    seed fixes and every final stored clock identical."""
    from repro_torch.serve import ChurnConfig, run_churn
    stored = {}

    def keep(d):
        def inspect(tiers, replica):
            stored[d] = {s: tiers.get(s, count=False).logical_cells().cpu()
                         for s in tiers.sids()}
        return inspect

    n0 = ops.LAUNCHES["bloom_tick"]
    r = {d: run_churn(ChurnConfig.quick(sessions=1200, steps=6), device=d,
                      inspect=keep(d))
         for d in (cuda, "cpu")}
    assert ops.LAUNCHES["bloom_tick"] >= n0 + 12
    for key in ("sessions", "admitted", "rejected", "queries", "migrations",
                "expiries", "fn_violations", "concurrent_seen", "measured_fp"):
        assert getattr(r[cuda], key) == getattr(r["cpu"], key), key
    for rep in r.values():
        assert rep.fn_violations == 0 and not rep.replay["mismatches"]
    assert stored[cuda].keys() == stored["cpu"].keys()
    for s in stored["cpu"]:
        assert torch.equal(stored[cuda][s], stored["cpu"][s]), s


# ---------------------------------------------------------------------------
# the autotuner's model and the committed table
# ---------------------------------------------------------------------------

def _instance_specs(family):
    """The kernel instances of one family, as (spec, rect-i32's 4-byte
    staging)."""
    from repro_torch.kernels import template as tp
    tiles = [(bi, bj) for bi in tp.PAIR_TILES for bj in tp.PAIR_TILES
             if bi * bj <= tp.PAIR_MAX_PAIRS]
    if family == "tri":
        return [(tp.CompareSpec(topology="tri", bi=b, bj=b), False)
                for b in tp.TRI_TILES]
    if family == "rect_u8":
        return [(tp.CompareSpec(topology="rect", bi=bi, bj=bj), False)
                for bi, bj in tiles]
    if family.startswith("rect_i32"):
        return [(tp.CompareSpec(topology="rect", pack="i32", bi=bi, bj=bj,
                                with_stats=True), family.endswith("scalar"))
                for bi, bj in tiles]
    if family.startswith("mxu"):
        T = 64 if family == "mxu" else ops.MXU_T_MAX + 1
        return [(tp.CompareSpec(topology="mxu", bi=bi, bj=bj, with_base=True,
                                n_thresholds=T), False) for bi, bj in tiles]
    pack_ = "u8" if family == "one_vs_many_packed" else "i32"
    return [(tp.CompareSpec(topology="one_vs_many", pack=pack_, bi=bn, m=m,
                            with_base=pack_ == "u8", with_stats=True), False)
            for m in (1024, 256, 1000, 7) for bn in range(1, 33)]


_FAMILIES = ["tri", "rect_u8", "rect_i32", "rect_i32_scalar", "mxu", "mxu_wide",
             "one_vs_many_packed", "one_vs_many_i32"]


@pytest.mark.gpu
@pytest.mark.parametrize("family", _FAMILIES)
def test_cuda_occupancy_model_matches_runtime(cuda, family):
    """``template.ctas_per_sm`` at the built registers equals
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` for every instance."""
    from repro_torch.kernels import template as tp
    for spec, scalar in _instance_specs(family):
        a = tp.c_attrs(spec, scalar)
        assert a["threads"] == tp.threads_of(spec) <= a["max_threads"]
        assert tp.ctas_per_sm(a["threads"], a["regs"], a["smem"],
                              a["static_smem"]) == a["ctas"] > 0, (spec, a)
    if family == "rect_i32":
        a = tp.row_sums_attrs()
        assert tp.ctas_per_sm(a["threads"], a["regs"], a["smem"],
                              a["static_smem"]) == a["ctas"] > 0, a


@pytest.mark.gpu
@pytest.mark.parametrize("family", _FAMILIES)
def test_cuda_smem_estimate_matches_library(cuda, family):
    """The Python copy of each library's shared-memory arithmetic equals
    the library's export, and the launch's dynamic shared memory."""
    from repro_torch.kernels import template as tp
    for spec, scalar in _instance_specs(family):
        want = tp.c_attrs(spec, scalar)["smem"]
        assert tp.smem_python(spec) == tp.smem_estimate(spec, "cuda") == want
        tp.validate(spec, "cuda")


def _table_entries():
    from repro_torch.kernels import autotune
    return sorted((k, v) for k, v in autotune.load_table().items()
                  if "|cuda|" in k)


def _rows_case(rng, n, m):
    q = rng.integers(0, 200, m)
    kind = rng.integers(0, 4, (n, 1))
    d = np.abs(rng.integers(-1, 2, (n, m)) * (rng.random((n, m)) < 0.05))
    res = np.where(kind == 0, q, np.where(kind == 1, q + d, np.where(
        kind == 2, q - d, rng.integers(0, 256, (n, m)))))
    base = np.where(rng.random(n) < 0.25,
                    rng.integers(-2 ** 31, 2 ** 31 - 256, n), 5000)
    return (torch.as_tensor(q + 5000, dtype=torch.int32),
            torch.as_tensor(np.clip(res, 0, 255), dtype=torch.uint8),
            torch.as_tensor(base, dtype=torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("key,cfg", _table_entries())
def test_cuda_tuned_blocks_match_plain(cuda, key, cfg):
    """Each committed table entry's blocks, on its op at its shape
    bucket (rows capped at 16,384; all-pairs at 1,024): flags identical
    to the plain version at the same blocks and to the default blocks,
    sums identical to the plain version (and, at equal bm, sums and fp
    bit-identical to the default blocks), fp within tolerance.  A sharded
    entry runs its strategy at its blocks over its shard count of the
    one card: flags identical to the plain tri and to the ring at the
    default blocks."""
    op, _, n_b, h_b, m_b, s_b = key.split("|")
    m = int(m_b[1:])
    rng = np.random.default_rng(31)
    if op == "matrix_sharded":
        from repro_torch.launch.mesh import make_fleet_mesh

        u8, base = packed_slab(1024, m, 31, _FAR)
        want = ref.tri_flags_ref(u8, base)
        mesh = make_fleet_mesh(int(s_b[1:]), device=cuda)
        got = ring_on(mesh, u8.numpy(), base.numpy(),
                      strategy=cfg["strategy"], bi=cfg["bi"], bj=cfg["bj"],
                      bm=cfg["bm"])
        dflt = ring_on(mesh, u8.numpy(), base.numpy(), strategy="ring")
        for i, key_ in enumerate(("a_le_b", "b_le_a")):
            assert torch.equal(got[key_].cpu(), want[i])
            assert torch.equal(got[key_], dflt[key_])
        return
    if op in ("one_vs_many", "hybrid"):
        n = min(int(n_b[1:]), 16384)
        bn, bm = cfg["bn"], cfg["bm"]
        q, u8, base = (t.to(cuda) for t in _rows_case(rng, n, m))
        if op == "one_vs_many":
            def run(bn, bm):
                return ops._classify_vs_many_packed(q, u8, base, bn=bn, bm=bm,
                                                    use_autotune=False)
            plain = ref.one_vs_many_ref(q, u8, base, bm=ops.tile_width(m, bm))
        else:
            H = min(int(h_b[1:]), n // 2)
            meta = torch.as_tensor(np.stack([rng.integers(0, 40, H),
                                             rng.integers(0, 3, H)], 1),
                                   dtype=torch.int32, device=cuda)
            hs = (4.0 * meta.sum(1)).to(torch.float32)

            def run(bn, bm):
                return ops._classify_hybrid(q, 20, meta, hs, u8[H:], base[H:],
                                            bn=bn, bm=bm, use_autotune=False)
            plain = ref.hybrid_classify_ref(q, 20, meta, hs, u8[H:], base[H:],
                                            bm=ops.tile_width(m, bm))
        got, dflt = run(bn, bm), run(*ops.OVM_BLOCKS)
        flags, sums, fp = plain
        assert torch.equal(got["q_le_p"], flags[:, 0])
        assert torch.equal(got["p_le_q"], flags[:, 1])
        assert torch.equal(got["sum_p"], sums[:, 1])
        assert_fp_close(got["fp_q_before_p"], fp[:, 0])
        assert_fp_close(got["fp_p_before_q"], fp[:, 1])
        assert torch.equal(got["q_le_p"], dflt["q_le_p"])
        assert torch.equal(got["p_le_q"], dflt["p_le_q"])
        if ops.tile_width(m, bm) == ops.tile_width(m, ops.OVM_BLOCKS[1]):
            for k in ("sum_p", "fp_q_before_p", "fp_p_before_q"):
                assert torch.equal(got[k].view(torch.int32),
                                   dflt[k].view(torch.int32)), k
        return
    n = 1024
    engine, bi, bj, bm = cfg["engine"], cfg["bi"], cfg["bj"], cfg["bm"]
    dbi, dbj, dbm = ops.MATRIX_BLOCKS
    if engine == "i32":
        rows = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (n, m)),
                               dtype=torch.int32, device=cuda)
        cs = ref.wrap_sum_i32(rows).to(torch.float32)
        got = ops.rect_i32_stats(rows, rows, cs, bi=bi, bj=bj, bm=bm)
        want = ref.rect_i32_stats_ref(rows, rows, cs, bm=ops.tile_width(m, bm))
        dflt = ops.rect_i32_stats(rows, rows, cs, bi=dbi, bj=dbj, bm=dbm)
        for i in range(3):
            assert torch.equal(got[i], want[i])
        assert_fp_close(got[3], want[3])
        assert torch.equal(got[0], dflt[0]) and torch.equal(got[1], dflt[1])
        return
    u8, base = packed_slab(n, m, 31, _FAR)
    u8, base = u8.to(cuda), base.to(cuda)
    if engine == "tri":
        got = ops.tri_flags(u8, base, bt=bi)
        want = ref.tri_flags_ref(u8, base)
        dflt = ops.tri_flags(u8, base, bt=dbi)
    else:
        lo, T = 1000, 64
        got = (ops.mxu_viol(u8, u8, base, base, lo=lo, n_thresholds=T, bi=bi,
                            bj=bj),)
        want = (ref.mxu_viol_ref(u8, u8, base, base, lo=lo, n_thresholds=T),)
        dflt = (ops.mxu_viol(u8, u8, base, base, lo=lo, n_thresholds=T,
                             bi=dbi, bj=dbj),)
    for g, w, d in zip(got, want, dflt):
        assert torch.equal(g, w) and torch.equal(g, d)


# ---------------------------------------------------------------------------
# the mesh-sharded registry, every shard on the one card
# ---------------------------------------------------------------------------

def sharded_fleet(device, shards, n=512, m=1024, seed=5, evict=True,
                  distinct=False):
    """A registry of ``n`` peers around a query (4 of them promoted), on
    one device or over ``shards`` shards of it (``distinct``: over the
    first ``shards`` cards instead); ~1 in 16 evicted."""
    from repro_torch.core import clock as bc
    from repro_torch.fleet import ClockRegistry
    from repro_torch.launch.mesh import make_fleet_mesh

    q, peers = query_and_peers(n, m, seed)
    peers = peers.astype(np.int64)
    peers[1:5, 3] += 400                                  # span > 255
    if shards is None:
        mesh = None
    elif distinct:
        mesh = make_fleet_mesh(shards)
    else:
        mesh = make_fleet_mesh(shards, device=device)
    reg = ClockRegistry(n, m, 4, mesh=mesh, device=device)
    zero = torch.zeros((), dtype=torch.int32)
    reg.admit_many({i: bc.BloomClock(torch.as_tensor(as_i32(r)), zero, 4)
                    for i, r in enumerate(peers)})
    if evict:
        reg.evict_many(list(range(7, n, 16)))
    return bc.BloomClock(torch.as_tensor(q), zero, 4), reg


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_cuda_sharded_classify_matches_unsharded(cuda, shards):
    """classify_all over s shards on the card: statuses, sums and fp
    bits identical to the unsharded card registry, s packed launches
    and one for the promoted rows."""
    local, ref = sharded_fleet(cuda, None)
    want = ref.classify_all(local)
    _, reg = sharded_fleet(cuda, shards)
    assert len(reg._wide) == 4
    ops.reset_launches()
    got = reg.classify_all(local)
    assert ops.LAUNCHES["one_vs_many_packed"] == shards
    assert ops.LAUNCHES["one_vs_many_i32"] == 1
    np.testing.assert_array_equal(got.status, want.status)
    assert (got.fp == want.fp).all() and (got.sums == want.sums).all()
    assert got.engine == "packed_sharded+wide_overlay"


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("evict", [False, True])
def test_cuda_sharded_all_pairs_matches_unsharded(cuda, shards, evict):
    """all_pairs over s shards of the card (the ring, 4 promoted rows
    patched in, dead slots masked on the card) bit-identical to the
    unsharded card registry."""
    _, ref = sharded_fleet(cuda, None, evict=evict)
    _, reg = sharded_fleet(cuda, shards, evict=evict)
    want, got = ref.all_pairs().to_host(), reg.all_pairs().to_host()
    assert want.engine == "tri+wide_rim"
    assert got.engine == "ring_full+wide_rim"
    for key in ("a_le_b", "b_le_a", "concurrent", "fp", "row_sums"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def ring_slab(n: int, m: int, seed: int):
    """u8 residuals and bases (0..7) of n rows around one template: many
    ordered pairs, many concurrent."""
    g = np.random.default_rng(seed)
    t = g.integers(10, 60, m)
    logical = (t + g.integers(0, 3, (n, 1))
               + g.integers(0, 2, (n, m)) * (g.random((n, m)) < 0.01))
    base = g.integers(0, 8, n)
    return ((logical - base[:, None]).astype(np.uint8),
            base.astype(np.int32))


def ring_on(mesh, cells: np.ndarray, base: np.ndarray, **kw) -> dict:
    from repro_torch.sharding import split_rows
    return ops._compare_matrix_packed_sharded(
        split_rows(torch.as_tensor(cells), mesh.devices),
        split_rows(torch.as_tensor(base), mesh.devices), mesh=mesh,
        uniform_base=False, **kw)


RING_KEYS = ("a_le_b", "b_le_a", "concurrent", "fp", "row_sums")


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_cuda_ring_matches_cpu_ring_and_tri(cuda, shards):
    """The all-pairs ring over s shards of the card: d tri and d(d - 1)/2
    rect-u8 launches; every field bit-identical to the unsharded card
    tri and to the "replicated" strategy; flags and sums identical to
    the CPU ring, fp within tolerance."""
    from repro_torch.launch.mesh import make_fleet_mesh

    cells, base = ring_slab(1536, 1024, shards)
    ops.reset_launches()
    got = ring_on(make_fleet_mesh(shards, device=cuda), cells, base,
                  strategy="ring")
    assert ops.LAUNCHES["matrix_tri"] == shards
    assert ops.LAUNCHES["matrix_rect_u8"] == shards * (shards - 1) // 2
    assert ops.LAST_DISPATCH["engine"] == "ring_full"
    on_cpu = ring_on(make_fleet_mesh(shards, device="cpu"), cells, base,
                     strategy="ring")
    one = ops._compare_matrix_packed(torch.as_tensor(cells, device=cuda),
                                     torch.as_tensor(base, device=cuda),
                                     engine="tri", uniform_base=False)
    rep = ring_on(make_fleet_mesh(shards, device=cuda), cells, base,
                  strategy="replicated")
    assert got["a_le_b"].any() and got["concurrent"].any()
    for key in RING_KEYS:
        assert torch.equal(got[key], one[key]), key
        assert torch.equal(got[key], rep[key]), key
        if key != "fp":
            assert torch.equal(got[key].cpu(), on_cpu[key]), key
    assert_fp_close(got["fp"], on_cpu["fp"])


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
def test_cuda_mesh_transport_matches_loopback(cuda, shards):
    """A mesh-transport session over s shards of the card: masks, fp
    bits, merged cells and push-back bytes equal the unsharded loopback
    round's; the digests are the slab's sums."""
    from repro_torch.fleet import GossipConfig, MeshCollectiveTransport
    from repro_torch.fleet import anti_entropy_session, gossip_round

    local, ref = sharded_fleet(cuda, None)
    _, reg = sharded_fleet(cuda, shards)
    _, wr = gossip_round(ref, local, GossipConfig())
    tp = MeshCollectiveTransport(reg)
    digests, nbytes = tp.digests()
    assert nbytes == 9 * reg.capacity * (shards - 1) // shards
    sums = reg.sums.cpu().numpy()
    assert len(digests) == len(reg)
    for pid, d in digests.items():
        assert d.clock_sum == float(sums[reg.slot_of(pid)])
    _, gr = anti_entropy_session(reg, local, tp, GossipConfig())
    assert gr.transport == "mesh" and gr.digest_bytes == nbytes
    for key in ("accepted", "quarantined", "stragglers", "unconfident"):
        np.testing.assert_array_equal(getattr(gr, key), getattr(wr, key))
    assert (gr.view.fp == wr.view.fp).all()
    assert gr.pushback_bytes == wr.pushback_bytes
    for name in ("cells_u8", "base", "sums", "alive"):
        assert torch.equal(getattr(reg, name).cpu(), getattr(ref, name).cpu())


@pytest.mark.gpu
def test_cuda_wrappers_refuse_a_query_on_another_device(cuda):
    """The kernel reads every pointer on the peers' card: ``_check``
    refuses an operand on another card than the one its kernel runs on
    (checked on one card against a named second device), and every
    wrapper refuses an operand left on the CPU before the launch."""
    q, peers = query_and_peers(64, 256, 3)
    p = torch.as_tensor(peers, device=cuda)
    here = p.device
    there = torch.device("cuda", here.index + 1)
    ops._check(p, "peers", torch.int32, (64, 256), here)
    with pytest.raises(ValueError, match="runs on"):
        ops._check(p, "peers", torch.int32, (64, 256), there)
    q_cpu = torch.as_tensor(q)
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops._classify_vs_many(q_cpu, p)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.merge_compare(p[:2].contiguous(), torch.as_tensor(peers[:2]))
    u8 = torch.zeros((64, 256), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops._classify_vs_many_packed(q_cpu.to(cuda), u8,
                                     torch.zeros(64, dtype=torch.int32))
    assert sum(ops.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# the mesh-sharded registry over distinct cards (a host with several)
# ---------------------------------------------------------------------------

def need_cards(n: int) -> None:
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices, found "
                    f"{torch.cuda.device_count()}")


@pytest.mark.gpu
def test_cuda_wrapper_refuses_a_query_on_another_card(cuda):
    """A query on the first card beside a shard on the second is
    refused before the launch, not read as a foreign pointer."""
    need_cards(2)
    q, peers = query_and_peers(64, 256, 3)
    u8 = torch.zeros((64, 256), dtype=torch.uint8, device="cuda:1")
    base = torch.zeros(64, dtype=torch.int32, device="cuda:1")
    ops.reset_launches()
    with pytest.raises(ValueError, match="runs on"):
        ops._classify_vs_many_packed(torch.as_tensor(q, device="cuda:0"),
                                     u8, base)
    assert sum(ops.LAUNCHES.values()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
def test_cuda_sharded_on_distinct_cards_matches_unsharded(cuda, shards):
    """Shards on distinct cards: each shard's rows, its launch and its
    query copy live on its own card; classify_all, all-pairs and one
    loopback gossip round are bit-identical to the unsharded registry
    on the first card."""
    from repro_torch.fleet import GossipConfig, gossip_round

    need_cards(shards)
    local, ref = sharded_fleet(cuda, None)
    _, reg = sharded_fleet(cuda, shards, distinct=True)
    assert [sh.cells_u8.device.index for sh in reg.shards] == \
        list(range(shards))
    want = ref.classify_all(local)
    ops.reset_launches()
    got = reg.classify_all(local)
    assert ops.LAUNCHES["one_vs_many_packed"] == shards
    np.testing.assert_array_equal(got.status, want.status)
    assert (got.fp == want.fp).all() and (got.sums == want.sums).all()
    wp, gp = ref.all_pairs().to_host(), reg.all_pairs().to_host()
    assert gp.engine == "ring_full+wide_rim"
    for key in ("a_le_b", "b_le_a", "concurrent", "fp", "row_sums"):
        np.testing.assert_array_equal(gp[key], wp[key], err_msg=key)
    _, wr = gossip_round(ref, local, GossipConfig())
    _, gr = gossip_round(reg, local, GossipConfig())
    assert gr.shards == shards
    for key in ("accepted", "quarantined", "stragglers", "unconfident"):
        np.testing.assert_array_equal(getattr(gr, key), getattr(wr, key))
    assert gr.pushback_bytes == wr.pushback_bytes
    for name in ("cells_u8", "base", "sums", "alive"):
        assert torch.equal(getattr(reg, name).cpu(), getattr(ref, name).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
def test_cuda_ring_on_distinct_cards_matches_tri(cuda, shards):
    """The all-pairs ring over distinct cards (the copies between cards
    on side streams, the mirrors shipped, the block-rows gathered onto
    the first card): bit-identical to the first card's unsharded tri
    and to the "replicated" strategy, with the ring's launch counts."""
    from repro_torch.launch.mesh import make_fleet_mesh

    need_cards(shards)
    mesh = make_fleet_mesh(shards)
    cells, base = ring_slab(1536, 1024, 10 + shards)
    ops.reset_launches()
    got = ring_on(mesh, cells, base, strategy="ring")
    assert ops.LAUNCHES["matrix_tri"] == shards
    assert ops.LAUNCHES["matrix_rect_u8"] == shards * (shards - 1) // 2
    one = ops._compare_matrix_packed(torch.as_tensor(cells, device=cuda),
                                     torch.as_tensor(base, device=cuda),
                                     engine="tri", uniform_base=False)
    rep = ring_on(mesh, cells, base, strategy="replicated")
    for key in RING_KEYS:
        assert got[key].device == one[key].device
        assert torch.equal(got[key], one[key]), key
        assert torch.equal(got[key], rep[key]), key


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
def test_cuda_mesh_transport_on_distinct_cards(cuda, shards):
    """The digest ring over distinct cards: digests equal the slab's,
    and the mesh session equals the unsharded loopback round."""
    from repro_torch.fleet import GossipConfig, MeshCollectiveTransport
    from repro_torch.fleet import anti_entropy_session, gossip_round

    need_cards(shards)
    local, ref = sharded_fleet(cuda, None)
    _, reg = sharded_fleet(cuda, shards, distinct=True)
    _, wr = gossip_round(ref, local, GossipConfig())
    tp = MeshCollectiveTransport(reg)
    digests, nbytes = tp.digests()
    sums, base = reg.sums.cpu().numpy(), reg.base.cpu().numpy()
    for pid, d in digests.items():
        slot = reg.slot_of(pid)
        assert (d.clock_sum, d.base) == (float(sums[slot]), int(base[slot]))
    _, gr = anti_entropy_session(reg, local, tp, GossipConfig())
    for key in ("accepted", "quarantined", "stragglers", "unconfident"):
        np.testing.assert_array_equal(getattr(gr, key), getattr(wr, key))
    assert (gr.view.fp == wr.view.fp).all()
    assert gr.pushback_bytes == wr.pushback_bytes and gr.digest_bytes == nbytes


def socket_rows(n: int, m: int, seed: int) -> dict:
    """n host clocks around a local row ``base``: ancestors, forks,
    descendants, and two rows past the int32 wrap in some cells."""
    g = np.random.default_rng(seed)
    local = g.integers(0, 6, m)
    rows = {}
    for i in range(n):
        if i < 2:
            rows[f"w{i}"] = I32_MAX - 50 + g.integers(0, 101, m)
        elif i % 3 == 0:
            rows[f"a{i}"] = local - (g.random(m) < 0.3) * (local > 0)
        elif i % 3 == 1:
            rows[f"d{i}"] = local + (g.random(m) < 0.05)
        else:
            rows[f"f{i}"] = local + (g.random(m) < 0.05) - (g.random(m) < 0.3) * (local > 0)
    return {"local": local, "rows": rows}


def socket_sessions(device, fleet: dict, rounds: int = 2) -> list:
    """``rounds`` sessions of a registry on ``device`` over
    ``SocketTransport`` against servers of the fleet's rows."""
    from repro_torch.core import clock as bc
    from repro_torch.fleet import ClockNode, ClockPeerServer, ClockRegistry
    from repro_torch.fleet import GossipConfig, SocketTransport
    from repro_torch.fleet import anti_entropy_session
    from repro_torch.fleet.transport.socket import stop_servers

    m = len(fleet["local"])
    nodes, servers = {}, []
    try:
        for pid, row in fleet["rows"].items():
            nodes[pid] = ClockNode(pid, m, 4)
            nodes[pid].set_cells(row)
            servers.append(ClockPeerServer(nodes[pid]).start())
        tp = SocketTransport({p: s.address for p, s in zip(nodes, servers)},
                             timeout=5.0)
        reg = ClockRegistry(len(nodes), m, 4, device=device)
        local = bc.BloomClock(
            cells=torch.as_tensor(fleet["local"].astype(np.int32),
                                  device=device),
            base=torch.zeros((), dtype=torch.int32, device=device), k=4)
        out = []
        for _ in range(rounds):
            local, rep = anti_entropy_session(reg, local, tp, GossipConfig())
            out.append({"masks": [getattr(rep, k) for k in (
                            "accepted", "quarantined", "stragglers",
                            "unconfident")],
                        "status": rep.view.status, "fp": rep.view.fp,
                        "merged": local.logical_cells().cpu().numpy(),
                        "rows": reg.cells.cpu().numpy(),
                        "bytes": (rep.digest_bytes, rep.delta_bytes,
                                  rep.pushback_bytes),
                        "have": dict(tp.have), "wide": sorted(reg._wide),
                        "held": {p: n.digest().crc for p, n in nodes.items()}})
        return out
    finally:
        stop_servers(servers)


@pytest.mark.gpu
def test_cuda_socket_session_matches_cpu(cuda):
    """Two delta-pull sessions over ``SocketTransport`` with the staging
    registry on the card and on the CPU: masks, statuses, merged cells,
    registry rows, promoted slots, wire bytes, ``have`` keys and what
    the servers hold identical, fp within tolerance; the card's runs
    the packed kernel and the i32 overlay of the near-wrap rows, and the
    second session pulls nothing."""
    fleet = socket_rows(48, 1024, 23)
    ops.reset_launches()
    got = socket_sessions(cuda, fleet)
    assert ops.LAUNCHES["one_vs_many_packed"] == 2
    assert ops.LAUNCHES["one_vs_many_i32"] == 2
    want = socket_sessions("cpu", fleet)
    assert got[0]["bytes"][1] > 0 and got[1]["bytes"][1] == 0
    assert len(got[0]["wide"]) >= 2
    for g, w in zip(got, want):
        for a, b in zip(g["masks"], w["masks"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g["status"], w["status"])
        assert_fp_close(torch.as_tensor(g["fp"]), torch.as_tensor(w["fp"]))
        for key in ("merged", "rows"):
            np.testing.assert_array_equal(g[key], w[key])
        for key in ("bytes", "have", "wide", "held"):
            assert g[key] == w[key], key


@pytest.mark.gpu
def test_cuda_chaos_sim_matches_cpu(cuda):
    """The hostile socket fleet (the chaos smoke's mix, a corrupted row)
    with the observer's registry on the card and on the CPU: fn == 0,
    converged, repaired, and the same result fields and audited fault
    schedule."""
    import dataclasses

    from repro_torch.causal import CausalPolicy
    from repro_torch.core.sim import SimConfig, run_gossip_sim
    from repro_torch.fleet import GossipConfig
    from repro_torch.fleet.chaos import smoke_chaos
    from repro_torch.obs import AuditTrail, Observer

    res, trails = {}, {}
    for dev in (cuda, "cpu"):
        obs = Observer(audit=AuditTrail())
        res[str(dev)] = run_gossip_sim(
            SimConfig(n_nodes=5, n_events=150, m=64, k=3, seed=7),
            n_rounds=6,
            gossip_cfg=GossipConfig(policy=CausalPolicy(fp_threshold=1.0),
                                    straggler_gap=np.inf, observer=obs,
                                    merge_forked=True),
            transport="socket", chaos=smoke_chaos(), corrupt_at=(3, 1),
            device=dev)
        trails[str(dev)] = [(r.peer_id, r.action, r.detail)
                            for r in obs.audit.chaos_events()]
    g, c = res[str(cuda)], res["cpu"]
    assert g.false_negatives == 0 and g.converged and g.repaired >= 1
    assert trails[str(cuda)] == trails["cpu"] and trails["cpu"]
    dg, dc = dataclasses.asdict(g), dataclasses.asdict(c)
    fp_g, fp_c = dg.pop("mean_predicted_fp"), dc.pop("mean_predicted_fp")
    assert dg == dc
    assert abs(fp_g - fp_c) <= FP_RTOL * max(abs(fp_c), FP_FLOOR)


@pytest.mark.gpu
def test_cuda_ticked_prefix_matches_cpu(cuda):
    """The launcher's leader ticks on the card and its children on the
    CPU: the same event prefix gives identical integer cells, which the
    children's prefix property rests on."""
    from repro_torch.launch.peers import _ticked_clock

    got = _ticked_clock(1024, 4, 300, cuda)
    want = _ticked_clock(1024, 4, 300, "cpu")
    assert got.cells.device.type == "cuda"
    assert torch.equal(got.logical_cells().cpu(), want.logical_cells())


# ---------------------------------------------------------------------------
# model serving (repro_torch.serving, repro_torch.launch.serve)
# ---------------------------------------------------------------------------

def serving_run(device, params, cfg):
    """A smoke-config engine on ``device``: admit, decode, and migrate
    two sessions to a second replica (one adoptable, one from after
    its merge)."""
    from repro_torch.core import clock as bc
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.serving import ServeConfig, ServingEngine

    c_cfg = ClockConfig(m=256, fp_threshold=1.0 - 1e-6)
    a = ServingEngine(params, cfg, ServeConfig(max_seq=48), c_cfg,
                      replica_id="A", device=device)
    b = ServingEngine(params, cfg, ServeConfig(max_seq=48), c_cfg,
                      replica_id="B", device=device)
    rng = np.random.default_rng(31)
    s1 = a.admit(torch.as_tensor(rng.integers(0, cfg.vocab, (3, 9))))
    toks = [a.generate(s1, 6).cpu()]
    b.clock.tick("own", 1)
    b.clock.clock = bc.merge(b.clock.clock, a.clock.clock)
    s2 = a.admit(torch.as_tensor(rng.integers(0, cfg.vocab, (3, 5))))
    toks.append(a.generate(s2, 4).cpu())
    lineage = b.can_adopt(s1)
    mask = b.adopt_many([s1, s2])
    return {"tokens": toks, "mask": mask, "lineage": lineage,
            "logits": s2["last_logits"].float().cpu(),
            "clocks": [c.logical_cells().cpu().numpy() for c in (
                a.clock.clock, b.clock.clock, s1["clock"].clock,
                s2["clock"].clock)],
            "rows": {name: getattr(a.sessions, name).cpu().numpy()
                     for name in ("cells_u8", "base", "sums", "alive")}}


@pytest.mark.gpu
def test_cuda_serving_engine_matches_cpu(cuda):
    """The qwen smoke config in float32 on the card and on the CPU, on
    the same weights: greedy tokens, engine and session clocks, registry
    rows and the adoption mask identical, logits within 1e-4; the tick,
    merge-compare and i32 one-vs-many kernels launched on the card."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_smoke_config("qwen1_5_0_5b"), dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ops.reset_launches()
    got = serving_run(cuda, params, cfg)
    launched = {k: ops.LAUNCHES[k] for k in ("bloom_tick", "bloom_merge_compare",
                                             "one_vs_many_i32")}
    assert launched == {"bloom_tick": 17, "bloom_merge_compare": 1,
                        "one_vs_many_i32": 1}, launched
    want = serving_run("cpu", params, cfg)
    for g, w in zip(got["tokens"], want["tokens"]):
        assert torch.equal(g, w)
    assert list(got["mask"]) == list(want["mask"]) == [True, False]
    assert got["lineage"][:2] == want["lineage"][:2] == (True, "ancestor")
    for g, w in zip(got["clocks"], want["clocks"]):
        np.testing.assert_array_equal(g, w)
    for name, g in got["rows"].items():
        np.testing.assert_array_equal(g, want["rows"][name], err_msg=name)
    torch.testing.assert_close(got["logits"], want["logits"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_cuda_serve_launcher_smoke_exits_zero(cuda):
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--tiered", "--hybrid"],
        env={**os.environ, "PYTHONPATH": src}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "on cuda: prefill 4x32" in proc.stdout
    assert "[serve] tiered admission: same" in proc.stdout


# ---------------------------------------------------------------------------
# training (repro_torch.runtime.training, checkpoint, async_trainer,
# launch.train)
# ---------------------------------------------------------------------------

def smoke_frames(cfg, batch: int, seed: int = 5):
    """An enc-dec config's encoder input [batch, enc_seq, d_model]."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32))


def train_run(device, state, cfg, n_steps: int = 3, seq: int = 32):
    """``n_steps`` of the port's train step from ``state`` (copied to
    ``device``) on the smoke data stream (``seq`` tokens a row; an
    enc-dec config's batches with seeded frames)."""
    from repro_torch.checkpoint.manager import _leaves, _rebuild
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import make_train_step

    state = _rebuild(state, lambda key, t: t.to(device))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=8))
    step = make_train_step(cfg, OptConfig(lr=1e-3, total_steps=10),
                           ClockConfig(m=64))
    metrics = []
    for s in range(n_steps):
        batch = data.batch(s, device=device)
        batch["ev_hi"], batch["ev_lo"] = data.event_id(s)
        if cfg.is_encdec:
            batch["enc_frames"] = smoke_frames(cfg, 8, 100 + s).to(device)
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return _rebuild(state, lambda key, t: t.cpu()), metrics, dict(_leaves(state))


def smoke_train_state(state_dtype="float32", arch="qwen1_5_0_5b", **kw):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import init_train_state

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             OptConfig(total_steps=10, state_dtype=state_dtype),
                             ClockConfig(m=64), device="cpu")
    return cfg, state


@pytest.mark.gpu
def test_cuda_train_step_matches_cpu(cuda):
    """Three float32 steps of the qwen smoke config on the card and the
    CPU from one state: exactly one tick launch a step (nothing else
    launches), clock cells and steps identical, loss and grad norm
    within rtol 2e-4, params within rtol 2e-4 / atol 2e-5 (the
    reference's own microbatch tolerance)."""
    cfg, state = smoke_train_state()
    ops.reset_launches()
    got, gm, _ = train_run(cuda, state, cfg)
    launched = {k: n for k, n in ops.LAUNCHES.items() if n}
    assert launched == {"bloom_tick": 3}, launched
    want, wm, _ = train_run("cpu", state, cfg)
    for g, w in zip(gm, wm):
        assert g["clock_sum"] == w["clock_sum"] and g["lr"] == w["lr"]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=2e-4)
    assert torch.equal(got.clock_cells, want.clock_cells)
    assert int(got.step) == int(want.step) == 3
    for k in want.params:
        np.testing.assert_allclose(got.params[k].numpy(), want.params[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.gpu
def test_cuda_checkpoint_restores_on_cpu(cuda, tmp_path):
    """An int8-moment state on the card, saved asynchronously (one host
    snapshot), restored on the CPU and back on the card: every leaf
    identical; the manifest's clock, decoded on the CPU by the static
    ``clock_from_snapshot``, admitted by a card runtime as by a CPU
    one, with one merge-compare launch."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _leaves, _rebuild
    from repro_torch.runtime.clock_runtime import ClockConfig, ClockRuntime

    _, state = smoke_train_state("int8")
    on_card = _rebuild(state, lambda key, t: t.to(cuda))
    rt = ClockRuntime(ClockConfig(m=64), device=cuda)
    for s in range(5):
        rt.tick_step(s)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, on_card, rt.snapshot())
    mgr.wait()
    back, manifest = mgr.restore(target_structure=state, device="cpu")
    again, _ = mgr.restore(target_structure=state)
    for (key, a), (_, b), (_, c) in zip(_leaves(state), _leaves(back),
                                        _leaves(again)):
        assert b.device.type == "cpu" and c.device.type == "cuda", key
        assert torch.equal(a, b) and torch.equal(a, c.cpu()), key
    clock = ClockRuntime.clock_from_snapshot(manifest["clock"])
    assert clock.cells.device.type == "cpu"
    card_rt = ClockRuntime(ClockConfig(m=64), device=cuda)
    ops.reset_launches()
    got = card_rt.admit_restore(clock)
    assert ops.LAUNCHES["bloom_merge_compare"] == 1
    want = ClockRuntime(ClockConfig(m=64), device="cpu").admit_restore(clock)
    assert got[:2] == want[:2] == (True, "descendant")
    assert_fp_close(torch.tensor([got[2]]), torch.tensor([want[2]]))


def async_run(device, params, cfg):
    """The forked-pod sequence of the reference's async tests on
    ``device``: 3 pods, 2 local SGD steps, two rounds; pod 2 restored
    from its pre-commit clock before round 2."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.runtime.async_trainer import (AsyncConfig,
                                                   AsyncCoordinator,
                                                   run_pod_round)
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import cross_entropy

    def sgd_step(p, batch):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        logits, _ = T.forward_train(leaves, cfg, batch["tokens"])
        loss = cross_entropy(logits, batch["labels"], cfg.vocab)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return ({k: w.detach() - 2e-3 * g
                 for (k, w), g in zip(leaves.items(), grads)}, loss.detach())

    a_cfg = AsyncConfig(n_pods=3, local_steps=2, outer_lr=0.5)
    c_cfg = ClockConfig(m=256, fp_threshold=1.0 - 1e-6, straggler_gap=1e9)
    coord = AsyncCoordinator(params, a_cfg, c_cfg, device=device)
    pods = coord.add_pods([0, 1, 2], c_cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))

    def data_fn(pod_id, step):
        return data.batch(step * 10 + pod_id, device=device)

    decisions, stale = [], None
    for rnd, base in enumerate((0, 50)):
        deltas = {}
        for pod in pods:
            deltas[pod.pod_id], _ = run_pod_round(pod, sgd_step, data_fn,
                                                  a_cfg, base)
            if pod.pod_id == 2 and rnd == 0:
                stale = pod.clock.clock
        decisions.append(coord.outer_step(pods, deltas))
        if rnd == 0:
            pods[2].clock.clock = stale
    rows = {name: getattr(coord.registry, name).cpu().numpy()
            for name in ("cells_u8", "base", "sums", "alive")}
    return decisions, rows, coord.clock.clock.logical_cells().cpu().numpy()


@pytest.mark.gpu
def test_cuda_async_coordinator_matches_cpu(cuda):
    """The async coordinator on the card and the CPU from the same
    params: decisions and statuses identical (pod 2 forked in round 2),
    fp within 5e-2, registry rows and the coordinator clock identical;
    packed one-vs-many and the tick launched on the card."""
    cfg, state = smoke_train_state()
    ops.reset_launches()
    got = async_run(cuda, state.params, cfg)
    assert ops.LAUNCHES["one_vs_many_packed"] == 2
    assert ops.LAUNCHES["bloom_tick"] > 0
    want = async_run("cpu", state.params, cfg)
    for dg, dw in zip(got[0], want[0]):
        assert {p: d[:2] for p, d in dg.items()} == {p: d[:2] for p, d in dw.items()}
        assert_fp_close(torch.tensor([d[2] for d in dg.values()]),
                        torch.tensor([d[2] for d in dw.values()]))
    assert got[0][1][2][:2] == (False, "forked")
    assert got[0][1][0][0] and got[0][1][1][0]
    for name, rows in got[1].items():
        np.testing.assert_array_equal(rows, want[1][name], err_msg=name)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.gpu
def test_cuda_train_launcher_restart_exits_zero(cuda, tmp_path):
    """``python -m repro_torch.launch.train --smoke`` on the card with a
    checkpoint every 4 steps and a failure injected at step 8: exit 0,
    step 8 restored as a descendant and admitted."""
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "12", "--batch", "4", "--seq", "32", "--ckpt-every", "4",
         "--inject-failure", "8", "--ckpt-dir", str(tmp_path / "ckpt")],
        env={**os.environ, "PYTHONPATH": src}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("[train] restore step=8 lineage=descendant fp=1.00e+00 "
            "admitted=True") in proc.stdout
    assert "[train] done: 4 steps" in proc.stdout


# ---------------------------------------------------------------------------
# the MoE family (repro_torch.models.moe, models.mla)
# ---------------------------------------------------------------------------

MOE_ARCHS = ("grok_1_314b", "deepseek_v2_236b")


def moe_smoke(arch, **kw):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    return cfg, init_params(torch.Generator().manual_seed(0), cfg, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("replicas,cap", [(1, 1.25), (2, 0.5)])
def test_cuda_moe_ffn_and_mla_block_match_cpu(cuda, replicas, cap):
    """DeepSeek's smoke layer 0 in float32 on the card and the CPU:
    ``moe_ffn`` (with drops at capacity 0.5, replicas 2) output and aux
    within rtol 1e-4 / atol 1e-5, the expert ids identical; ``mla_block``
    prefill output and latents, then 3 absorbed decode steps against the
    latent cache, within the same tolerance."""
    from repro_torch.models import layers as L
    from repro_torch.models import mla, moe
    from repro_torch.models import transformer as T

    cfg, params = moe_smoke("deepseek_v2_236b", moe_replicas=replicas,
                            capacity_factor=cap)
    lp = T.layer_params(params, cfg, 0)
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator().manual_seed(3))
    tol = dict(rtol=1e-4, atol=1e-5)
    p_moe = L.sub(lp, "moe")
    y, aux = moe.moe_ffn(p_moe, cfg, x)
    yc, auxc = moe.moe_ffn({k: v.to(cuda) for k, v in p_moe.items()}, cfg,
                           x.to(cuda))
    torch.testing.assert_close(yc.cpu(), y, **tol)
    torch.testing.assert_close(auxc.cpu(), aux, **tol)
    x2d = x.reshape(24, -1)
    ids = moe._top_k_gates(x2d @ p_moe["router"], cfg.top_k)[1]
    idc = moe._top_k_gates(x2d.to(cuda) @ p_moe["router"].to(cuda), cfg.top_k)[1]
    assert torch.equal(idc.cpu(), ids)

    p_att = L.sub(lp, "attn")
    p_card = {k: v.to(cuda) for k, v in p_att.items()}
    pos = torch.arange(8)
    out, (ckv, kr) = mla.mla_block(p_att, cfg, x[:, :8], positions=pos)
    outc, (ckvc, krc) = mla.mla_block(p_card, cfg, x[:, :8].to(cuda),
                                      positions=pos.to(cuda))
    for a, b in ((outc, out), (ckvc, ckv), (krc, kr)):
        torch.testing.assert_close(a.cpu(), b, **tol)
    caches = []
    for dev, (c0, k0) in (("cpu", (ckv, kr)), (cuda, (ckvc, krc))):
        c = mla.init_mla_cache(cfg, 2, 12, device=dev)
        c.ckv[:, :8], c.krope[:, :8] = c0, k0
        caches.append(mla.MLACache(c.ckv, c.krope, length=8, pos=8))
    for t in range(8, 11):
        o, caches[0] = mla.mla_block(p_att, cfg, x[:, t:t + 1],
                                     positions=torch.tensor([t]), cache=caches[0])
        oc, caches[1] = mla.mla_block(p_card, cfg, x[:, t:t + 1].to(cuda),
                                      positions=torch.tensor([t], device=cuda),
                                      cache=caches[1])
        torch.testing.assert_close(oc.cpu(), o, **tol)
    torch.testing.assert_close(caches[1].ckv.cpu(), caches[0].ckv, **tol)
    assert (caches[1].length, caches[1].pos) == (11, 11)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cuda_moe_serving_engine_matches_cpu(cuda, arch):
    """Each ``moe`` smoke config in float32 served on the card and the
    CPU from the same weights (admit, generate, migrate): greedy tokens,
    clocks, registry rows and the adoption mask identical, logits within
    1e-4; tick, merge-compare and i32 one-vs-many launched on the card."""
    cfg, params = moe_smoke(arch)
    ops.reset_launches()
    got = serving_run(cuda, params, cfg)
    launched = {k: ops.LAUNCHES[k] for k in ("bloom_tick", "bloom_merge_compare",
                                             "one_vs_many_i32")}
    assert launched == {"bloom_tick": 17, "bloom_merge_compare": 1,
                        "one_vs_many_i32": 1}, launched
    want = serving_run("cpu", params, cfg)
    for g, w in zip(got["tokens"], want["tokens"]):
        assert torch.equal(g, w)
    assert list(got["mask"]) == list(want["mask"]) == [True, False]
    for g, w in zip(got["clocks"], want["clocks"]):
        np.testing.assert_array_equal(g, w)
    for name, g in got["rows"].items():
        np.testing.assert_array_equal(g, want["rows"][name], err_msg=name)
    torch.testing.assert_close(got["logits"], want["logits"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_cuda_moe_train_step_matches_cpu(cuda):
    """Three float32 steps of DeepSeek's smoke config (MLA, MoE with a
    shared expert, the router's aux in the loss) on the card and the
    CPU from one state: one tick launch a step, clock cells identical,
    loss, aux and grad norm within rtol 2e-4, params within rtol 2e-4 /
    atol 2e-5."""
    cfg, state = smoke_train_state(arch="deepseek_v2_236b")
    ops.reset_launches()
    got, gm, _ = train_run(cuda, state, cfg)
    launched = {k: n for k, n in ops.LAUNCHES.items() if n}
    assert launched == {"bloom_tick": 3}, launched
    want, wm, _ = train_run("cpu", state, cfg)
    for g, w in zip(gm, wm):
        assert g["clock_sum"] == w["clock_sum"] and g["aux"] > 0
        for key in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=2e-4)
    assert torch.equal(got.clock_cells, want.clock_cells)
    for k in want.params:
        np.testing.assert_allclose(got.params[k].numpy(), want.params[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.gpu
def test_cuda_serve_launcher_deepseek_smoke_exits_zero(cuda):
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "deepseek_v2_236b", "--smoke"],
        env={**os.environ, "PYTHONPATH": src}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[serve] deepseek-smoke on cuda: prefill 4x32" in proc.stdout
    assert "[serve] engine clock sum: 80" in proc.stdout


# ---------------------------------------------------------------------------
# the SSM and hybrid families (repro_torch.models.ssm)
# ---------------------------------------------------------------------------

SSM_ARCHS = ("mamba2_130m", "hymba_1_5b")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_cuda_ssm_forward_prefill_decode_match_cpu(cuda, arch):
    """Each smoke config in float32 on the card and the CPU from the same
    weights: forward_train logits, prefill logits and caches, 4 decode
    steps and the caches after them (the SSM caches written in place)
    within rtol 1e-4 / atol 1e-4."""
    from repro_torch.models import transformer as T

    cfg, params = moe_smoke(arch)
    tok = torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab, (2, 12)))
    tol = dict(rtol=1e-4, atol=1e-4)
    runs = []
    for dev in ("cpu", cuda):
        model = T.build(params, cfg, dev)
        logits, _ = T.forward_train(model, cfg, tok)
        pre, caches = T.prefill(model, cfg, tok[:, :8], buf_len=16)
        steps = [pre]
        for t in range(8, 12):
            lo, caches = T.decode_step(model, cfg, caches, tok[:, t], t)
            steps.append(lo)
        runs.append((logits, steps, caches))
    (lc, sc, cc), (lg, sg, cg) = runs
    torch.testing.assert_close(lg.cpu(), lc, **tol)
    for g, c in zip(sg, sc):
        torch.testing.assert_close(g.cpu(), c, **tol)
    assert sorted(cg) == sorted(cc)
    torch.testing.assert_close(cg["ssm"].state.cpu(), cc["ssm"].state, **tol)
    torch.testing.assert_close(cg["ssm"].conv.cpu(), cc["ssm"].conv, **tol)
    if "attn" in cc:
        torch.testing.assert_close(cg["attn"].k.cpu(), cc["attn"].k, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_cuda_ssm_serving_engine_matches_cpu(cuda, arch):
    """Each smoke config in float32 served on the card and the CPU
    (admit, generate, migrate): greedy tokens, clocks, registry rows and
    the adoption mask identical, logits within 1e-4; tick, merge-compare
    and i32 one-vs-many launched on the card."""
    cfg, params = moe_smoke(arch)
    ops.reset_launches()
    got = serving_run(cuda, params, cfg)
    launched = {k: ops.LAUNCHES[k] for k in ("bloom_tick", "bloom_merge_compare",
                                             "one_vs_many_i32")}
    assert launched == {"bloom_tick": 17, "bloom_merge_compare": 1,
                        "one_vs_many_i32": 1}, launched
    want = serving_run("cpu", params, cfg)
    for g, w in zip(got["tokens"], want["tokens"]):
        assert torch.equal(g, w)
    assert list(got["mask"]) == list(want["mask"]) == [True, False]
    for g, w in zip(got["clocks"], want["clocks"]):
        np.testing.assert_array_equal(g, w)
    for name, g in got["rows"].items():
        np.testing.assert_array_equal(g, want["rows"][name], err_msg=name)
    torch.testing.assert_close(got["logits"], want["logits"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_cuda_ssm_train_step_at_chunk_128_matches_cpu(cuda, arch):
    """Two float32 steps of each smoke config at the full configs' chunk
    (Q = 128, seq 128, where the reference's SSD gradient overflows) on
    the card and the CPU from one state: one tick launch a step, losses
    and grad norms finite and within rtol 2e-4, clock cells identical,
    params within rtol 2e-4 / atol 2e-5."""
    cfg, state = smoke_train_state(arch=arch, ssm_chunk=128)
    ops.reset_launches()
    got, gm, _ = train_run(cuda, state, cfg, n_steps=2, seq=128)
    launched = {k: n for k, n in ops.LAUNCHES.items() if n}
    assert launched == {"bloom_tick": 2}, launched
    want, wm, _ = train_run("cpu", state, cfg, n_steps=2, seq=128)
    for g, w in zip(gm, wm):
        assert np.isfinite(g["loss"]) and np.isfinite(g["grad_norm"])
        assert g["clock_sum"] == w["clock_sum"]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=2e-4)
    assert torch.equal(got.clock_cells, want.clock_cells)
    for k in want.params:
        assert bool(got.params[k].isfinite().all()), k
        np.testing.assert_allclose(got.params[k].numpy(), want.params[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the enc-dec family (repro_torch.models.transformer's Encoder, CrossCache)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_encdec_prefill_decode_match_cpu(cuda):
    """Whisper's smoke config in float32 on the card and the CPU from the
    same weights and frames: the encoder's output, forward_train logits,
    prefill logits and its self and cross caches, 4 decode steps and the
    caches after them within rtol 1e-4 / atol 1e-4; decode leaves the
    cross cache as prefill wrote it."""
    from repro_torch.models import transformer as T

    cfg, params = moe_smoke("whisper_large_v3")
    tok = torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab, (2, 12)))
    fr = smoke_frames(cfg, 2)
    tol = dict(rtol=1e-4, atol=1e-4)
    runs = []
    for dev in ("cpu", cuda):
        model = T.build(params, cfg, dev)
        enc = T.encode(model, cfg, fr)
        logits, _ = T.forward_train(model, cfg, tok, enc_frames=fr)
        pre, caches = T.prefill(model, cfg, tok[:, :8], enc_frames=fr,
                                buf_len=16)
        cross = caches["cross"].k.clone()
        steps = [pre]
        for t in range(8, 12):
            lo, caches = T.decode_step(model, cfg, caches, tok[:, t], t)
            steps.append(lo)
        assert torch.equal(caches["cross"].k, cross)
        runs.append((enc, logits, steps, caches))
    (ec, lc, sc, cc), (eg, lg, sg, cg) = runs
    torch.testing.assert_close(eg.cpu(), ec, **tol)
    torch.testing.assert_close(lg.cpu(), lc, **tol)
    for g, c in zip(sg, sc):
        torch.testing.assert_close(g.cpu(), c, **tol)
    assert sorted(cg) == sorted(cc) == ["attn", "cross"]
    for key, name in (("cross", "k"), ("cross", "v"), ("attn", "k"),
                      ("attn", "v")):
        torch.testing.assert_close(getattr(cg[key], name).cpu(),
                                   getattr(cc[key], name), **tol)


@pytest.mark.gpu
def test_cuda_encdec_train_step_matches_cpu(cuda):
    """Two float32 steps of whisper's smoke config, frames in every
    batch, on the card and the CPU from one state: one tick launch a
    step, losses and grad norms within rtol 2e-4, clock cells identical,
    params within rtol 2e-4 / atol 2e-5."""
    cfg, state = smoke_train_state(arch="whisper_large_v3")
    ops.reset_launches()
    got, gm, _ = train_run(cuda, state, cfg, n_steps=2)
    launched = {k: n for k, n in ops.LAUNCHES.items() if n}
    assert launched == {"bloom_tick": 2}, launched
    want, wm, _ = train_run("cpu", state, cfg, n_steps=2)
    for g, w in zip(gm, wm):
        assert g["clock_sum"] == w["clock_sum"]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=2e-4)
    assert torch.equal(got.clock_cells, want.clock_cells)
    for k in want.params:
        np.testing.assert_allclose(got.params[k].numpy(), want.params[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the model mesh (DTensor) on NCCL groups, each in its own processes
# ---------------------------------------------------------------------------

#: the smoke configs of the one-rank NCCL mesh: dense, MoE with MLA, SSM
MESH_ARCHS = ["qwen1_5_0_5b", "deepseek_v2_236b", "mamba2_130m"]


@pytest.mark.gpu
def test_cuda_one_rank_nccl_mesh_matches_plain(cuda, tmp_path):
    """A one-rank NCCL group in a subprocess and the (1, 1) mesh on the
    card: prefill, four greedy decode steps and one train step of three
    smoke configs with DTensor parameters bit-identical to the plain
    port on the same card (``test_torch_model_mesh_ranks``'s worker; no
    op differs)."""
    import test_torch_model_mesh_ranks as R

    job = R.Job(str(tmp_path / "one.json"), 1, mode="one", backend="nccl",
                mesh=[1, 1], archs=MESH_ARCHS)
    res = job.result()
    for arch in MESH_ARCHS:
        differ = {k: v for k, v in res[arch].items() if v != 0.0}
        assert differ == R.REWRITTEN.get(arch, {}), (arch, differ)


@pytest.mark.gpu
def test_cuda_four_card_nccl_2x2_mesh_within_tolerance(cuda, tmp_path):
    """Four ranks, one card each, a 2x2 (data, model) NCCL mesh: the
    forward of the dense and the MoE smoke configs within the bfloat16
    tolerance of the plain port on each card, one train step's loss and
    grad norm within 2e-2, its params within the AdamW bound and its
    moments within ``MOMENT_RTOL``; ``adamw_update`` alone on sharded
    float32 and int8 moments within ``ADAMW_RTOL``
    (``test_torch_model_mesh_ranks.check_four_rank``); the dense run's
    checkpoint round trip.  Skips with fewer than four cards."""
    import test_torch_model_mesh_ranks as R

    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 CUDA devices, has {torch.cuda.device_count()}")
    for arch in R.FOUR_RANK_ARCHS:
        npz = str(tmp_path / f"{arch}.npz")
        R.port_inputs(arch, npz)
        ckpt = str(tmp_path / "ckpt") if arch == R.FOUR_RANK_ARCHS[0] else ""
        res = R.Job(str(tmp_path / f"{arch}.json"), 4, mode="four",
                    backend="nccl", mesh=[2, 2], archs=[arch], npz=npz,
                    ckpt=ckpt).result()
        R.check_four_rank(arch, res)
        if ckpt:
            assert res["round_trip"] == [True, True]
