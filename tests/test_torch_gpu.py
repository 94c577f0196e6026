"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here carries the ``gpu`` marker and skips without a
CUDA device (decided in a fixture, never at import time).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: cells, flags, merged rows and float32 sums identical (same
bm tiling, integer tile sums, float adds in tile order); Eq. 3 fp within
a relative 5e-2 (libm ulps), values at or below the 1e-30 clip floor
counted as equal, and infinities (wrapped negative sums) equal to
themselves.
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


def query_and_peers(n, m, seed, near_wrap=False):
    rng = np.random.default_rng(seed)
    q = rng.integers(100, 300, m)
    if near_wrap:
        q = I32_MAX - rng.integers(0, 60, m)
    step = rng.integers(-2, 3, (n, 1))
    noise = rng.integers(-1, 2, (n, m)) * (rng.random((n, m)) < 0.02)
    peers = q + step + noise
    peers[: n // 4] = q
    return as_i32(q), as_i32(peers)


@pytest.mark.gpu
@pytest.mark.parametrize("m,dtype", [(1024, torch.int32), (1000, torch.int32),
                                     (1024, torch.int16)])
def test_cuda_tick_matches_plain(cuda, m, dtype):
    rng = np.random.default_rng(7)
    cells = torch.as_tensor(rng.integers(0, 100, (256, m)), dtype=dtype,
                            device=cuda)
    cells[0] = torch.iinfo(dtype).max
    probes = torch.as_tensor(rng.integers(0, m, (256, 64)), dtype=torch.int32,
                             device=cuda)
    n0 = ops.LAUNCHES["bloom_tick"]
    got = ops.tick_probes(cells, probes)
    assert ops.LAUNCHES["bloom_tick"] == n0 + 1
    assert torch.equal(got, ref.bloom_tick_ref(cells, probes))


@pytest.mark.gpu
@pytest.mark.parametrize("m,near_wrap", [(1024, False), (1000, False),
                                         (640, True)])
def test_cuda_merge_compare_matches_plain(cuda, m, near_wrap):
    rng = np.random.default_rng(8)
    a = rng.integers(0, 40, (300, m))
    if near_wrap:
        a = I32_MAX - a
    b = np.minimum(a + rng.integers(0, 2, a.shape) * (rng.random((300, 1)) < 0.5),
                   I32_MAX)
    b[::3] = a[::3] - rng.integers(0, 2, (100, m))
    ta = torch.as_tensor(as_i32(a), device=cuda)
    tb = torch.as_tensor(as_i32(b), device=cuda)
    n0 = ops.LAUNCHES["bloom_merge_compare"]
    got = ops.merge_compare(ta, tb)
    assert ops.LAUNCHES["bloom_merge_compare"] == n0 + 1
    merged, flags, sums, fp = ref.bloom_merge_compare_ref(
        ta, tb, bm=ops.tile_width(m, 512))
    assert torch.equal(got["merged"], merged)
    assert torch.equal(got["a_le_b"], flags[:, 0].bool())
    assert torch.equal(got["b_le_a"], flags[:, 1].bool())
    assert torch.equal(got["sum_a"], sums[:, 0])
    assert torch.equal(got["sum_b"], sums[:, 1])
    assert_fp_close(got["fp_a_before_b"], fp[:, 0])
    assert_fp_close(got["fp_b_before_a"], fp[:, 1])


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,near_wrap", [(300, 1024, False), (77, 1000, True),
                                           (65, 1008, True), (9, 520, False)])
def test_cuda_one_vs_many_matches_plain(cuda, n, m, near_wrap):
    q, peers = query_and_peers(n, m, 9, near_wrap)
    tq = torch.as_tensor(q, device=cuda)
    tp = torch.as_tensor(peers, device=cuda)
    u8, base, _ = pack.pack_rows(tp)
    bm = ops.tile_width(m, 512)
    for name, got, (flags, sums, fp) in (
            ("one_vs_many_i32", lambda: ops._classify_vs_many(tq, tp),
             ref.one_vs_many_ref(tq, tp, bm=bm)),
            ("one_vs_many_packed",
             lambda: ops._classify_vs_many_packed(tq, u8, base),
             ref.one_vs_many_ref(tq, u8, base, bm=bm))):
        n0 = ops.LAUNCHES[name]
        out = got()
        assert ops.LAUNCHES[name] == n0 + 1
        assert torch.equal(out["q_le_p"], flags[:, 0].bool()), name
        assert torch.equal(out["p_le_q"], flags[:, 1].bool()), name
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
        reports = [rt.gossip(reg) for _ in range(3)]
        return view, reports, rt.clock.logical_cells().cpu(), reg

    gv, grep_, gclock, greg = run(cuda)
    cv, crep, cclock, creg = run("cpu")
    np.testing.assert_array_equal(gv.status, cv.status)
    np.testing.assert_array_equal(np.asarray(gv.sums), np.asarray(cv.sums))
    for g, c in zip(grep_, crep):
        np.testing.assert_array_equal(g.accepted, c.accepted)
        np.testing.assert_array_equal(g.quarantined, c.quarantined)
        assert g.pushback_bytes == c.pushback_bytes
    assert torch.equal(gclock, cclock)
    assert torch.equal(greg.cells_u8.cpu(), creg.cells_u8)
    assert torch.equal(greg.base.cpu(), creg.base)
