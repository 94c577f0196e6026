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
