"""The port's autotuner (``repro_torch.kernels.autotune``) and the spec
surface of ``repro_torch.kernels.template`` on the CPU, beside the JAX
package's (``repro.kernels.autotune``, Pallas in interpret mode).

Pins: the table key, load/save and its fallbacks, ``prune`` against the
reference's, the Hopper cost model's shared-memory busts and occupancy
at hand-checked points, a measured CPU sweep, every dispatch resolving
explicit argument > table (under ``policy.autotune``) > built-in blocks
and reaching the kernel wrappers with the table's blocks, the tiers'
pin at hot + warm, the spans and counters, and the CLI.

Tolerances, JAX against the port at the same blocks: flags identical,
float32 sums identical at equal bm (integer tile sums added as float in
tile order), Eq. 3 fp within a relative 5e-2 (ROADMAP §3), values below
the 1e-30 clip floor counted as equal.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import autotune as jtune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pack as jpack  # noqa: E402
from repro_torch.causal import CausalEngine, CausalPolicy, PackedSlab  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import template as tp  # noqa: E402

FP_RTOL = 5e-2
FP_FLOOR = 1e-30
CPU = torch.device("cpu")


def plant(monkeypatch, tmp_path, table: dict):
    path = tmp_path / "table.json"
    path.write_text(json.dumps(table))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", str(path))
    return path


def assert_fp_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    tiny = (np.abs(a) <= FP_FLOOR) & (np.abs(b) <= FP_FLOOR)
    np.testing.assert_allclose(np.where(tiny, 0.0, a), np.where(tiny, 0.0, b),
                               rtol=FP_RTOL, atol=0)


def query_and_peers(n, m, seed, span=200):
    rng = np.random.default_rng(seed)
    q = rng.integers(100, 100 + span, m)
    peers = q + rng.integers(-2, 3, (n, 1)) \
        + rng.integers(-1, 2, (n, m)) * (rng.random((n, m)) < 0.05)
    peers[: n // 4] = q
    return q.astype(np.int32), peers.astype(np.int32)


# ---------------------------------------------------------------------------
# keys and the table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,N,M,m,shards", [
    ("matrix", 300, 300, 300, 1), ("one_vs_many", 65536, 65536, 1024, 1),
    ("hybrid", 69628, 4089, 1024, 1), ("matrix", 16384, 16384, 1024, 2),
    ("one_vs_many", 1, 1, 7, 1), ("matrix_sharded", 513, 513, 129, 4)])
def test_key_for_buckets_match_reference(op, N, M, m, shards):
    want = jtune.key_for(op, N, M, m, True, shards=shards)
    for backend in ("cuda", "cpu"):
        got = autotune.key_for(op, N, M, m, backend, shards=shards)
        assert got.replace(f"|{backend}|", "|interpret|") == want
    assert autotune.key_for(op, N, M, m, "cuda").endswith("|s1")


def test_table_roundtrip_and_bucketed_lookup(tmp_path, monkeypatch):
    path = tmp_path / "table.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", str(path))
    key = autotune.key_for("matrix", 1000, 1000, 1000, "cuda")
    cfg = {"engine": "tri", "bi": 32, "bj": 32, "bm": 512}
    assert autotune.save_table({key: cfg}) == path
    assert json.loads(path.read_text()) == {key: cfg}
    assert autotune.lookup("matrix", 700, 700, 600, "cuda") == cfg
    assert autotune.lookup("matrix", 700, 700, 600, "cpu") is None
    assert autotune.lookup("matrix", 2000, 2000, 600, "cuda") is None


def test_table_miss_falls_back_to_builtin_blocks(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE",
                       str(tmp_path / "missing.json"))
    assert autotune.load_table() == {}
    before = dict(autotune.CACHE_STATS)
    assert ops._one_vs_many_blocks(64, 256, None, None, "cuda") == (8, 512)
    assert ops._hybrid_blocks(64, 8, 256, None, None, "cpu") == (8, 512)
    assert ops._matrix_blocks("tri", 64, 64, 256, None, None, None,
                              "cuda") == (64, 64, 512)
    assert autotune.CACHE_STATS["miss"] - before["miss"] == 3
    q, peers = query_and_peers(16, 256, 1)
    got = CausalEngine().pairs(torch.as_tensor(peers))
    assert got.engine == "tri" and dict(got.blocks) == {"bi": 64, "bj": 64,
                                                        "bm": 512}


def test_corrupt_table_reads_as_empty(tmp_path, monkeypatch):
    path = tmp_path / "corrupt.json"
    path.write_text('{"matrix|cuda|N16|M16|m128|s1": {"engine": "tr')
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", str(path))
    assert autotune.load_table() == {}
    assert autotune.lookup("matrix", 16, 16, 128, "cuda") is None
    q, peers = query_and_peers(12, 128, 2)
    res = CausalEngine().pairs(torch.as_tensor(peers))
    le = np.all(peers[:, None, :] <= peers[None, :, :], axis=2)
    np.testing.assert_array_equal(res.le.numpy(), le)


def test_shipped_table_holds_only_cuda_keys():
    """The committed table is the card's: a CPU run resolves no entry,
    so every CPU path keeps the built-in blocks.  Its sharded entries
    name a strategy, at more than one shard, with blocks the ring
    takes."""
    import pathlib
    path = pathlib.Path(autotune.__file__).with_name("autotune_table.json")
    table = json.loads(path.read_text())
    assert table and all(k.split("|")[1] == "cuda" for k in table)
    for key, cfg in table.items():
        op = key.split("|")[0]
        assert op in ("matrix", "matrix_sharded", "one_vs_many", "hybrid")
        assert cfg["us"] > 0
        if op == "matrix_sharded":
            assert cfg["strategy"] in ("ring", "replicated")
            assert int(key.split("|s")[-1]) > 1
            spec = autotune._matrix_spec("full", cfg["bi"], cfg["bj"],
                                         cfg["bm"])
        elif op == "matrix":
            spec = autotune._matrix_spec(cfg["engine"], cfg["bi"], cfg["bj"],
                                         cfg["bm"], 64)
        else:
            spec = autotune._rows_spec(op, 1024, cfg["bn"], cfg["bm"])
        tp.validate(spec)


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_prune_keeps_the_reference_survivors(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 2, 5, 16, 40):
        cands = [("c", i) for i in range(n)]
        pred = list(rng.random(n) * 10)
        for i in rng.choice(n, n // 3, replace=False):
            pred[i] = math.inf
        pred[int(rng.integers(0, n))] = pred[0]        # a tie
        before = dict(autotune.SEARCH_STATS)
        assert autotune.prune(cands, pred) == jtune.prune(cands, pred)
        kept = autotune.prune(cands, pred)
        assert len(kept) <= max(1, min(n // 2, 8))
        assert autotune.SEARCH_STATS["candidates"] - before["candidates"] == 2 * n


def test_smem_busts_predict_infinite():
    # a CTA of 32 warps staging a 49,152-cell int32 query: 196,608 B of
    # query and 32 rings of 2,048 B
    spec = tp.CompareSpec(topology="one_vs_many", pack="i32", bi=32, m=49152,
                          with_stats=True)
    assert tp.smem_python(spec) > tp.SMEM_BUDGET["cuda"]
    tp.validate(spec, "cpu")                 # the CPU has no such limit
    assert not autotune._fits(spec, "cuda") and autotune._fits(spec, "cpu")
    assert autotune.predict_one_vs_many_cost(
        1024, 49152, 32, 512, "cuda", packed=False, regs=40) == math.inf
    assert autotune.predict_one_vs_many_cost(
        1024, 49152, 4, 512, "cuda", packed=False, regs=40) < math.inf
    assert autotune.predict_hybrid_cost(
        1024, 64, 65536, 32, 512, "cuda", regs=40) == math.inf
    # tiles the kernels do not take are refused, not priced
    assert autotune.predict_cost("tri", 1024, 1024, 256, 128, 128, 512,
                                 "cuda", regs=80) == math.inf
    assert autotune.predict_cost("full", 1024, 1024, 256, 128, 128, 512,
                                 "cuda", regs=80) == math.inf
    assert autotune.predict_cost("tri", 1024, 1024, 256, 64, 64, 512,
                                 "cuda", regs=80) < math.inf
    # the CPU runs the plain versions: no shared-memory limit
    assert autotune.predict_one_vs_many_cost(
        1024, 49152, 32, 512, "cpu", packed=False) < math.inf


@pytest.mark.parametrize("threads,regs,smem,ctas", [
    (256, 80, 352 * 128, 3),        # rect-u8 / tri 64 x 64: 80 registers
    (256, 128, 544 * 128, 2),       # rect-i32 64 x 64, 512-thread bounds
    (256, 128, 288 * 128, 2),       # mxu 64 x 64, 512-thread bounds
    (512, 64, 544 * 192, 2),        # rect-i32 128 x 64 at 64 registers
    (64, 80, 352 * 64, 9),          # u16x2 32 x 32: 9 by shared memory
    (1024, 32, 4096 + 32 * 2048, 2),   # one-vs-many bn = 32 at m = 1024
    (128, 32, 4096 + 4 * 2048, 16),    # one-vs-many bn = 4: 16 by warps
    (128, 40, 4096 + 4 * 2048, 12),    # ... 12 by registers at 40
    (32, 16, 0, 32),                   # the CTA limit
    (1024, 255, 0, 0),                 # 255 registers x 1,024 threads
])
def test_occupancy_formula_at_hand_checked_points(threads, regs, smem, ctas):
    assert tp.ctas_per_sm(threads, regs, smem) == ctas


def test_smem_python_matches_the_launchers_arithmetic():
    # one_vs_many.cu: ovm_smem = ceil(m / vec) * vec * 4 + warps * 2048
    assert tp.smem_python(autotune._rows_spec("one_vs_many", 1000, 8, 512)) \
        == 63 * 16 * 4 + 8 * 2048
    assert tp.smem_python(autotune._rows_spec("hybrid", 1024, 32, 512)) \
        == 4096 + 32 * 2048
    assert tp.smem_python(autotune._rows_spec("one_vs_many", 7, 1, 512,
                                              "i32")) == 8 * 4 + 2048
    # bloom_matrix.cu: u16x2_smem_bytes, the rect-i32 launcher; bloom_mxu.cu
    assert tp.smem_python(autotune._matrix_spec("tri", 64, 64, 512)) == 45056
    assert tp.smem_python(autotune._matrix_spec("i32", 64, 128, 512)) \
        == 2 * 192 * 68 * 4
    assert tp.smem_python(autotune._matrix_spec("mxu", 32, 64, 512, 64)) \
        == 2 * 96 * 36 * 4
    assert tp.smem_python(autotune._matrix_spec("mxu", 32, 64, 512, 8192)) \
        == 96 * 68 * 4
    assert tp.threads_of(autotune._matrix_spec("full", 128, 64, 512)) == 512


@pytest.mark.parametrize("spec,msg", [
    (tp.CompareSpec(topology="tri", bi=128, bj=64), "square"),
    (tp.CompareSpec(topology="tri", bi=128, bj=128), "at most"),
    (tp.CompareSpec(topology="tri", bi=32, bj=64), "square"),
    (tp.CompareSpec(topology="rect", bi=128, bj=128), "at most"),
    (tp.CompareSpec(topology="rect", bi=8, bj=64), "one of"),
    (tp.CompareSpec(topology="one_vs_many", bi=33, with_stats=True), r"\[1, 32\]"),
    (tp.CompareSpec(topology="one_vs_many", bi=8, bm=100, with_stats=True), "lane"),
    (tp.CompareSpec(topology="rect", pipeline_depth=3), "double-buffered"),
    (tp.CompareSpec(topology="mxu", with_base=True), "n_thresholds"),
    (tp.CompareSpec(topology="hybrid", bi=8, with_stats=True), "bases"),
])
def test_validate_refuses_what_the_kernels_refuse(spec, msg):
    with pytest.raises(ValueError, match=msg):
        tp.validate(spec)


def test_engine_specs_are_the_ports_defaults():
    for name, spec in tp.ENGINE_SPECS.items():
        tp.validate(spec, "cpu")
    assert (tp.ENGINE_SPECS["one_vs_many_packed"].bi,
            tp.ENGINE_SPECS["one_vs_many_packed"].bm) == ops.OVM_BLOCKS
    m = tp.ENGINE_SPECS["matrix_tri"]
    assert (m.bi, m.bj, m.bm) == ops.MATRIX_BLOCKS
    assert tp.ENGINE_SPECS["matrix_mxu"].acc_dtype == torch.float32
    assert tp.ENGINE_SPECS["matrix_i32_stats"].acc_dtype == torch.int32


def test_hopper_model_ranks_occupancy_and_tiles():
    """The card's model prefers more resident warps and fewer tile closes:
    rect-u8 at 3 CTAs an SM beats the same tile at 1, tri 64 beats tri 32
    (half the CTAs, the same pairs), and wider m-tiles rank first."""
    kw = dict(N=16384, M=16384, m=1024, bm=512, backend="cuda")
    fast = autotune.predict_cost("full", bi=64, bj=64, regs=80, **kw)
    slow = autotune.predict_cost("full", bi=64, bj=64, regs=255, **kw)
    assert fast < slow < math.inf
    assert autotune.predict_cost("tri", bi=64, bj=64, regs=80, **kw) < \
        autotune.predict_cost("tri", bi=32, bj=32, regs=80, **kw)
    p = {bm: autotune.predict_one_vs_many_cost(65536, 1024, 8, bm, "cuda",
                                               regs=40)
         for bm in (128, 256, 512, 1024)}
    assert p[1024] < p[512] < p[256] < p[128]
    # fewer, wider CTAs stage the query fewer times an SM
    p = [autotune.predict_hybrid_cost(69628, 4089, 1024, bn, 1024, "cuda",
                                      regs=40) for bn in (32, 16, 8, 4)]
    assert p == sorted(p) and p[0] < p[-1]


def test_cpu_model_is_the_reference_interpret_model():
    for args in (("tri", 1024, 1024, 1024, 64, 64, 512),
                 ("i32", 256, 256, 512, 32, 128, 256),
                 ("mxu", 512, 512, 256, 64, 64, 512)):
        t = args[0]
        got = autotune.predict_cost(*args, "cpu",
                                    n_thresholds=32 if t == "mxu" else 0)
        c = jtune._MODEL["interpret"]
        N, M, m, bi, bj, bm = args[1:]
        gi, gj, gm = -(-N // bi), -(-M // bj), -(-m // bm)
        steps = (gi * (gi + 1) // 2 if t == "tri" else gi * gj) * gm
        if t == "mxu":
            want = steps * c["step_overhead"] + steps * (
                (bi + bj) * bm * 32 * c["elem"]
                + 2 * bi * bj * bm * 32 * c["mxu_flop"]
                / (min(bi, 128) * min(bj, 128) / 128 ** 2))
        else:
            want = steps * c["step_overhead"] + steps * bi * bj * bm * (
                2 if t == "i32" else 1) * c["elem"]
        assert got == pytest.approx(want)
    assert autotune.predict_hybrid_cost(4096, 512, 1024, 8, 512, "cpu") == \
        pytest.approx(jtune.predict_hybrid_cost(4096, 512, 1024, 8, 512, True))


# ---------------------------------------------------------------------------
# measured sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["matrix", "one_vs_many", "hybrid"])
def test_measured_cpu_sweep_returns_a_valid_config(op, tmp_path, monkeypatch):
    plant(monkeypatch, tmp_path, {})
    before = dict(autotune.SEARCH_STATS)
    exp = {}
    if op == "matrix":
        best = autotune.autotune_matrix(48, 256, span=10, device="cpu",
                                        explain=exp)
        assert best["engine"] in ("tri", "i32", "mxu")
        tp.validate(autotune._matrix_spec(best["engine"], best["bi"],
                                          best["bj"], best["bm"], 10))
    elif op == "one_vs_many":
        best = autotune.autotune_one_vs_many(40, 256, device="cpu", explain=exp)
        assert best["engine"] == "packed" and best["bn"] in autotune.BNS
        assert ops.tile_width(256, best["bm"]) == best["bm"]
    else:
        best = autotune.autotune_hybrid(64, 256, hot=9, device="cpu",
                                        explain=exp)
        assert best["engine"] == "hybrid" and best["bn"] in autotune.BNS
    assert best["us"] > 0
    assert exp["survivors"] <= max(1, min(exp["grid"] // 2, 8))
    # the survivors, and the built-in blocks beside them if pruned
    assert exp["survivors"] <= len(exp["measured"]) <= exp["survivors"] + 1
    assert exp["default"] in [{k: v for k, v in r.items() if k != "us"}
                              for r in exp["measured"]]
    assert autotune.SEARCH_STATS["candidates"] - before["candidates"] == exp["grid"]
    assert autotune.SEARCH_STATS["measured"] - before["measured"] == \
        len(exp["measured"])
    preds = [p["pred_us"] for p in exp["predicted"]]
    assert preds == sorted(preds)
    assert 1 <= exp["winner_rank"] <= exp["grid"] and exp["default_us"] > 0


# ---------------------------------------------------------------------------
# dispatch through the table
# ---------------------------------------------------------------------------

def spy(monkeypatch, name, calls):
    orig = getattr(ops, name)

    def wrapped(*args, **kw):
        calls.append((name, kw))
        return orig(*args, **kw)
    monkeypatch.setattr(ops, name, wrapped)


def test_one_vs_many_and_hybrid_dispatch_from_table(tmp_path, monkeypatch):
    n, m, H = 40, 256, 6
    plant(monkeypatch, tmp_path, {
        autotune.key_for("one_vs_many", n, n, m, "cpu"):
            {"engine": "packed", "bn": 4, "bm": 128, "us": 1.0},
        autotune.key_for("hybrid", H + n, H, m, "cpu"):
            {"engine": "hybrid", "bn": 16, "bm": 128, "us": 1.0},
    })
    calls = []
    spy(monkeypatch, "_one_vs_many", calls)
    spy(monkeypatch, "hybrid", calls)
    q, peers = query_and_peers(n, m, 5)
    u8, base, _ = jpack.pack_rows(jnp.asarray(peers))
    tq, tu8, tb = (torch.as_tensor(np.array(x)) for x in (q, u8, base))
    ops._classify_vs_many_packed(tq, tu8, tb)
    assert ops.LAST_DISPATCH == {"op": "one_vs_many", "engine": "packed",
                                 "bn": 4, "bm": 128}
    ops._classify_vs_many_packed(tq, tu8, tb, bm=512)    # explicit wins
    assert ops.LAST_DISPATCH["bm"] == 512 and ops.LAST_DISPATCH["bn"] == 4
    ops._classify_vs_many_packed(tq, tu8, tb, use_autotune=False)
    assert ops.LAST_DISPATCH["bn"] == 8 and ops.LAST_DISPATCH["bm"] == 512
    assert [c[0] for c in calls] == ["_one_vs_many"] * 3
    meta = torch.tensor([[3, 0]] * H, dtype=torch.int32)
    hs = torch.full((H,), 12.0)
    ops._classify_hybrid(tq, 3, meta, hs, tu8, tb)
    assert calls[-1] == ("hybrid", {"bn": 16, "bm": 128})
    assert ops.LAST_DISPATCH["bn"] == 16
    # the engine threads the policy's switch
    res = CausalEngine(CausalPolicy(autotune=False)).classify(
        tq, PackedSlab(tu8, tb))
    assert dict(res.blocks) == {"bn": 8, "bm": 512}
    res = CausalEngine().classify(tq, PackedSlab(tu8, tb))
    assert dict(res.blocks) == {"bn": 4, "bm": 128}


@pytest.mark.parametrize("table_engine,span,want_engine", [
    ("i32", 40, "tri"),          # the table's i32 is not a packed engine
    ("mxu", 40, "mxu"),          # mxu within MXU_SPAN_MAX
    ("mxu", 90, "tri"),          # mxu refused above span 64
    ("tri", 40, "tri"),
])
def test_matrix_engine_from_table(tmp_path, monkeypatch, table_engine, span,
                                  want_engine):
    n, m = 24, 128
    cfg = {"engine": table_engine, "bi": 32, "bj": 128 if table_engine != "tri"
           else 32, "bm": 256, "us": 1.0}
    plant(monkeypatch, tmp_path,
          {autotune.key_for("matrix", n, n, m, "cpu"): cfg})
    calls = []
    for name in ("tri_flags", "rect_u8_flags", "mxu_viol", "rect_i32_stats"):
        spy(monkeypatch, name, calls)
    rng = np.random.default_rng(6)
    cells = torch.as_tensor(rng.integers(0, span + 1, (n, m)), dtype=torch.uint8)
    cells[0, 0], cells[1, 0] = 0, span
    base = torch.full((n,), 7, dtype=torch.int32)
    out = ops._compare_matrix_packed(cells, base)
    assert ops.LAST_DISPATCH["engine"] == want_engine
    if want_engine == table_engine:     # the entry's blocks come with it
        assert (ops.LAST_DISPATCH["bi"], ops.LAST_DISPATCH["bj"],
                ops.LAST_DISPATCH["bm"]) == (cfg["bi"], cfg["bj"], cfg["bm"])
    else:                               # an entry for another engine is ignored
        assert (ops.LAST_DISPATCH["bi"], ops.LAST_DISPATCH["bj"]) == (64, 64)
    name, kw = calls[-1]
    assert name == {"tri": "tri_flags", "mxu": "mxu_viol"}[want_engine]
    if want_engine == "mxu":
        assert (kw["bi"], kw["bj"]) == (32, 128)
    else:
        assert kw["bt"] == (32 if table_engine == "tri" else 64)
    le = np.all(cells.numpy()[:, None, :] <= cells.numpy()[None, :, :], axis=2)
    np.testing.assert_array_equal(out["a_le_b"].numpy(), le)
    # a rectangle: the table's tri becomes full at the built-in tiles
    ops._compare_matrix_packed(cells, base, cells[:10], base[:10])
    assert ops.LAST_DISPATCH["engine"] in ("full", "mxu")
    # an asked-for mxu over a wide span still raises, as in the reference
    if span > ops.MXU_SPAN_MAX:
        with pytest.raises(ValueError):
            ops._compare_matrix_packed(cells, base, engine="mxu")


def test_int32_matrix_honours_a_measured_i32_verdict(tmp_path, monkeypatch):
    n, m = 20, 128
    cfg = {"engine": "i32", "bi": 32, "bj": 64, "bm": 128, "us": 1.0}
    plant(monkeypatch, tmp_path,
          {autotune.key_for("matrix", n, n, m, "cpu"): cfg})
    calls = []
    spy(monkeypatch, "rect_i32_stats", calls)
    q, peers = query_and_peers(n, m, 7)
    rows = torch.as_tensor(peers)
    out = CausalEngine().pairs(rows)
    assert out.engine == "i32"
    assert calls == [("rect_i32_stats", {"bi": 32, "bj": 64, "bm": 128})]
    off = CausalEngine(CausalPolicy(autotune=False)).pairs(rows)
    assert off.engine == "tri"
    np.testing.assert_array_equal(out.le.numpy(), off.le.numpy())
    np.testing.assert_array_equal(out.row_sums.numpy(), off.row_sums.numpy())


def test_policy_autotune_flag_and_label():
    assert CausalPolicy().autotune is True
    pol = CausalPolicy(autotune=False, bn=4)
    assert pol.label() == "fp<=0.0001 engine=auto autotune=off bn4"
    from repro.causal.policy import CausalPolicy as JPolicy
    assert JPolicy(autotune=False, bn=4).label() == pol.label()
    assert CausalPolicy().label() == JPolicy().label()


# ---------------------------------------------------------------------------
# JAX against the port at the table's blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bn,bm", [(4, 128), (16, 256), (32, 512), (8, 1024)])
def test_table_blocks_match_reference_one_vs_many(tmp_path, monkeypatch, bn, bm):
    n, m = 40, 640
    plant(monkeypatch, tmp_path, {autotune.key_for("one_vs_many", n, n, m, "cpu"):
                                  {"engine": "packed", "bn": bn, "bm": bm,
                                   "us": 1.0}})
    q, peers = query_and_peers(n, m, 8)
    peers[3] += 2 ** 30                      # a far base: large tile sums
    u8, base, _ = jpack.pack_rows(jnp.asarray(peers))
    want = jops._classify_vs_many_packed(jnp.asarray(q), u8, base, bn=8, bm=bm,
                                         use_autotune=False)
    got = ops._classify_vs_many_packed(torch.as_tensor(q),
                                       torch.as_tensor(np.array(u8)),
                                       torch.as_tensor(np.array(base)))
    assert (ops.LAST_DISPATCH["bn"], ops.LAST_DISPATCH["bm"]) == (bn, bm)
    for key in ("q_le_p", "p_le_q", "sum_q", "sum_p"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("fp_q_before_p", "fp_p_before_q"):
        assert_fp_close(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("bn,bm", [(4, 128), (32, 256)])
def test_table_blocks_match_reference_hybrid(tmp_path, monkeypatch, bn, bm):
    T, H, m = 30, 5, 512
    plant(monkeypatch, tmp_path, {autotune.key_for("hybrid", H + T, H, m, "cpu"):
                                  {"engine": "hybrid", "bn": bn, "bm": bm,
                                   "us": 1.0}})
    q, peers = query_and_peers(T, m, 9)
    u8, base, _ = jpack.pack_rows(jnp.asarray(peers))
    rng = np.random.default_rng(9)
    meta = np.stack([rng.integers(0, 40, H), rng.integers(0, 3, H)], 1)
    meta = meta.astype(np.int32)
    hs = (4.0 * meta.sum(1)).astype(np.float32)
    want = jops._classify_hybrid(jnp.asarray(q), 20, jnp.asarray(meta),
                                 jnp.asarray(hs), u8, base, bn=8, bm=bm,
                                 use_autotune=False)
    got = ops._classify_hybrid(torch.as_tensor(q), 20, torch.as_tensor(meta),
                               torch.as_tensor(hs), torch.as_tensor(np.array(u8)),
                               torch.as_tensor(np.array(base)))
    assert (ops.LAST_DISPATCH["bn"], ops.LAST_DISPATCH["bm"]) == (bn, bm)
    for key in ("q_le_p", "p_le_q", "sum_q", "sum_p"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("fp_q_before_p", "fp_p_before_q"):
        assert_fp_close(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("engine,bi,bj,bm", [("tri", 32, 32, 512),
                                             ("i32", 32, 128, 256),
                                             ("mxu", 128, 64, 512)])
def test_table_blocks_match_reference_matrix(tmp_path, monkeypatch, engine, bi,
                                             bj, bm):
    n, m = 28, 384
    plant(monkeypatch, tmp_path, {autotune.key_for("matrix", n, n, m, "cpu"):
                                  {"engine": engine, "bi": bi, "bj": bj,
                                   "bm": bm, "us": 1.0}})
    q, peers = query_and_peers(n, m, 10, span=40)   # within MXU_SPAN_MAX
    if engine == "i32":
        peers[2, 5] += 4000                  # a span past a byte
    rows = torch.as_tensor(peers)
    got = ops._compare_matrix(rows, rows)
    want = jops._compare_matrix(jnp.asarray(peers), jnp.asarray(peers),
                                engine=None if engine != "i32" else "i32",
                                bm=bm, use_autotune=False)
    assert ops.LAST_DISPATCH["engine"] == engine
    assert (ops.LAST_DISPATCH["bi"], ops.LAST_DISPATCH["bj"],
            ops.LAST_DISPATCH["bm"]) == (bi, bj, bm)
    for key in ("a_le_b", "b_le_a", "concurrent", "row_sums", "col_sums"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert_fp_close(got["fp"].numpy(), np.asarray(want["fp"]))


# ---------------------------------------------------------------------------
# the serving tiers' pin
# ---------------------------------------------------------------------------

def test_tiers_pin_from_table_at_hot_plus_warm(tmp_path, monkeypatch):
    from repro_torch.core import clock as tbc
    from repro_torch.fleet import ClockRegistry
    from repro_torch.serve import TierConfig, TieredRegistry

    m = 256
    cfg = TierConfig(hot_capacity=6, warm_capacity=10, promote_after=2,
                     demote_batch=2, spill_batch=4, cold_batch=4,
                     spill_dir=str(tmp_path / "spill"))
    plant(monkeypatch, tmp_path, {
        # the flat-equivalent capacity 16 pins; the hot tier's own 6 rows
        # would resolve another entry, which must not be read
        autotune.key_for("one_vs_many", 16, 16, m, "cpu"):
            {"engine": "packed", "bn": 4, "bm": 128, "us": 1.0},
        autotune.key_for("one_vs_many", 6, 6, m, "cpu"):
            {"engine": "packed", "bn": 32, "bm": 256, "us": 1.0},
    })
    t = TieredRegistry(cfg, m=m, k=3, device=CPU)
    assert t.blocks == (t.policy.bn, t.policy.bm) == (4, 128)
    off = TieredRegistry(cfg, m=m, k=3, device=CPU,
                         policy=CausalPolicy(autotune=False))
    assert off.blocks == (8, 512)
    off.close()
    rng = np.random.default_rng(11)
    clocks = {}
    for i in range(26):
        base = 2 ** 31 - 40 if i % 5 == 0 else (2 ** 28 if i % 3 == 0 else 0)
        cells = ((rng.integers(0, 6, m).astype(np.int64) + base)
                 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        clocks[f"s{i}"] = tbc.compress(tbc.BloomClock(
            cells=torch.as_tensor(cells), base=torch.zeros((), dtype=torch.int32),
            k=3))
    t.admit_many(clocks)
    q = clocks["s1"]
    tv = t.classify(q)
    assert set(tv.tier) >= {"hot", "warm", "cold"}
    flat = ClockRegistry(capacity=32, m=m, k=3, policy=t.policy, device=CPU)
    flat.admit_many(clocks)
    fv = flat.classify_all(q)
    slots = [flat.slot_of(s) for s in tv.sids]
    np.testing.assert_array_equal(tv.status, fv.status[slots])
    np.testing.assert_array_equal(tv.sums, fv.sums[slots])
    np.testing.assert_array_equal(tv.fp.view(np.uint32),
                                  fv.fp[slots].view(np.uint32))
    t.close()


# ---------------------------------------------------------------------------
# spans, counters and the CLI
# ---------------------------------------------------------------------------

def test_sweep_spans_and_cache_counters(tmp_path, monkeypatch):
    from repro_torch.obs import MetricsRecorder, Observer, Tracer
    plant(monkeypatch, tmp_path, {})
    obs = Observer(trace=Tracer(), metrics=MetricsRecorder())
    table = autotune.autotune_shapes([(16, 128)], device="cpu", observer=obs)
    assert sorted(k.split("|")[0] for k in table) == ["hybrid", "matrix",
                                                       "one_vs_many"]
    spans = [e for e in obs.trace.events() if e["name"] == "autotune.sweep"]
    assert {e["attrs"]["op"] for e in spans} == {"matrix", "one_vs_many",
                                                "hybrid"}
    for e in spans:
        assert "winner" in e["attrs"] and e["attrs"]["measured"] >= 1
        assert e["attrs"]["candidates"] >= e["attrs"]["measured"]
    counted = {(r["name"], r["labels"]["op"]): r["value"]
               for r in obs.metrics.dump() if r["name"].startswith("autotune.")}
    for op in ("matrix", "one_vs_many", "hybrid"):
        span = next(e for e in spans if e["attrs"]["op"] == op)
        for k in ("candidates", "pruned", "measured"):
            assert counted[(f"autotune.{k}", op)] == span["attrs"][k]

    # the front door counts the table's hits and misses per dispatch
    q, peers = query_and_peers(16, 128, 12)
    plant(monkeypatch, tmp_path, {autotune.key_for("matrix", 16, 16, 128, "cpu"):
                                  {"engine": "tri", "bi": 32, "bj": 32,
                                   "bm": 512, "us": 1.0}})
    metrics = MetricsRecorder()
    eng = CausalEngine(CausalPolicy(observer=Observer(trace=Tracer(),
                                                      metrics=metrics)))
    res = eng.pairs(torch.as_tensor(peers))
    assert res.engine == "tri" and dict(res.blocks)["bi"] == 32
    u8, base, _ = jpack.pack_rows(jnp.asarray(peers))
    eng.classify(torch.as_tensor(q), PackedSlab(torch.as_tensor(np.array(u8)),
                                                torch.as_tensor(np.array(base))))
    hit = metrics.counter("autotune_cache", outcome="hit").value
    miss = metrics.counter("autotune_cache", outcome="miss").value
    assert hit >= 2 and miss >= 1


def test_cli_sweeps_on_the_cpu(tmp_path, monkeypatch, capsys):
    plant(monkeypatch, tmp_path, {})
    out = tmp_path / "new.json"
    explain = tmp_path / "explain.txt"
    autotune.main(["--device", "cpu", "--sizes", "64x256", "--write",
                   "--out", str(out), "--explain", "--explain-out", str(explain),
                   "--trace-dir", str(tmp_path / "trace")])
    table = json.loads(out.read_text())
    assert sorted(table) == sorted([
        autotune.key_for("matrix", 64, 64, 256, "cpu"),
        autotune.key_for("one_vs_many", 64, 64, 256, "cpu"),
        autotune.key_for("hybrid", 64, 8, 256, "cpu")])
    text = explain.read_text()
    assert "measured winner predicted at rank" in text and "default" in text
    assert (tmp_path / "trace").is_dir()
    printed = capsys.readouterr().out
    assert "[autotune] matrix N=64 m=256" in printed
    autotune.main(["--device", "cpu", "--sizes", "one_vs_many:32x128"])
    assert list(json.loads(capsys.readouterr().out.split("-> ")[-1]
                           .split("\n", 1)[1])) == [
        autotune.key_for("one_vs_many", 32, 32, 128, "cpu")]
    with pytest.raises(ValueError):
        autotune.parse_size("matrix:64x256h8")
    assert autotune.parse_size("hybrid:69628x1024h4089") == ("hybrid", 69628,
                                                             1024, 4089)


# ---------------------------------------------------------------------------
# the sharded half: ring against replicated
# ---------------------------------------------------------------------------

def test_predict_sharded_cost_ranks_ring_on_distinct_cards():
    """The card's model ranks "replicated" first when the shards share
    one card (the ring buys no parallelism and assembles its blocks) and
    "ring" first over 4 distinct cards; the CPU model is the reference's
    forced-host model, which always ranks "replicated" first."""
    regs = {"tri": 80, "full": 80}
    kw = dict(N=16384, m=1024, shards=4, backend="cuda", regs=regs)
    shared = {st: autotune.predict_sharded_cost(st, parallel=1, **kw)
              for st in ("ring", "replicated")}
    apart = {st: autotune.predict_sharded_cost(st, parallel=4, **kw)
             for st in ("ring", "replicated")}
    assert shared["replicated"] < shared["ring"] < math.inf
    assert apart["ring"] < apart["replicated"] < math.inf
    assert apart["ring"] < shared["ring"]
    assert autotune.predict_sharded_cost("ring", 16384, 1024, 1, "cuda",
                                         regs=regs) == \
        autotune.predict_sharded_cost("replicated", 16384, 1024, 1, "cuda",
                                      regs=regs)
    for d in (2, 4, 8):
        got = [autotune.predict_sharded_cost(st, 1024, 1024, d, "cpu")
               for st in ("ring", "replicated")]
        want = [jtune.predict_sharded_cost(st, 1024, 1024, d, True, bi=64,
                                           bj=64) for st in ("ring",
                                                             "replicated")]
        assert got[1] < got[0] and want[1] < want[0]
    with pytest.raises(ValueError):
        autotune.predict_sharded_cost("tree", 64, 64, 2, "cpu")


def test_cpu_sharded_sweep_writes_a_key_the_lookup_reads(tmp_path,
                                                         monkeypatch):
    """A CPU sweep at 4 shards writes a ``matrix_sharded|cpu|...|s4`` entry
    (through ``autotune_shapes`` and the CLI's ``--shards``), and the
    sharded op then runs the entry's strategy when none is asked for."""
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.sharding import split_rows

    plant(monkeypatch, tmp_path, {})
    exp = {}
    out = autotune.autotune_shapes([("matrix", 64, 256, None)],
                                   shard_counts=(1, 3, 4), device="cpu",
                                   explains=exp)
    key = autotune.key_for("matrix_sharded", 64, 64, 256, "cpu", 4)
    assert key == "matrix_sharded|cpu|N64|M64|m256|s4"
    assert sorted(out) == sorted([key, autotune.key_for("matrix", 64, 64, 256,
                                                        "cpu")])
    best = out[key]
    assert best["strategy"] in ("ring", "replicated") and best["us"] > 0
    assert (best["bi"], best["bj"], best["bm"]) == ops.MATRIX_BLOCKS
    assert {m["strategy"] for m in exp[key]["measured"]} == {"ring",
                                                             "replicated"}
    path = tmp_path / "swept.json"
    autotune.save_table(out, path)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", str(path))
    assert autotune.lookup("matrix_sharded", 64, 64, 256, "cpu",
                           shards=4) == best
    mesh = make_fleet_mesh(4, device="cpu")
    g = np.random.default_rng(4)
    cells = torch.as_tensor(g.integers(0, 9, (64, 256)), dtype=torch.uint8)
    base = torch.zeros(64, dtype=torch.int32)
    ops._compare_matrix_packed_sharded(split_rows(cells, mesh.devices),
                                       split_rows(base, mesh.devices),
                                       mesh=mesh, uniform_base=True)
    assert ops.LAST_DISPATCH["strategy"] == best["strategy"]
    cli = tmp_path / "cli.json"
    autotune.main(["--device", "cpu", "--sizes", "matrix:64x256", "--shards",
                   "2", "--write", "--out", str(cli)])
    assert autotune.key_for("matrix_sharded", 64, 64, 256, "cpu", 2) in \
        json.loads(cli.read_text())


def test_shared_cuda_mesh_neither_sweeps_nor_reads_the_table():
    """A CUDA mesh whose shards share a card is refused by the sweep
    before anything touches a card, and ``sharded_table_ok`` keeps the
    lookup off the table for it; CPU meshes and distinct cards pass."""
    from repro_torch.launch.mesh import FleetMesh

    cuda0 = torch.device("cuda", 0)
    shared = FleetMesh(devices=(cuda0,) * 4)
    apart = FleetMesh(devices=tuple(torch.device("cuda", i) for i in range(4)))
    assert not autotune.sharded_table_ok(shared)
    assert autotune.sharded_table_ok(apart)
    assert autotune.sharded_table_ok(FleetMesh(devices=(CPU,) * 4))
    assert autotune.sharded_table_ok(FleetMesh(devices=(cuda0,)))
    with pytest.raises(RuntimeError, match="share a card"):
        autotune.autotune_matrix_sharded(64, 256, 4, mesh=shared)
