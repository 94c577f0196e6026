"""The hybrid slice of the port against the JAX package on the CPU: the
plain version of the hybrid kernel against the Pallas kernel (interpret
mode), and ``repro_torch.hybrid`` against ``repro.hybrid`` driven
through the same admit, touch, classify, pairs and resize sequence.

Tolerances: flags, verdicts, float32 sums, sid orders, tail rows, audit
frames and CRCs identical (both sides at bm=512 unless a case pins
another; the JAX side's policy has ``autotune=False``, and its kernel
calls pass ``use_autotune=False`` with the same explicit bn and bm);
Eq. 3 fp within a relative 5e-2, values at or below the 1e-30 clip
floor counted as equal; hot-row fp exactly 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import causal as jcausal  # noqa: E402
from repro import hybrid as jhyb  # noqa: E402
from repro.core.hashing import stable_event_id  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.obs import MetricsRecorder as JMetrics  # noqa: E402
from repro.obs import Observer as JObserver  # noqa: E402
from repro.obs.audit import AuditTrail as JAuditTrail  # noqa: E402
from repro_torch import causal as tcausal  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import hybrid as thyb  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.obs import MetricsRecorder as TMetrics  # noqa: E402
from repro_torch.obs import Observer as TObserver  # noqa: E402
from repro_torch.obs.audit import AuditTrail as TAuditTrail  # noqa: E402

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


def _priv(i, j=0):
    return stable_event_id(b"test/priv", i, j)


# ---------------------------------------------------------------------------
# the hybrid kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def hybrid_inputs(H, T, m, seed, near_wrap=False):
    """A query, V, hot metadata and sums, and a packed tail around the
    query (ancestors, descendants, equal, forked, unrelated rows)."""
    g = np.random.default_rng(seed)
    q_res = g.integers(0, 200, m)
    q_base = I32_MAX - 150 if near_wrap else 5000
    q = as_i32(q_res + q_base)
    V = int(g.integers(5, 40))
    v = g.integers(0, 60, H)
    v[: min(H, 3)] = V                                # equal prefix lengths
    meta = np.stack([v, g.integers(0, 3, H)], 1).astype(np.int32)
    hot_sums = (4.0 * (meta[:, 0] + meta[:, 1])).astype(np.float32)
    kind = np.arange(T) % 5
    step = g.integers(-1, 2, (T, m)) * (g.random((T, m)) < 0.05)
    rows = np.repeat(q_res[None], T, axis=0)
    rows[kind == 1] += np.abs(step[kind == 1])
    rows[kind == 2] -= np.abs(step[kind == 2])
    rows[kind == 3] += step[kind == 3]
    rows[kind == 4] = g.integers(0, 256, ((kind == 4).sum(), m))
    tail = np.clip(rows, 0, 255).astype(np.uint8)
    base = np.full(T, q_base, np.int64)
    base[kind == 4] = g.integers(-2 ** 31, 2 ** 31 - 256, (kind == 4).sum())
    return q, V, meta, hot_sums, tail, as_i32(base)


@pytest.mark.parametrize("H,T,m,bm,near_wrap", [
    (5, 40, 200, 512, False),        # ragged m, H not a multiple of bn
    (12, 33, 256, 128, True),        # two m-tiles, bases at the wrap point
    (8, 9, 256, 512, False),
    (1, 1, 130, 512, True),
])
def test_hybrid_plain_matches_pallas(H, T, m, bm, near_wrap):
    q, V, meta, hs, tail, base = hybrid_inputs(H, T, m, H + T, near_wrap)
    want = jops._classify_hybrid(
        jnp.asarray(q), V, jnp.asarray(meta), jnp.asarray(hs),
        jnp.asarray(tail), jnp.asarray(base), bn=8, bm=bm, interpret=True,
        use_autotune=False)
    got = tops._classify_hybrid(
        torch.as_tensor(q), V, torch.as_tensor(meta), torch.as_tensor(hs),
        torch.as_tensor(tail), torch.as_tensor(base), bn=8, bm=bm)
    for key in ("q_le_p", "p_le_q", "sum_p", "sum_q"):
        np.testing.assert_array_equal(host(got[key]), np.asarray(want[key]),
                                      err_msg=key)
    for key in ("fp_q_before_p", "fp_p_before_q"):
        assert_fp_close(got[key], want[key])
        np.testing.assert_array_equal(host(got[key])[:H], 0.0)
    assert tops.LAST_DISPATCH == {"op": "hybrid", "engine": "fused_hot_tail",
                                  "bn": 8, "bm": tops.tile_width(m, bm),
                                  "hot": H, "tail": T}


def test_hybrid_tail_rows_are_the_packed_one_vs_many():
    q, V, meta, hs, tail, base = hybrid_inputs(7, 30, 256, 3)
    t = torch.as_tensor
    got = tops._classify_hybrid(t(q), V, t(meta), t(hs), t(tail), t(base),
                                bm=128)
    flat = tops._classify_vs_many_packed(t(q), t(tail), t(base), bm=128)
    for key in ("q_le_p", "p_le_q", "sum_p", "fp_q_before_p",
                "fp_p_before_q"):
        assert torch.equal(got[key][7:], flat[key]), key
    assert torch.equal(got["sum_q"], flat["sum_q"])


def test_hybrid_refuses_an_empty_side():
    q, V, meta, hs, tail, base = hybrid_inputs(4, 6, 128, 4)
    t = torch.as_tensor
    with pytest.raises(ValueError, match="both a hot set and a tail"):
        tops.hybrid(t(q), V, t(meta[:0]), t(hs[:0]), t(tail), t(base))
    with pytest.raises(ValueError, match="both a hot set and a tail"):
        tops.hybrid(t(q), V, t(meta), t(hs), t(tail[:0]), t(base[:0]))
    with pytest.raises(AssertionError, match="both a hot set and a tail"):
        tops._classify_hybrid(t(q), V, t(meta[:0]), t(hs[:0]), t(tail),
                              t(base))
    with pytest.raises(AssertionError, match="both a hot set and a tail"):
        jops._classify_hybrid(jnp.asarray(q), V, jnp.asarray(meta[:0]),
                              jnp.asarray(hs[:0]), jnp.asarray(tail),
                              jnp.asarray(base), interpret=True,
                              use_autotune=False)


# ---------------------------------------------------------------------------
# HybridEngine: the two packages driven through the same sequence
# ---------------------------------------------------------------------------

def _cfg(m=256, **kw):
    cfg = dict(m=m, k=4, hot_capacity=8, tail_capacity=64,
               promote_after=2, min_residency=0,
               max_migrations_per_window=1 << 30, window=1 << 30)
    cfg.update(kw)
    return cfg


def engines(V=48, *, audit=False, observe=False, **kw):
    """A JAX and a port ``HybridEngine`` of one config, chain advanced
    to V."""
    cfg = _cfg(**kw)
    jkw, tkw = {}, {}
    if audit:
        jkw["audit"] = JAuditTrail(store_frames=True)
        tkw["audit"] = TAuditTrail(store_frames=True)
    if observe:
        jkw["observer"] = JObserver(metrics=JMetrics())
        tkw["observer"] = TObserver(metrics=TMetrics())
    j = jhyb.HybridEngine(jhyb.HybridConfig(**cfg),
                          policy=jcausal.CausalPolicy(autotune=False), **jkw)
    t = thyb.HybridEngine(thyb.HybridConfig(**cfg), device=CPU, **tkw)
    j.advance_local(V)
    t.advance_local(V)
    return j, t


def both(engs, name, *args, **kw):
    return [getattr(e, name)(*args, **kw) for e in engs]


def assert_views_equal(jv, tv):
    assert tv.sids == jv.sids
    for key in ("hot", "q_le_p", "p_le_q", "sum_p"):
        np.testing.assert_array_equal(getattr(tv, key), getattr(jv, key),
                                      err_msg=key)
    assert tv.sum_q == jv.sum_q
    assert tv.engine == jv.engine
    for key in ("fp_q_before_p", "fp_p_before_q"):
        assert_fp_close(getattr(tv, key), getattr(jv, key))
        np.testing.assert_array_equal(getattr(tv, key)[tv.hot], 0.0)


def assert_tails_equal(j, t):
    assert t.m == j.m
    np.testing.assert_array_equal(t._probes, j._probes)
    np.testing.assert_array_equal(t._local_cells, j._local_cells)
    for name in ("_t_u8", "_t_base", "_t_sums", "_t_alive"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    assert t._t_wide.keys() == j._t_wide.keys()
    for s in j._t_wide:
        np.testing.assert_array_equal(t._t_wide[s], j._t_wide[s])
    assert t._t_free == j._t_free
    assert list(t._hot) == list(j._hot)


def test_hot_verdicts_exact_with_zero_fp():
    engs = engines(V=32)
    both(engs, "admit", "equal", v=32)
    both(engs, "admit", "past", v=10)
    both(engs, "admit", "conc", v=10, events=[_priv(1)])
    both(engs, "admit", "tail", v=20)
    for sid in ("equal", "past", "conc"):
        both(engs, "touch", sid)
        both(engs, "touch", sid)
    jv, tv = both(engs, "classify")
    assert_views_equal(jv, tv)
    assert [tv.verdict_of(s) for s in ("equal", "past", "conc")] == \
        ["equal", "ancestor", "concurrent"]
    assert tv.hot.sum() == 3
    assert tv.engine.startswith("fused_hot_tail")
    assert_tails_equal(*engs)


def test_tail_bit_identical_to_flat_packed_slab():
    engs = engines(V=48)
    rng = np.random.default_rng(3)
    for i in range(4):
        both(engs, "admit", f"hot/{i}", v=int(rng.integers(1, 8)))
        both(engs, "touch", f"hot/{i}")
        both(engs, "touch", f"hot/{i}")
    for i in range(20):
        v = int(rng.integers(8, 48))
        ev = [_priv(i, j) for j in range(rng.integers(0, 3))]
        both(engs, "admit", f"tail/{i}", v=v, events=ev)
    j, t = engs
    bn, bm = 8, t.m
    jv, tv = j.classify(bn=bn, bm=bm), t.classify(bn=bn, bm=bm)
    assert_views_equal(jv, tv)
    slab = t.slab()
    H = slab.hot_count
    flat = t.engine.classify(
        t.local_clock(), tcausal.PackedSlab(slab.cells_u8, slab.base,
                                            wide=slab.wide),
        bn=bn, bm=bm).to_host()
    for name in ("q_le_p", "p_le_q", "fp_q_before_p", "fp_p_before_q",
                 "sum_p"):
        np.testing.assert_array_equal(getattr(tv, name)[H:],
                                      getattr(flat, name), err_msg=name)


def test_wide_tail_row_overlaid_at_shifted_index():
    engs = engines(V=16)
    both(engs, "admit", "hot", v=4)
    both(engs, "touch", "hot")
    both(engs, "touch", "hot")
    both(engs, "admit", "narrow", v=8)
    both(engs, "admit", "wide", v=2, events=[_priv(9)] * 300)
    j, t = engs
    assert list(t._t_wide) == list(j._t_wide) and t._t_wide
    jv, tv = both(engs, "classify")
    assert_views_equal(jv, tv)
    assert [tv.verdict_of(s) for s in ("hot", "narrow", "wide")] == \
        ["ancestor", "ancestor", "concurrent"]
    assert "+wide_overlay" in tv.engine
    n_i32 = tops.LAUNCHES["one_vs_many_i32"]   # CPU: counts stay put
    t.classify()
    assert tops.LAUNCHES["one_vs_many_i32"] == n_i32


def test_pairs_hot_hot_block_is_exact():
    engs = engines(V=24)
    both(engs, "admit", "a", v=3)
    both(engs, "admit", "b", v=5)
    both(engs, "admit", "c", v=3, events=[_priv(7)])
    both(engs, "admit", "d", v=6, events=[_priv(7), _priv(8)])
    both(engs, "admit", "t", v=20)
    both(engs, "admit", "w", v=2, events=[_priv(9)] * 300)
    for sid in ("a", "b", "c", "d"):
        both(engs, "touch", sid)
        both(engs, "touch", sid)
    (jres, jorder), (tres, torder) = both(engs, "pairs")
    assert torder == jorder
    for key in ("a_le_b", "b_le_a", "concurrent", "row_sums", "col_sums"):
        np.testing.assert_array_equal(host(tres[key]), np.asarray(jres[key]),
                                      err_msg=key)
    assert_fp_close(tres.fp, jres.fp)
    assert tres.engine == jres.engine and tres.engine.endswith("+hot_exact")
    i = {sid: torder.index(sid) for sid in torder}
    le = host(tres.le)
    assert le[i["a"], i["b"]] and not le[i["b"], i["a"]]
    assert le[i["c"], i["d"]] and not le[i["c"], i["b"]]
    np.testing.assert_array_equal(host(tres.fp)[:4, :4], 0.0)


def test_pairs_guard_rejects_hot_slab_on_causal_engine():
    engs = engines(V=8)
    both(engs, "admit", "h", v=2)
    both(engs, "touch", "h")
    both(engs, "touch", "h")
    both(engs, "admit", "t", v=4)
    for e in engs:
        with pytest.raises(ValueError, match="classify-only"):
            e.engine.pairs(e.slab())


def test_demote_re_mints_bit_identically():
    engs = engines(V=32)
    both(engs, "admit", "s", v=13, events=[_priv(0)])
    j, t = engs
    row0 = t._tail_logical(t.sessions["s"].slot).copy()
    np.testing.assert_array_equal(row0,
                                  j._tail_logical(j.sessions["s"].slot))
    both(engs, "touch", "s")
    both(engs, "touch", "s")
    assert t.sessions["s"].hot and j.sessions["s"].hot
    both(engs, "demote", "s")
    np.testing.assert_array_equal(t._tail_logical(t.sessions["s"].slot), row0)
    assert_tails_equal(j, t)


@pytest.mark.parametrize("m,new_m", [(512, 128), (256, 256), (1024, 128)])
def test_fold_pow2_matches_reference(m, new_m):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 1 << 32, 5000)
    cells = np.bincount(idx % m, minlength=m)
    got = thyb.fold_pow2(cells, new_m)
    np.testing.assert_array_equal(got, jhyb.fold_pow2(cells, new_m))
    np.testing.assert_array_equal(got, np.bincount(idx % new_m,
                                                   minlength=new_m))


def test_fold_pow2_refusals_match_reference():
    for new_m in (96, 1024):
        for fold in (thyb.fold_pow2, jhyb.fold_pow2):
            with pytest.raises(ValueError):
                fold(np.zeros(512), new_m)


def test_derive_mk_matches_reference():
    for budget in (1.0, 1e-2, 1e-4, 1e-8):
        for sq in (256.0, 1024.0, 1536.0):
            for sp in (0.0, 4.0, 64.0, 256.0):
                kw = dict(m_max=1 << 20, k=4, m_min=128)
                assert thyb.derive_mk(budget, sq, sp, **kw) == \
                    jhyb.derive_mk(budget, sq, sp, **kw)
    assert thyb.derive_mk(1e-4, 1536.0, 256.0, m_max=1024, k=4) == (512, 2)
    for derive in (thyb.derive_mk, jhyb.derive_mk):
        with pytest.raises(ValueError):
            derive(0.0, 1024.0, 64.0, m_max=512, k=4)


def test_resize_preserves_verdicts_and_replays_bit_for_bit():
    engs = engines(V=64, audit=True, m=512, hot_capacity=4,
                   tail_capacity=32, promote_after=3, min_residency=2,
                   max_migrations_per_window=8, window=256)
    rng = np.random.default_rng(7)
    for i in range(12):
        v = int(rng.integers(16, 64))
        ev = [_priv(i, j) for j in range(rng.integers(0, 2))]
        both(engs, "admit", f"s{i}", v=v, events=ev)
    assert_views_equal(*both(engs, "classify"))
    both(engs, "resize_tail", 128, detail="test")
    j, t = engs
    assert_tails_equal(j, t)
    assert_views_equal(*both(engs, "classify"))
    for s in t.sessions.values():
        np.testing.assert_array_equal(t._tail_logical(s.slot),
                                      t._mint_cells(s))
    jrecs, trecs = j.audit.records, t.audit.records
    assert [(r.kind, r.peer_id, r.detail) for r in trecs] == \
        [(r.kind, r.peer_id, r.detail) for r in jrecs]
    for jr, tr in zip(jrecs, trecs):
        assert tr.local_frame == jr.local_frame
        assert tr.peer_crc == jr.peer_crc
    rep = thyb.replay_resize(t.audit)
    assert rep.ok and rep.checked == 12 and rep.matched == 12, rep.summary()
    rec = next(r for r in trecs if r.kind == "resize_row")
    snap = twire.decode_clock(rec.local_frame)
    snap["cells"] = np.asarray(snap["cells"]).copy()
    snap["cells"][0] += 1
    rec.local_frame = twire.encode_clock(snap)
    assert not thyb.replay_resize(t.audit).ok


def test_adaptive_policy_folds_once_budget_allows():
    engs = engines(V=128, m=512, hot_capacity=4, promote_after=1)
    both(engs, "admit", "tiny", v=1)
    both(engs, "touch", "tiny")
    for i in range(6):
        both(engs, "admit", f"t{i}", v=64 + i)
    j, t = engs
    j.adaptive = jhyb.AdaptivePolicy(j, jhyb.AdaptiveConfig(fp_budget=1e-4,
                                                            window=2))
    t.adaptive = thyb.AdaptivePolicy(t, thyb.AdaptiveConfig(fp_budget=1e-4,
                                                            window=2))
    assert_views_equal(*both(engs, "classify"))
    assert t.resizes == j.resizes == 0
    assert_views_equal(*both(engs, "classify"))
    assert t.resizes == j.resizes == 1 and t.m == j.m < 512
    assert t.adaptive.last_recommendation == j.adaptive.last_recommendation
    assert_tails_equal(j, t)
    assert_views_equal(*both(engs, "classify"))


def test_adaptive_policy_vetoed_by_a_tiny_tail_row():
    engs = engines(V=128, m=512, hot_capacity=4)
    both(engs, "admit", "tiny", v=1)
    for i in range(6):
        both(engs, "admit", f"t{i}", v=64 + i)
    j, t = engs
    j.adaptive = jhyb.AdaptivePolicy(j, jhyb.AdaptiveConfig(fp_budget=1e-4,
                                                            window=1))
    t.adaptive = thyb.AdaptivePolicy(t, thyb.AdaptiveConfig(fp_budget=1e-4,
                                                            window=1))
    assert_views_equal(*both(engs, "classify"))
    assert t.resizes == j.resizes == 0 and t.m == j.m == 512


def test_fp_budget_in_config_attaches_the_policy():
    engs = engines(V=16, fp_budget=1e-3)
    j, t = engs
    assert isinstance(t.adaptive, thyb.AdaptivePolicy)
    assert t.adaptive.cfg == thyb.AdaptiveConfig(fp_budget=1e-3)
    assert dataclasses.asdict(t.adaptive.cfg) == \
        dataclasses.asdict(j.adaptive.cfg)


def test_boundary_thrash_bounded_per_window():
    cap = 4
    engs = engines(V=16, hot_capacity=1, promote_after=1, min_residency=0,
                   max_migrations_per_window=cap, window=10_000)
    both(engs, "admit", "a", v=2)
    both(engs, "admit", "b", v=3)
    j, t = engs
    for r in range(50):
        cold = "b" if t.sessions["a"].hot else "a"
        assert j.sessions["a"].hot == t.sessions["a"].hot
        for _ in range(r + 2):
            both(engs, "touch", cold)
    assert (t.promotions, t.demotions) == (j.promotions, j.demotions)
    assert t.promotions + t.demotions <= cap
    jv, tv = both(engs, "classify")
    assert_views_equal(jv, tv)
    assert tv.verdict_of("a") == tv.verdict_of("b") == "ancestor"


def test_min_residency_shields_fresh_promotions():
    engs = engines(V=16, hot_capacity=1, promote_after=1, min_residency=3,
                   max_migrations_per_window=1 << 30, window=4)
    both(engs, "admit", "a", v=2)
    both(engs, "admit", "b", v=3)
    both(engs, "touch", "a")
    j, t = engs
    assert t.sessions["a"].hot and t.promotions == 1
    promoted_at = t.sessions["a"].promoted_window
    for _ in range(40):
        both(engs, "touch", "b")
        assert (t.promotions, t.demotions, t._window_idx) == \
            (j.promotions, j.demotions, j._window_idx)
        if t._window_idx - promoted_at < 3:
            assert t.demotions == 0
    assert t.demotions >= 1
    assert_tails_equal(j, t)


def test_hot_only_and_tail_only_and_empty_views():
    engs = engines(V=12, promote_after=1)
    jv, tv = both(engs, "classify")
    assert tv.engine == jv.engine == "empty" and tv.sum_q == jv.sum_q
    both(engs, "admit", "x", v=5, events=[_priv(3)])
    both(engs, "admit", "y", v=12)
    assert_views_equal(*both(engs, "classify"))          # tail only
    both(engs, "touch", "x")
    both(engs, "touch", "y")
    jv, tv = both(engs, "classify")                      # hot only
    assert_views_equal(jv, tv)
    assert tv.engine == "hot_exact"


def test_observer_metrics_match():
    engs = engines(V=24, observe=True)
    for i in range(5):
        both(engs, "admit", f"s{i}", v=3 + i)
    for _ in range(2):
        both(engs, "touch", "s0")
        both(engs, "touch", "s1")
    both(engs, "demote", "s1")
    both(engs, "classify")
    both(engs, "resize_tail", 128)
    both(engs, "classify")
    j, t = engs
    jd, td = j.obs.metrics.dump(), t.obs.metrics.dump()
    names = {"hybrid_migrations", "hybrid_classified",
             "hybrid_hot_occupancy", "hybrid_tail_m", "hybrid_tail_fp",
             "hybrid_resizes"}
    mine = [d for d in td if d["name"] in names]
    ref = [d for d in jd if d["name"] in names]
    assert {d["name"] for d in mine} == names and len(mine) == len(ref)
    for d, r in zip(mine, ref):
        if d["kind"] != "histogram":
            assert d == r
            continue
        # counts of claimed tail fp by band; the fp values themselves
        # agree within the fp tolerance
        for key in ("name", "labels", "edges", "counts", "count"):
            assert d[key] == r[key], key
        assert_fp_close([d["total"], d["min"], d["max"]],
                        [r["total"], r["min"], r["max"]])
    assert t.hot_hit_rate() == j.hot_hit_rate() > 0


def test_exact_frame_roundtrips_engine_hot_row():
    _, t = engines(V=12)
    t.admit("s", v=9, events=[_priv(0), _priv(1)])
    s = t.sessions["s"]
    frame = twire.encode_exact({"v": s.v, "events": s.events, "k": t.k})
    got = twire.decode_exact(frame)
    clone = dataclasses.replace(s, events=tuple(got["events"]), v=got["v"])
    np.testing.assert_array_equal(t._mint_cells(clone), t._mint_cells(s))


def _state_of(j) -> dict:
    return {
        "cfg": dataclasses.asdict(j.cfg), "m": j.m,
        "probes": np.asarray(j._probes),
        "local_cells": np.asarray(j._local_cells),
        "sessions": {sid: dataclasses.asdict(s)
                     for sid, s in j.sessions.items()},
        "hot": list(j._hot),
        "t_u8": np.asarray(j._t_u8), "t_base": np.asarray(j._t_base),
        "t_sums": np.asarray(j._t_sums), "t_alive": np.asarray(j._t_alive),
        "t_wide": {s: np.asarray(r) for s, r in j._t_wide.items()},
        "t_free": list(j._t_free),
        "window_idx": j._window_idx, "window_touches": j._window_touches,
        "window_migrations": j._window_migrations,
        "promotions": j.promotions, "demotions": j.demotions,
        "resizes": j.resizes,
    }


def test_hybrid_from_state_classifies_like_the_reference():
    j = jhyb.HybridEngine(jhyb.HybridConfig(**_cfg(m=512)),
                          policy=jcausal.CausalPolicy(autotune=False))
    j.advance_local(40)
    rng = np.random.default_rng(11)
    for i in range(16):
        ev = [_priv(100 + i, n) for n in range(rng.integers(0, 3))]
        j.admit(f"s{i}", v=int(rng.integers(0, 40)), events=ev)
    j.admit("wide", v=3, events=[_priv(5)] * 300)
    for sid in ("s1", "s2", "s3", "s1", "s2", "s3", "s4"):
        j.touch(sid)
    j.release("s7")
    t = convert.hybrid_from_state(_state_of(j), device=CPU)
    assert_tails_equal(j, t)
    assert_views_equal(j.classify(), t.classify())
    # and the two go on alike: more touches, a demotion, a fold
    for e in (j, t):
        e.touch("s4")
        e.demote("s2")
        e.admit("late", v=40, events=[_priv(999)])
        e.resize_tail(256)
    assert_tails_equal(j, t)
    assert_views_equal(j.classify(), t.classify())


def test_engine_runs_on_the_card_by_default(monkeypatch):
    """Without a device the engine takes the card, and the reference's
    ``interpret=True`` does not send it to the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        thyb.HybridEngine(thyb.HybridConfig(m=64))
    with pytest.raises(RuntimeError, match="CUDA"):
        thyb.HybridEngine(thyb.HybridConfig(m=64, interpret=True))


def test_hybrid_config_interpret_changes_nothing_and_crosses_convert():
    """The reference's ``HybridConfig(interpret=True)``: the port's engine
    classifies bit for bit as it does without it, and
    ``hybrid_from_state`` carries the field across."""
    views = []
    for interpret in (None, True):
        t = thyb.HybridEngine(thyb.HybridConfig(**_cfg(), interpret=interpret),
                              device=CPU)
        t.advance_local(40)
        for i in range(12):
            t.admit(f"s{i}", v=3 * i, events=[_priv(200 + i)])
        for sid in ("s1", "s2", "s1", "s2", "s5"):
            t.touch(sid)
        assert t.engine.policy.interpret is interpret
        views.append(t.classify())
    for key in ("sids", "hot", "q_le_p", "p_le_q", "fp_q_before_p",
                "fp_p_before_q", "sum_p", "sum_q", "engine"):
        np.testing.assert_array_equal(getattr(views[1], key),
                                      getattr(views[0], key), err_msg=key)
    j = jhyb.HybridEngine(jhyb.HybridConfig(**_cfg(m=512), interpret=True),
                          policy=jcausal.CausalPolicy(autotune=False))
    j.advance_local(8)
    j.admit("s", v=3, events=[_priv(1)])
    t = convert.hybrid_from_state(_state_of(j), device=CPU)
    assert t.cfg.interpret is True and t.engine.policy.interpret is True
    assert_views_equal(j.classify(), t.classify())
