"""The serving slice of the port against the JAX package on the CPU:
``repro_torch.serve`` (tiers, pipeline, churn), the registry's eviction
hook, ``convert.tiered_from_state`` and ``obs.export``, each driven
through the same seeded sequence as ``repro.serve``.

Tolerances: statuses, verdicts, flags, tier maps, float32 sums, cells,
frame bytes and the churn's deterministic counts identical (both sides
pin bn = 8, bm = 512; the JAX policy has ``autotune=False``); Eq. 3 fp
within a relative 5e-2 across packages, values at or below the 1e-30
clip floor counted as equal, and bit-identical inside the port (its
tiers against its own flat slab under the same policy).
"""
import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.causal import CausalPolicy as JPolicy  # noqa: E402
from repro.core import clock as jbc  # noqa: E402
from repro.core import wire as jwire  # noqa: E402
from repro.fleet import registry as jreg  # noqa: E402
from repro.obs import AuditTrail as JAuditTrail  # noqa: E402
from repro.obs import Observer as JObserver  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.serve import churn as jchurn  # noqa: E402
from repro.serve import pipeline as jpipe  # noqa: E402
from repro.serve import tiers as jtiers  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.causal import CausalPolicy as TPolicy  # noqa: E402
from repro_torch.core import clock as tbc  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402
from repro_torch.fleet import registry as treg  # noqa: E402
from repro_torch.obs import AuditTrail as TAuditTrail  # noqa: E402
from repro_torch.obs import Observer as TObserver  # noqa: E402
from repro_torch.obs import Tracer as TTracer  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402
from repro_torch.serve import churn as tchurn  # noqa: E402
from repro_torch.serve import pipeline as tpipe  # noqa: E402
from repro_torch.serve import tiers as ttiers  # noqa: E402

FP_RTOL = 5e-2
FP_FLOOR = 1e-30
I32_MAX = 2 ** 31 - 1
CPU = "cpu"
M, K = 32, 3
BLOCKS = dict(bn=8, bm=512)

SMALL = dict(hot_capacity=6, warm_capacity=10, promote_after=2,
             demote_batch=2, spill_batch=4, cold_batch=4)


def as_i32(x) -> np.ndarray:
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def assert_fp_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    keep = ~((a == b) | ((np.abs(a) <= FP_FLOOR) & (np.abs(b) <= FP_FLOOR)))
    np.testing.assert_allclose(a[keep], b[keep], rtol=FP_RTOL, atol=0)


def jpolicy(**kw):
    return JPolicy(autotune=False, **BLOCKS, **kw)


def tpolicy(**kw):
    return TPolicy(**BLOCKS, **kw)


class Pair:
    """The same clock in both packages, from int64 logical cells."""

    def __init__(self, cells):
        cells = as_i32(cells)
        self.j = jbc.compress(jbc.BloomClock(
            cells=jnp.asarray(cells), base=jnp.zeros((), jnp.int32), k=K))
        self.t = tbc.compress(tbc.BloomClock(
            cells=torch.as_tensor(cells), base=torch.zeros((), dtype=torch.int32),
            k=K))


def rand_pair(rng, hi=6, base=0) -> Pair:
    return Pair(rng.integers(0, hi, M).astype(np.int64) + base)


def logical(clock) -> np.ndarray:
    c = clock.logical_cells()
    return c.cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


class Tiers:
    """A JAX and a port ``TieredRegistry`` driven by the same calls."""

    def __init__(self, tmp_path, **cfg):
        self.j = jtiers.TieredRegistry(
            jtiers.TierConfig(spill_dir=str(tmp_path / "j"), **cfg), m=M, k=K,
            policy=jpolicy())
        self.t = ttiers.TieredRegistry(
            ttiers.TierConfig(spill_dir=str(tmp_path / "t"), **cfg), m=M, k=K,
            policy=tpolicy(), device=CPU)

    def admit_many(self, pairs: dict):
        self.j.admit_many({s: p.j for s, p in pairs.items()})
        self.t.admit_many({s: p.t for s, p in pairs.items()})
        self.assert_same_state()

    def call(self, name, *args):
        getattr(self.j, name)(*args)
        getattr(self.t, name)(*args)

    def assert_same_state(self):
        assert self.t._tier_of == self.j._tier_of
        assert self.t._access == self.j._access
        assert self.t.occupancy() == self.j.occupancy()
        for key in ("promotions", "demotions", "spills", "promotion_deferrals"):
            assert getattr(self.t, key) == getattr(self.j, key), key

    def classify(self, q: Pair, pairs: dict, sids=None):
        """Both classifies, against each other and the port's against a
        flat slab of the port holding the same clocks (bit for bit)."""
        jv = self.j.classify(q.j, sids=sids)
        tv = self.t.classify(q.t, sids=sids)
        assert tv.sids == jv.sids and tv.tier == jv.tier
        np.testing.assert_array_equal(tv.status, jv.status)
        np.testing.assert_array_equal(tv.sums, jv.sums)
        assert_fp_close(tv.fp, jv.fp)
        assert tv.local_sum == jv.local_sum
        flat = treg.ClockRegistry(capacity=max(8, 2 * len(pairs) + 4), m=M,
                                  k=K, policy=self.t.policy, device=CPU)
        flat.admit_many({s: p.t for s, p in pairs.items()})
        ref = flat.classify_all(q.t)
        slots = [flat.slot_of(s) for s in tv.sids]
        np.testing.assert_array_equal(tv.status, ref.status[slots])
        np.testing.assert_array_equal(tv.fp, ref.fp[slots])
        np.testing.assert_array_equal(tv.sums, ref.sums[slots])
        self.assert_same_state()
        return tv

    def close(self):
        self.j.close()
        self.t.close()


# ---------------------------------------------------------------------------
# the registry's eviction hook
# ---------------------------------------------------------------------------

def test_evicted_rows_match_reference():
    rng = np.random.default_rng(7)
    pairs = {f"p{i}": rand_pair(rng) for i in range(6)}
    pairs["wide"] = Pair(rng.integers(0, 900, M))              # span > 255
    pairs["rim"] = rand_pair(rng, hi=5, base=I32_MAX - 30)     # near wrap
    pairs["bad"] = rand_pair(rng)
    got = {}
    jr = jreg.ClockRegistry(capacity=12, m=M, k=K, policy=jpolicy())
    tr = treg.ClockRegistry(capacity=12, m=M, k=K, policy=tpolicy(), device=CPU)
    for name, r, side in (("j", jr, "j"), ("t", tr, "t")):
        r.on_evict = lambda rows, name=name: got.setdefault(name, rows)
        r.admit_many({s: getattr(p, side) for s, p in pairs.items()})
        r.quarantine_rows(["bad"])
        r.evict_many(["p1", "wide", "rim", "bad", "p4"])
    assert list(got["t"]) == list(got["j"]) == ["p1", "wide", "rim", "p4"]
    for sid, want in got["j"].items():
        row = got["t"][sid]
        assert isinstance(row, treg.EvictedRow)
        np.testing.assert_array_equal(row.cells_u8, want.cells_u8)
        assert row.base == want.base and row.sum == want.sum
        assert (row.wide is None) == (want.wide is None), sid
        if want.wide is not None:
            np.testing.assert_array_equal(row.wide, want.wide)
        np.testing.assert_array_equal(row.logical(), want.logical())
        np.testing.assert_array_equal(row.logical(), logical(pairs[sid].t))
    assert got["t"]["wide"].wide is not None and got["t"]["rim"].wide is not None
    assert "bad" not in tr and len(tr) == 4


# ---------------------------------------------------------------------------
# the tier contracts of tests/test_serve_tiers.py, JAX against the port
# ---------------------------------------------------------------------------

def full_query(v) -> Pair:
    return Pair(np.full(M, v))


def spread(t: Tiers, rng):
    pairs = {f"s{i}": rand_pair(rng) for i in range(30)}
    t.admit_many(pairs)
    assert set(t.t._tier_of.values()) == {"hot", "warm", "cold"}
    t.classify(full_query(9), pairs)


def promotion(t: Tiers, rng):
    pairs = {f"s{i}": rand_pair(rng) for i in range(24)}
    t.admit_many(pairs)
    cold = next(s for s, tier in t.t._tier_of.items() if tier == "cold")
    for _ in range(SMALL["promote_after"]):
        t.call("touch", cold)
    assert t.t._tier_of[cold] == "hot"
    t.classify(rand_pair(rng, hi=12), pairs)


def near_wrap(t: Tiers, rng):
    rim_base = I32_MAX - 40
    pairs = {f"rim{i}": rand_pair(rng, hi=5, base=rim_base) for i in range(4)}
    pairs.update({f"s{i}": rand_pair(rng) for i in range(20)})
    t.admit_many({s: p for s, p in pairs.items() if s.startswith("rim")})
    t.admit_many({s: p for s, p in pairs.items() if not s.startswith("rim")})
    assert {t.t._tier_of[f"rim{i}"] for i in range(4)} - {"hot"}
    t.classify(rand_pair(rng, hi=5, base=rim_base + 20), pairs)


def release_targeted(t: Tiers, rng):
    pairs = {f"s{i}": rand_pair(rng) for i in range(18)}
    t.admit_many(pairs)
    for sid in ("s0", "s7", "s17"):
        t.call("release", sid)
        del pairs[sid]
        assert sid not in t.t
    t.classify(full_query(7), pairs, sids=list(pairs)[:5])


def get_roundtrip(t: Tiers, rng):
    pairs = {f"s{i}": rand_pair(rng) for i in range(26)}
    pairs["rim"] = rand_pair(rng, hi=4, base=I32_MAX - 9)
    t.admit_many(pairs)
    for sid, p in pairs.items():
        got = t.t.get(sid, count=False)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(logical(got), logical(p.t), err_msg=sid)
        np.testing.assert_array_equal(
            logical(got), logical(t.j.get(sid, count=False)), err_msg=sid)
    # counted gets promote a cold session, in both packages alike
    cold = next(s for s, tier in t.t._tier_of.items() if tier == "cold")
    for _ in range(SMALL["promote_after"]):
        np.testing.assert_array_equal(logical(t.t.get(cold)),
                                      logical(t.j.get(cold)))
    t.assert_same_state()
    assert t.t._tier_of[cold] == "hot"


def interleaved(seed):
    def run(t: Tiers, rng):
        g = np.random.default_rng(1000 + seed)
        pairs = {}
        for _ in range(50):
            op = ["admit", "release", "touch"][int(g.integers(0, 3))]
            sid = f"s{int(g.integers(0, 40))}"
            rim = bool(g.integers(0, 4) == 0)
            if op == "admit":
                p = rand_pair(rng, hi=5,
                              base=I32_MAX - int(rng.integers(5, 60)) if rim else 0)
                pairs[sid] = p
                t.j.admit(sid, p.j)
                t.t.admit(sid, p.t)
                t.assert_same_state()
            elif op == "release" and sid in pairs:
                t.call("release", sid)
                del pairs[sid]
            elif op == "touch" and sid in pairs:
                t.call("touch", sid)
        if pairs:
            t.classify(rand_pair(rng, hi=10), pairs)
    return run


@pytest.mark.parametrize("scenario,seed", [
    (spread, 0), (promotion, 1), (near_wrap, 2), (release_targeted, 3),
    (get_roundtrip, 4), (interleaved(0), 0), (interleaved(1), 1),
    (interleaved(2), 2), (interleaved(3), 3)],
    ids=["spread", "promotion", "near_wrap", "release_targeted",
         "get_roundtrip", "interleaved0", "interleaved1", "interleaved2",
         "interleaved3"])
def test_tier_contract_matches_reference(tmp_path, scenario, seed):
    t = Tiers(tmp_path, **SMALL)
    try:
        scenario(t, np.random.default_rng(seed))
    finally:
        t.close()


def test_tiers_pin_policy_blocks():
    t = ttiers.TieredRegistry(ttiers.TierConfig(**SMALL), m=M, k=K, device=CPU)
    assert t.blocks == (t.policy.bn, t.policy.bm) == (8, 512)
    t.close()
    t = ttiers.TieredRegistry(ttiers.TierConfig(**SMALL), m=M, k=K,
                              policy=TPolicy(bn=4, bm=128), device=CPU)
    assert t.blocks == (4, 128) and t.hot.policy is t.policy
    t.close()


def test_tiered_from_state_continues_like_reference(tmp_path):
    """A JAX tiered registry mid-churn crosses to the port, and both
    then run the same sequence to the same state and verdicts."""
    rng = np.random.default_rng(11)
    j = jtiers.TieredRegistry(jtiers.TierConfig(spill_dir=str(tmp_path / "j"),
                                                **SMALL),
                              m=M, k=K, policy=jpolicy())
    pairs = {f"s{i}": rand_pair(rng) for i in range(26)}
    pairs["rim"] = rand_pair(rng, hi=4, base=I32_MAX - 9)
    j.admit_many({s: p.j for s, p in pairs.items()})
    j.touch("s3")
    j.release("s5")
    del pairs["s5"]
    h = j.hot
    state = {
        "cfg": dataclasses.asdict(j.cfg), "m": M, "k": K,
        "hot": {"cells_u8": np.asarray(h.cells_u8), "base": np.asarray(h.base),
                "sums": np.asarray(h.sums), "alive": h._alive_host,
                "slot_of": h._slot_of, "wide": h._wide, "crc": h._crc_host,
                "free": h._free},
        "w_u8": j._w_u8, "w_base": j._w_base, "w_sums": j._w_sums,
        "w_alive": j._w_alive, "w_wide": j._w_wide, "w_slot_of": j._w_slot_of,
        "w_free": j._w_free,
        "cold": {sid: j._read_frame(sid) for sid in j._cold_index},
        "tier_of": j._tier_of, "access": j._access, "age": j._age,
        "promoted_at": j._promoted_at, "age_seq": j._age_seq,
        "window_touches": j._window_touches,
        "window_migrations": j._window_migrations,
        "promotions": j.promotions, "demotions": j.demotions,
        "spills": j.spills, "promotion_deferrals": j.promotion_deferrals}
    t = Tiers.__new__(Tiers)
    t.j = j
    t.t = convert.tiered_from_state(state, device=CPU, policy=tpolicy(),
                                    spill_dir=str(tmp_path / "t"))
    try:
        t.assert_same_state()
        np.testing.assert_array_equal(t.t._w_u8, j._w_u8)
        for sid in j._cold_index:
            assert t.t._read_frame(sid) == j._read_frame(sid)
        t.classify(full_query(8), pairs)
        more = {f"n{i}": rand_pair(rng) for i in range(9)}
        pairs.update(more)
        t.admit_many(more)
        cold = next(s for s, tier in t.t._tier_of.items() if tier == "cold")
        for _ in range(SMALL["promote_after"]):
            t.call("touch", cold)
        t.call("release", "s9")
        del pairs["s9"]
        t.classify(rand_pair(rng, hi=12), pairs)
        for sid, p in pairs.items():
            np.testing.assert_array_equal(logical(t.t.get(sid, count=False)),
                                          logical(p.t), err_msg=sid)
    finally:
        t.close()


# ---------------------------------------------------------------------------
# the pipeline contracts of tests/test_serve_pipeline.py
# ---------------------------------------------------------------------------

PIPE_CFG = dict(hot_capacity=16, warm_capacity=32, promote_after=2,
                demote_batch=4, spill_batch=8, cold_batch=8)


class Pipes:
    """A JAX and a port pipeline over the same tier config and local
    clock; ``run(fn)`` feeds both the same requests."""

    def __init__(self, tmp_path, jobs=None, tobs=None, threshold=1.0,
                 batch=8):
        self.local = {"j": self.tick_n("j", jbc.zeros(M, K), 12),
                      "t": self.tick_n("t", tbc.zeros(M, K, device=CPU), 12)}
        self.tiers = {
            "j": jtiers.TieredRegistry(
                jtiers.TierConfig(spill_dir=str(tmp_path / "j"), **PIPE_CFG),
                m=M, k=K, policy=jpolicy(fp_threshold=threshold, observer=jobs)),
            "t": ttiers.TieredRegistry(
                ttiers.TierConfig(spill_dir=str(tmp_path / "t"), **PIPE_CFG),
                m=M, k=K, policy=tpolicy(fp_threshold=threshold, observer=tobs),
                device=CPU)}
        self.pipe = {
            "j": jpipe.AdmissionPipeline(
                self.tiers["j"], lambda: self.local["j"],
                jpipe.PipelineConfig(batch_size=batch, max_wait_s=0.002)),
            "t": tpipe.AdmissionPipeline(
                self.tiers["t"], lambda: self.local["t"],
                tpipe.PipelineConfig(batch_size=batch, max_wait_s=0.002))}

    @staticmethod
    def tick_n(side, c, n, salt=0):
        mod = jbc if side == "j" else tbc
        for i in range(n):
            c = mod.tick(c, np.uint32(salt), np.uint32(i + 1))
        return c

    def submit(self, sid, frame=None, kind="admit"):
        return {s: p.submit(sid, frame=frame, kind=kind)
                for s, p in self.pipe.items()}

    def drain(self):
        for p in self.pipe.values():
            p.drain(timeout=120)

    @staticmethod
    def same(tickets: dict):
        """The two verdicts of one request.  Whether it was served from
        the digest cache depends on batch boundaries (thread timing), so
        ``cached`` and ``engine`` are compared only where the test
        drains between the requests that decide them."""
        vj, vt = tickets["j"].result(1), tickets["t"].result(1)
        assert (vt.sid, vt.kind, vt.verdict, vt.admitted) == \
            (vj.sid, vj.kind, vj.verdict, vj.admitted)
        assert_fp_close([vt.fp], [vj.fp])
        return vt

    def close(self):
        for s in ("j", "t"):
            self.pipe[s].close()
            self.tiers[s].close()


def frame_of(clock) -> bytes:
    return twire.encode_clock(tbc.to_wire(clock))


def test_pipeline_admit_gate_and_query_roundtrip(tmp_path):
    p = Pipes(tmp_path)
    try:
        past = p.tick_n("t", tbc.zeros(M, K, device=CPU), 4)
        forked = tbc.zeros(M, K, device=CPU)
        for _ in range(40):
            forked = tbc.tick(forked, np.uint32(999), np.uint32(7))
        ok, no = p.submit("anc", frame_of(past)), p.submit("fork", frame_of(forked))
        p.drain()
        v_ok, v_no = p.same(ok), p.same(no)
        assert v_ok.admitted and v_ok.verdict == "ancestor"
        assert v_ok.engine and v_ok.engine != "digest_cache"
        assert not v_no.admitted and v_no.verdict == "forked"
        assert "anc" in p.tiers["t"] and "fork" not in p.tiers["t"]
        q, qq = p.submit("anc", kind="query"), p.submit("ghost", kind="query")
        p.drain()
        assert p.same(q).verdict == "ancestor"
        assert p.same(qq).verdict == "unknown"
        tp = p.pipe["t"]
        assert tp.n_admitted == 1 and tp.n_rejected == 1 and tp.n_queries == 2
        assert tp.latency_quantiles()["p50"] > 0
    finally:
        p.close()


def test_pipeline_digest_cache_hits_and_invalidation(tmp_path):
    p = Pipes(tmp_path)
    try:
        frame = frame_of(p.tick_n("t", tbc.zeros(M, K, device=CPU), 3))
        assert frame == jwire.encode_clock(jbc.to_wire(
            p.tick_n("j", jbc.zeros(M, K), 3)))
        p.submit("a0", frame)
        p.drain()
        t = [p.submit(f"a{i}", frame) for i in range(1, 4)]
        p.drain()
        for x in t:
            p.same(x)
            for v in (x["j"].result(1), x["t"].result(1)):
                assert v.cached and v.engine == "digest_cache" and v.admitted
        assert p.pipe["t"].cache_hits == 3
        # a local tick invalidates every entry: the same frame misses again
        p.local["j"] = jbc.tick(p.local["j"], np.uint32(1), np.uint32(77))
        p.local["t"] = tbc.tick(p.local["t"], np.uint32(1), np.uint32(77))
        t2 = p.submit("a9", frame)
        p.drain()
        assert not p.same(t2).cached and not t2["j"].result(1).cached
        assert p.pipe["t"].cache_hits == 3 and p.pipe["t"].cache_misses >= 2
    finally:
        p.close()


def test_pipeline_audit_replays_like_reference(tmp_path):
    jtrail, ttrail = JAuditTrail(store_frames=True), TAuditTrail(store_frames=True)
    p = Pipes(tmp_path, jobs=JObserver(audit=jtrail), tobs=TObserver(audit=ttrail))
    try:
        rng = np.random.default_rng(5)
        tickets = []
        for i in range(20):
            n, salt = int(rng.integers(1, 10)), int(rng.integers(0, 3))
            c = p.tick_n("t", tbc.zeros(M, K, device=CPU), n, salt)
            tickets.append(p.submit(f"s{i}", frame_of(c)))
        # a wide row (span > 255) and a rim row ride the exact overlay
        tickets.append(p.submit("wide", frame_of(tbc.BloomClock(
            cells=torch.as_tensor(as_i32(rng.integers(0, 900, M))),
            base=torch.zeros((), dtype=torch.int32), k=K))))
        tickets.append(p.submit("rim", twire.encode_clock(
            {"cells": rng.integers(0, 5, M).astype(np.uint8),
             "base": I32_MAX - 10, "k": K})))
        p.drain()
        for i in range(6):
            tickets.append(p.submit(f"s{i}", kind="query"))
        tickets.append(p.submit("wide", kind="query"))
        p.drain()
        for x in tickets:
            p.same(x)
        assert "wide_overlay" in tickets[20]["t"].result(1).engine
        # one admit a session: records pair up by session (their order
        # and cache labels follow batch boundaries)
        jrec = {r.peer_id: r for r in jtrail.verdicts()}
        trec = {r.peer_id: r for r in ttrail.verdicts()}
        assert len(trec) == len(ttrail.verdicts()) == 22
        assert trec.keys() == jrec.keys()
        for sid, rt in trec.items():
            rj = jrec[sid]
            assert (rt.verdict, rt.action, rt.local_crc, rt.peer_crc,
                    rt.transport, rt.peer_frame, rt.local_frame) == \
                (rj.verdict, rj.action, rj.local_crc, rj.peer_crc,
                 rj.transport, rj.peer_frame, rj.local_frame)
            assert rt.local_sum == rj.local_sum and rt.peer_sum == rj.peer_sum
            assert_fp_close([rt.fp], [rj.fp])
        rep = ttrail.replay_frames(
            policy=dataclasses.replace(p.tiers["t"].policy, observer=None),
            device=CPU)
        assert rep.checked > 0 and not rep.mismatches, rep.mismatches
        assert rep.matched == rep.checked
    finally:
        p.close()


def test_pipeline_backpressure_counts_every_request(tmp_path):
    p = Pipes(tmp_path, batch=4)
    try:
        frame = frame_of(p.tick_n("t", tbc.zeros(M, K, device=CPU), 2))
        # feeders on four threads against a 2048-deep queue of 4-row batches
        tickets = [None] * 40

        def feed(lo):
            for i in range(lo, 40, 4):
                tickets[i] = p.pipe["t"].submit(f"b{i}", frame=frame)

        threads = [threading.Thread(target=feed, args=(lo,)) for lo in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        p.pipe["t"].drain(timeout=120)
        assert all(t.result(1).admitted for t in tickets)
        assert p.pipe["t"].n_admitted == 40
        assert p.pipe["t"].stats()["batches"] >= 10
    finally:
        p.close()


def test_pipeline_query_reads_clock_before_same_batch_promotion(tmp_path):
    """Queries staged in one batch: a warm or cold session's access
    promotes it and evicts the oldest of equally touched hot rows,
    whose slot the promoted row then takes; a hot session queried
    earlier in the batch still reads its own row.  The sessions are
    admitted straight into both registries (pipeline admits would move
    rows by batch boundaries), so every verdict, promotion and tier is
    fixed by the seed."""
    p = Pipes(tmp_path, batch=64)
    try:
        rng = np.random.default_rng(3)
        # prefixes of the local chain (12 ticks), some equal to it
        ticks = {f"s{i}": int(rng.integers(1, 13)) for i in range(40)}
        for side, zero in (("j", jbc.zeros(M, K)),
                           ("t", tbc.zeros(M, K, device=CPU))):
            p.tiers[side].admit_many({s: p.tick_n(side, zero, n)
                                      for s, n in ticks.items()})
        tiers = p.tiers["t"]
        assert tiers._tier_of == p.tiers["j"]._tier_of
        hot = [s for s in ticks if tiers.tier_of(s) == "hot"]
        far = [s for s in ticks if tiers.tier_of(s) != "hot"][:4]
        # every hot row equally touched, each round hot first: the
        # promotions of round 2 evict hot rows already staged in it
        for _ in range(PIPE_CFG["promote_after"]):
            tickets = [p.submit(s, kind="query") for s in hot + far]
            p.drain()
            for x in tickets:
                p.same(x)
        assert p.tiers["t"].promotions == p.tiers["j"].promotions == len(far)
        assert p.tiers["t"]._tier_of == p.tiers["j"]._tier_of
        assert {tiers.tier_of(s) for s in hot} == {"hot", "warm"}
    finally:
        p.close()


# ---------------------------------------------------------------------------
# the churn driver, both packages
# ---------------------------------------------------------------------------

DETERMINISTIC = ("sessions", "admitted", "rejected", "queries", "migrations",
                 "expiries", "fn_violations", "concurrent_seen", "measured_fp")


def test_churn_matches_reference(monkeypatch):
    """The reference's final store is caught at its ``close``; the
    port's through ``inspect``.  Counts, fn, measured fp and every final
    stored clock identical; cache hits and latencies follow thread
    timing and are not compared."""
    kept = {}
    close = jtiers.TieredRegistry.close

    def keep(self):
        kept.setdefault("j", {s: logical(self.get(s, count=False))
                              for s in self.sids()})
        close(self)

    monkeypatch.setattr(jtiers.TieredRegistry, "close", keep)

    def inspect(tiers, replica):
        kept["t"] = {s: logical(tiers.get(s, count=False))
                     for s in tiers.sids()}
        kept["replica"] = logical(replica)

    cfg = dict(sessions=600, steps=6, queries_per_step=96, migrate_per_step=8,
               batch_size=32, hot_capacity=64, warm_capacity=128)
    rj = jchurn.run_churn(jchurn.ChurnConfig.quick(**cfg))
    rt = tchurn.run_churn(tchurn.ChurnConfig.quick(**cfg), device=CPU,
                          inspect=inspect)
    for key in DETERMINISTIC:
        assert getattr(rt, key) == getattr(rj, key), key
    assert rt.fn_violations == 0 and rt.ok() and rj.ok()
    assert rt.replay["checked"] == rt.replay["matched"] > 0
    assert not rt.replay["mismatches"]
    assert rt.tier_counts.get("cold", 0) > 0
    assert kept["t"].keys() == kept["j"].keys()
    for sid, cells in kept["j"].items():
        np.testing.assert_array_equal(kept["t"][sid], cells, err_msg=sid)
    assert kept["replica"].sum() == 6 * 4 * tchurn.ChurnConfig().k


def test_churn_cli_reports_json(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = tchurn.main(["--device", "cpu", "--quick", "--sessions", "300",
                      "--steps", "3", "--queries", "32", "--json", str(out),
                      "--trace-dir", str(tmp_path / "trace")])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["fn_violations"] == 0 and report["replay"]["mismatches"] == []
    assert json.loads(capsys.readouterr().out)["sessions"] == 300
    spans = texport.load_spans(tmp_path / "trace" / "trace.jsonl")
    names = {s["name"] for s in spans}
    assert {"causal.classify", "registry.admit", "pipeline.stage",
            "pipeline.finalize"} <= names


# ---------------------------------------------------------------------------
# obs.export
# ---------------------------------------------------------------------------

def test_export_round_trip_matches_reference(tmp_path, capsys):
    path = tmp_path / "trace.jsonl"
    tracer = TTracer(str(path))
    with tracer.span("outer", n=3):
        with tracer.span("inner", engine="packed"):
            pass
    tracer.close()
    spans = texport.load_spans(path)
    assert spans == jexport.load_spans(path)
    assert [s["name"] for s in spans] == ["inner", "outer"]
    chrome = texport.to_chrome(spans)
    assert chrome == jexport.to_chrome(spans)
    assert chrome["traceEvents"][1]["args"] == {"n": 3}
    assert texport.summarize(spans) == jexport.summarize(spans)
    out = tmp_path / "trace.chrome.json"
    assert texport.main([str(path), "--chrome", "-o", str(out)]) == 0
    assert json.loads(out.read_text()) == chrome
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"name": "x"}\n')
    with pytest.raises(ValueError, match="missing"):
        texport.load_spans(bad)
