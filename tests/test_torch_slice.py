"""The first slice of the port as a whole, against the JAX package on
the CPU: the same state in both packages (through ``repro_torch.convert``),
then ``CausalEngine.classify``, ``ClockRegistry.classify_all`` with
promoted rows, ``ClockRuntime`` lineage/admit_merge, three loopback
gossip rounds, the simulators, and the observer's audit trail.

Tolerances: statuses, flags, cells, registry rows, CRCs and wire bytes
identical; float32 sums identical at bm=512, bn=8 (pinned on the JAX
side with ``CausalPolicy(bm=512, bn=8, autotune=False)``); Eq. 3 fp
within a relative 5e-2, values below the 1e-30 clip floor counted as
equal.  Every fp gate used here sits far from the fp values.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import causal as jcausal  # noqa: E402
from repro.core import clock as jbc  # noqa: E402
from repro.core import sim as jsim  # noqa: E402
from repro.core import wire as jwire  # noqa: E402
from repro.fleet import gossip as jgossip  # noqa: E402
from repro.fleet import registry as jreg_mod  # noqa: E402
from repro.obs import AuditTrail as JAuditTrail  # noqa: E402
from repro.obs import Observer as JObserver  # noqa: E402
from repro.runtime import clock_runtime as jrt_mod  # noqa: E402
from repro_torch import causal as tcausal  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import device as tdevice  # noqa: E402
from repro_torch.core import clock as tbc  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402
from repro_torch.fleet import gossip as tgossip  # noqa: E402
from repro_torch.fleet import registry as treg_mod  # noqa: E402
from repro_torch.obs import AuditTrail as TAuditTrail  # noqa: E402
from repro_torch.obs import Observer as TObserver  # noqa: E402
from repro_torch.runtime import clock_runtime as trt_mod  # noqa: E402

M, K, CAP = 128, 4, 48
FP_RTOL = 5e-2
FP_FLOOR = 1e-30
CPU = "cpu"


def as_i32(x) -> np.ndarray:
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def assert_fp_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    tiny = (np.abs(a) <= FP_FLOOR) & (np.abs(b) <= FP_FLOOR)
    np.testing.assert_allclose(np.where(tiny, 0.0, a), np.where(tiny, 0.0, b),
                               rtol=FP_RTOL, atol=0)


def jpolicy(**kw):
    return jcausal.CausalPolicy(bm=512, bn=8, autotune=False, **kw)


def tpolicy(**kw):
    return tcausal.CausalPolicy(bm=512, bn=8, **kw)


def runtimes(n_ticks=40, **obs):
    jrt = jrt_mod.ClockRuntime(jrt_mod.ClockConfig(m=M, k=K, policy=jpolicy()),
                               observer=obs.get("jobs"))
    trt = trt_mod.ClockRuntime(trt_mod.ClockConfig(m=M, k=K, policy=tpolicy()),
                               observer=obs.get("tobs"), device=CPU)
    for s in range(n_ticks):
        jrt.tick_step(s)
        trt.tick_step(s)
    return jrt, trt


def peer_rows(local: np.ndarray, n: int = 40, seed: int = 0) -> np.ndarray:
    """Ancestors, descendants, equal, forked and unrelated peers around
    ``local``, plus two span > 255 rows and two near-wrap rows."""
    g = np.random.default_rng(seed)
    L = local.astype(np.int64)
    kind = np.arange(n) % 5
    up = (g.random((n, M)) < 0.05).astype(np.int64)
    down = ((g.random((n, M)) < 0.05) & (L > 0)).astype(np.int64)
    rows = np.repeat(L[None], n, axis=0)
    rows[kind == 0] -= down[kind == 0]
    rows[kind == 1] += up[kind == 1]
    rows[kind == 3] += up[kind == 3] - down[kind == 3]
    rows[kind == 4] = g.poisson(1.0, ((kind == 4).sum(), M))
    nz = int(np.flatnonzero(L > 0)[0])
    rows[0, (nz + 1) % M] += 300             # span > 255, forked
    rows[0, nz] -= 1
    rows[1, 3] += 400                        # span > 255, descendant
    rows[2] = L + (2 ** 31 - 2000)           # near-wrap base
    rows[3] = L - (2 ** 31 + 5)              # wrapped negative base
    return as_i32(rows)


def clocks_of(rows):
    jc = {f"p{i}": jbc.BloomClock(jnp.asarray(r), jnp.zeros((), jnp.int32), K)
          for i, r in enumerate(rows)}
    tc = {f"p{i}": tbc.BloomClock(torch.as_tensor(r), torch.zeros((), dtype=torch.int32), K)
          for i, r in enumerate(rows)}
    return jc, tc


def state_of(jreg) -> dict:
    """The JAX registry's state as numpy arrays."""
    return {
        "cells_u8": np.asarray(jreg.cells_u8), "base": np.asarray(jreg.base),
        "sums": np.asarray(jreg.sums), "alive": np.asarray(jreg.alive),
        "slot_of": dict(jreg._slot_of),
        "wide": {s: np.asarray(r) for s, r in jreg._wide.items()},
        "crc": jreg._crc_host.copy(), "free": list(jreg._free),
    }


def assert_registries_equal(jreg, treg):
    np.testing.assert_array_equal(treg.cells_u8.numpy(), np.asarray(jreg.cells_u8))
    np.testing.assert_array_equal(treg.base.numpy(), np.asarray(jreg.base))
    np.testing.assert_array_equal(treg.sums.numpy(), np.asarray(jreg.sums))
    np.testing.assert_array_equal(treg.alive.numpy(), np.asarray(jreg.alive))
    np.testing.assert_array_equal(treg._alive_host, jreg._alive_host)
    np.testing.assert_array_equal(treg._base_host, jreg._base_host)
    np.testing.assert_array_equal(treg._crc_host, jreg._crc_host)
    assert treg._slot_of == jreg._slot_of
    assert treg._free == jreg._free
    assert sorted(treg._wide) == sorted(jreg._wide)
    for s in jreg._wide:
        np.testing.assert_array_equal(treg._wide[s], jreg._wide[s])


def assert_views_equal(jview, tview):
    np.testing.assert_array_equal(tview.status, jview.status)
    np.testing.assert_array_equal(tview.alive, jview.alive)
    np.testing.assert_array_equal(np.asarray(tview.sums), np.asarray(jview.sums))
    assert_fp_close(tview.fp, jview.fp)
    assert tview.local_sum == jview.local_sum
    assert tview.engine == jview.engine


@pytest.fixture(scope="module")
def fleet():
    """Both runtimes ticked alike, plus seeded peer rows around them."""
    jrt, trt = runtimes()
    local = np.asarray(jrt.clock.logical_cells())
    np.testing.assert_array_equal(trt.clock.logical_cells().numpy(), local)
    return peer_rows(local)


def registries(rows, **obs):
    jreg = jreg_mod.ClockRegistry(CAP, M, K, policy=jpolicy(observer=obs.get("jobs")))
    jc, tc = clocks_of(rows)
    jreg.admit_many(jc)
    treg = treg_mod.ClockRegistry(CAP, M, K, policy=tpolicy(observer=obs.get("tobs")),
                                  device=CPU)
    treg.admit_many(tc)
    return jreg, treg, jc, tc


# ---------------------------------------------------------------------------
# state carried across
# ---------------------------------------------------------------------------

def test_registry_admit_matches_reference(fleet):
    jreg, treg, _, _ = registries(fleet)
    assert len(jreg._wide) == 4              # two wide spans, two near-wrap
    assert_registries_equal(jreg, treg)


def test_convert_carries_registry_clock_history(fleet):
    jreg, _, _, _ = registries(fleet)
    jreg.evict_many(["p5", "p9"])
    treg = convert.registry_from_state(state_of(jreg), M, K, policy=tpolicy(),
                                       device=CPU)
    assert_registries_equal(jreg, treg)
    jrt, _ = runtimes()
    c = convert.clock_from_state(np.asarray(jrt.clock.cells),
                                 np.asarray(jrt.clock.base), K, device=CPU)
    np.testing.assert_array_equal(c.logical_cells().numpy(),
                                  np.asarray(jrt.clock.logical_cells()))
    h = convert.history_from_state(np.asarray(jrt.history.cells),
                                   np.asarray(jrt.history.sums),
                                   np.asarray(jrt.history.count), K, device=CPU)
    np.testing.assert_array_equal(h.cells.numpy(), np.asarray(jrt.history.cells))
    assert int(h.count) == int(jrt.history.count)


# ---------------------------------------------------------------------------
# classify
# ---------------------------------------------------------------------------

def test_engine_classify_i32_and_packed(fleet):
    jrt, trt = runtimes()
    jeng, teng = jcausal.CausalEngine(jpolicy()), tcausal.CausalEngine(tpolicy())
    rows = fleet[4:]                          # no promoted rows: int32 slab
    jres = jeng.classify(jrt.clock, jnp.asarray(rows))
    tres = teng.classify(trt.clock, torch.as_tensor(rows))
    assert tres.engine == jres.engine == "i32"
    for f in ("q_le_p", "p_le_q", "sum_q", "sum_p"):
        np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                      np.asarray(getattr(jres, f)))
    assert_fp_close(tres.claimed_fp().numpy(), np.asarray(jres.claimed_fp()))
    jreg, treg, _, _ = registries(fleet)
    jres = jax_host(jeng.classify(jrt.clock, jreg._slab()))
    tres = teng.classify(trt.clock, treg._slab()).to_host()
    assert tres.engine == jres.engine == "packed+wide_overlay"
    assert tres.blocks == jres.blocks
    np.testing.assert_array_equal(tres.equal(), jres.equal())
    np.testing.assert_array_equal(tres.concurrent(), jres.concurrent())
    np.testing.assert_array_equal(tres.confident(1e-4), jres.confident(1e-4))
    assert_fp_close(tres.fp_before(), jres.fp_before())
    assert_fp_close(tres.fp_after(), jres.fp_after())


def jax_host(res):
    import jax
    return jax.device_get(res)


def test_classify_all_with_promoted_rows(fleet):
    jrt, trt = runtimes()
    jreg, _, _, _ = registries(fleet)
    treg = convert.registry_from_state(state_of(jreg), M, K, policy=tpolicy(),
                                       device=CPU)
    jview, tview = jrt.classify_fleet(jreg), trt.classify_fleet(treg)
    assert_views_equal(jview, tview)
    assert tview.counts() == jview.counts()
    assert tview.counts()["forked"] > 0 and tview.counts()["descendant"] > 0
    assert tview.counts()["ancestor"] > 0 and tview.counts()["same"] > 0


def test_compare_matches_reference(fleet):
    jc, tc = clocks_of(fleet[4:8])
    jrt, trt = runtimes()
    for pid in jc:
        jcmp = jcausal.compare(jc[pid], jrt.clock)
        tcmp = tcausal.compare(tc[pid], trt.clock)
        assert bool(tcmp.before()) == bool(jcmp.before())
        assert bool(tcmp.after()) == bool(jcmp.after())
        assert bool(tcmp.confident(1e-4)) == bool(jcmp.confident(1e-4))
        assert float(tcmp.sum_a) == float(jcmp.sum_a)


# ---------------------------------------------------------------------------
# runtime receive path
# ---------------------------------------------------------------------------

def test_runtime_lineage_and_admit_merge(fleet):
    jrt, trt = runtimes()
    jc, tc = clocks_of(fleet)
    for pid in list(jc)[:20]:
        js, jfp = jrt.lineage(jc[pid])
        ts, tfp = trt.lineage(tc[pid])
        assert ts == js
        assert_fp_close([tfp], [jfp])
        jout, tout = jrt.admit_merge(jc[pid]), trt.admit_merge(tc[pid])
        assert tout[:2] == jout[:2]
        assert_fp_close([tout[2]], [jout[2]])
        np.testing.assert_array_equal(trt.clock.logical_cells().numpy(),
                                      np.asarray(jrt.clock.logical_cells()))
    assert twire.encode_clock(trt.snapshot()) == jwire.encode_clock(jrt.snapshot())
    older_j, older_t = runtimes(n_ticks=30)
    assert trt.admit_restore(older_t.clock)[:2] == jrt.admit_restore(older_j.clock)[:2]
    assert_fp_close([trt.refined_fp(older_t.clock)], [jrt.refined_fp(older_j.clock)])
    sums = np.array([10.0, 200.0, 205.0, 210.0])
    np.testing.assert_array_equal(trt.straggler_mask(sums), jrt.straggler_mask(sums))
    snap = jrt.snapshot()
    np.testing.assert_array_equal(
        trt.clock_from_snapshot(snap).logical_cells().numpy(),
        np.asarray(jrt.clock_from_snapshot(snap).logical_cells()))


def test_runtime_classify_matches_reference(fleet):
    """``_classify`` (one kernel call, one wait for the card) returns the
    reference's status, fp and merged cells for every kind of peer."""
    jrt, trt = runtimes()
    jc, tc = clocks_of(fleet)
    seen = set()
    for pid in jc:
        js, jfp, jmerged = jrt._classify(jc[pid])
        ts, tfp, tmerged = trt._classify(tc[pid])
        assert ts == js, pid
        assert_fp_close([tfp], [jfp])
        assert isinstance(tmerged, np.ndarray) and tmerged.dtype == np.int32
        np.testing.assert_array_equal(tmerged, np.asarray(jmerged))
        seen.add(ts)
    assert seen == {"ancestor", "descendant", "same", "forked"}


# ---------------------------------------------------------------------------
# gossip
# ---------------------------------------------------------------------------

def test_three_gossip_rounds_match(fleet):
    jrt, trt = runtimes()
    jreg, treg, _, _ = registries(fleet)
    jcfg = jgossip.GossipConfig(policy=jpolicy(), straggler_gap=64.0)
    tcfg = tgossip.GossipConfig(policy=tpolicy(), straggler_gap=64.0)
    jlocal, tlocal = jrt.clock, trt.clock
    for _ in range(3):
        jlocal, jrep = jgossip.gossip_round(jreg, jlocal, jcfg)
        tlocal, trep = tgossip.gossip_round(treg, tlocal, tcfg)
        for f in ("accepted", "quarantined", "stragglers", "unconfident"):
            np.testing.assert_array_equal(getattr(trep, f), getattr(jrep, f))
        assert_views_equal(jrep.view, trep.view)
        assert trep.pushback_bytes == jrep.pushback_bytes
        assert trep.wire_bytes == jrep.wire_bytes
        np.testing.assert_array_equal(tlocal.cells.numpy(), np.asarray(jlocal.cells))
        np.testing.assert_array_equal(tlocal.base.numpy(), np.asarray(jlocal.base))
        assert_registries_equal(jreg, treg)
    assert trep.n_accepted > 0 and trep.quarantined.any()


def test_gossip_verify_rows_quarantines_corrupt_row(fleet):
    jrt, trt = runtimes()
    jreg, treg, _, _ = registries(fleet)
    slot = jreg.slot_of("p9")
    jreg.cells_u8 = jreg.cells_u8.at[slot, 0].set(jreg.cells_u8[slot, 0] ^ 1)
    treg.cells_u8[slot, 0] ^= 1
    jcfg = jgossip.GossipConfig(policy=jpolicy(), verify_rows=True)
    tcfg = tgossip.GossipConfig(policy=tpolicy(), verify_rows=True)
    _, jrep = jgossip.gossip_round(jreg, jrt.clock, jcfg)
    _, trep = tgossip.gossip_round(treg, trt.clock, tcfg)
    assert trep.corrupted == jrep.corrupted == ("p9",)
    assert not trep.view.alive[slot]
    for f in ("accepted", "quarantined", "stragglers", "unconfident"):
        np.testing.assert_array_equal(getattr(trep, f), getattr(jrep, f))
    assert_registries_equal(jreg, treg)


def test_runtime_gossip_with_audit_matches_and_replays(fleet):
    jobs = JObserver(audit=JAuditTrail(store_frames=True))
    tobs = TObserver(audit=TAuditTrail(store_frames=True))
    jrt, trt = runtimes(jobs=jobs, tobs=tobs)
    jreg, treg = jrt.make_registry(CAP), trt.make_registry(CAP)
    jc, tc = clocks_of(fleet)
    jreg.admit_many(jc)
    treg.admit_many(tc)
    jrep, trep = jrt.gossip(jreg), trt.gossip(treg)
    np.testing.assert_array_equal(trep.accepted, jrep.accepted)
    jrecs, trecs = jobs.audit.verdicts(), tobs.audit.verdicts()
    assert len(trecs) == len(jrecs) > 0
    for jr, tr in zip(jrecs, trecs):
        assert (tr.peer_id, tr.verdict, tr.action, tr.local_crc, tr.peer_crc) == \
            (jr.peer_id, jr.verdict, jr.action, jr.local_crc, jr.peer_crc)
        assert tr.peer_frame == jr.peer_frame and tr.local_frame == jr.local_frame
    rep = tobs.audit.replay_frames(policy=tpolicy(), device=CPU)
    assert rep.ok and rep.matched == rep.checked == len(trecs)


def test_evict_quarantine_and_integrity_match(fleet):
    jreg, treg, jc, tc = registries(fleet)
    for reg in (jreg, treg):
        reg.evict_many(["p7", "p1", "p7"])
    jreg.admit("p7", jc["p8"])
    treg.admit("p7", tc["p8"])
    assert_registries_equal(jreg, treg)
    slot = treg.slot_of("p9")
    treg.cells_u8[slot, 0] ^= 1               # bit rot in one packed row
    assert treg.check_integrity() == ["p9"]
    treg.quarantine_rows(["p9"])
    assert not treg.row_alive("p9") and "p9" in treg
    treg.update("p9", tc["p9"])
    assert treg.row_alive("p9") and treg.check_integrity() == []


# ---------------------------------------------------------------------------
# simulators
# ---------------------------------------------------------------------------

def test_gossip_sim_loopback_matches():
    cfg_j = jsim.SimConfig(n_nodes=6, n_events=200, m=64, k=3)
    cfg_t = tsim.SimConfig(n_nodes=6, n_events=200, m=64, k=3)
    jres = jsim.run_gossip_sim(cfg_j)
    tres = tsim.run_gossip_sim(cfg_t, device=CPU)
    assert tres.false_negatives == jres.false_negatives == 0
    for f in ("rounds", "claims", "false_positives", "merges", "quarantines",
              "pushback_bytes", "within_eq3_band"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert_fp_close([tres.mean_predicted_fp], [jres.mean_predicted_fp])


def test_run_sim_matches():
    cfg = dict(n_nodes=5, n_events=300, m=32, k=3, sample_pairs=2000)
    jres, tres = jsim.run_sim(jsim.SimConfig(**cfg)), tsim.run_sim(tsim.SimConfig(**cfg))
    assert tres.false_negatives == 0
    for f in ("false_negatives", "true_concurrent", "true_positives",
              "false_positives", "measured_fp_rate", "n_pairs_scored"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert_fp_close([tres.mean_predicted_fp], [jres.mean_predicted_fp])


# ---------------------------------------------------------------------------
# entry points run on the card unless asked for the CPU
# ---------------------------------------------------------------------------

def test_entry_points_ask_for_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trt_mod.ClockRuntime(trt_mod.ClockConfig(m=64))
    with pytest.raises(RuntimeError, match="CUDA"):
        treg_mod.ClockRegistry(8, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.run_gossip_sim(tsim.SimConfig(n_nodes=3, n_events=10))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdevice.resolve_device(None) == torch.device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
