"""The port's model serving (``repro_torch.serving.engine``,
``repro_torch.launch.serve``) against the JAX package's on the CPU, and
the ``ClockRuntime.causal``/``obs`` surface it depends on.

A JAX ``ServingEngine`` and the port's are built on the same weights
(the JAX package's ``init_params``, carried across by
``convert.params_from_jax``) and driven through the same sequence.
Identical: sids, greedy tokens, engine and session clock cells, the
session registry's rows, ``can_adopt`` statuses, ``adopt`` and
``adopt_many`` masks, and audit records (verdict, action, engine,
CRCs, sums).  Eq. 3 fp within a relative 5e-2 (libm ulps across the
two frameworks, ROADMAP.md queue 3).  The model runs in float32 here,
so greedy argmax has no near-tie to break differently.
"""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.causal.policy import CausalPolicy as JPolicy  # noqa: E402
from repro.core import clock as jbc  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.obs import AuditTrail as JTrail  # noqa: E402
from repro.obs import Observer as JObserver  # noqa: E402
from repro.runtime import clock_runtime as jrt  # noqa: E402
from repro.serving import engine as jse  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.causal import CausalEngine  # noqa: E402
from repro_torch.causal.policy import CausalPolicy as TPolicy  # noqa: E402
from repro_torch.core import clock as tbc  # noqa: E402
from repro_torch.obs import AuditTrail as TTrail  # noqa: E402
from repro_torch.obs import Observer as TObserver  # noqa: E402
from repro_torch.runtime import clock_runtime as trt  # noqa: E402
from repro_torch.serving import engine as tse  # noqa: E402

FP_RTOL = 5e-2
CPU = "cpu"
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
I32_MAX = 2 ** 31 - 1


@pytest.fixture(scope="module")
def model():
    """The qwen smoke config in float32 and its weights, in both
    packages (built once for the module: the JAX init compiles)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen1_5_0_5b"),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("qwen1_5_0_5b"),
                               dtype="float32")
    jp = JP.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                 tcfg, device=CPU)
    return jcfg, tcfg, jp, tp


class Pair:
    """A JAX and a port engine on the same weights and configs."""

    def __init__(self, model, replica_id, m=256, threshold=1.0 - 1e-6,
                 audit=False, max_seq=64, max_batch=8):
        jcfg, tcfg, jp, tp = model
        self.jtrail = JTrail(store_frames=True) if audit else None
        self.ttrail = TTrail(store_frames=True) if audit else None
        jpol = JPolicy(fp_threshold=threshold,
                       observer=JObserver(audit=self.jtrail) if audit else None)
        tpol = TPolicy(fp_threshold=threshold,
                       observer=TObserver(audit=self.ttrail) if audit else None)
        self.j = jse.ServingEngine(
            jp, jcfg, jse.ServeConfig(max_batch=max_batch, max_seq=max_seq),
            jrt.ClockConfig(m=m, fp_threshold=threshold, policy=jpol),
            replica_id=replica_id)
        self.t = tse.ServingEngine(
            tp, tcfg, tse.ServeConfig(max_batch=max_batch, max_seq=max_seq),
            trt.ClockConfig(m=m, fp_threshold=threshold, policy=tpol),
            replica_id=replica_id, device=CPU)

    def admit(self, prompts):
        js = self.j.admit(jnp.asarray(prompts))
        ts = self.t.admit(torch.from_numpy(prompts))
        assert ts["sid"] == js["sid"] and ts["pos"] == js["pos"]
        return js, ts

    def assert_same_clocks(self, sessions=()):
        same_cells(self.j.clock.clock, self.t.clock.clock, "engine clock")
        for js, ts in sessions:
            same_cells(js["clock"].clock, ts["clock"].clock, js["sid"])
        assert_same_registry(self.j.sessions, self.t.sessions)
        assert self.t._session_order == self.j._session_order


def cells(clock) -> np.ndarray:
    c = clock.logical_cells()
    return (c.cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c))


def same_cells(jclock, tclock, what):
    np.testing.assert_array_equal(cells(tclock), cells(jclock), err_msg=what)


def assert_same_registry(j, t):
    assert t._slot_of == j._slot_of
    for name in ("cells_u8", "base", "sums", "alive"):
        np.testing.assert_array_equal(getattr(t, name).cpu().numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert sorted(t._wide) == sorted(j._wide)
    for slot in j._wide:
        np.testing.assert_array_equal(t._wide[slot], j._wide[slot])
    np.testing.assert_array_equal(t._crc_host, j._crc_host)


def assert_fp_close(t, j):
    t, j = float(t), float(j)
    if max(abs(t), abs(j)) > 1e-30:
        assert abs(t - j) <= FP_RTOL * max(abs(t), abs(j)), (t, j)


def prompts(seed, vocab, B=2, S=8):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# the ClockRuntime repair
# ---------------------------------------------------------------------------

def test_clock_runtime_exposes_causal_and_obs():
    trail = TTrail()
    pol = TPolicy(fp_threshold=0.5, observer=TObserver(audit=trail))
    rt = trt.ClockRuntime(trt.ClockConfig(m=64, policy=pol), device=CPU)
    jrt_ = jrt.ClockRuntime(jrt.ClockConfig(
        m=64, policy=JPolicy(fp_threshold=0.5)))
    assert isinstance(rt.causal, CausalEngine)
    assert rt.causal.policy is rt.policy and rt.obs is rt.causal.obs
    assert rt.obs.audit is trail
    for i in range(5):
        rt.tick("e", i)
        jrt_.tick("e", i)
    rng = np.random.default_rng(0)
    peers = cells(jrt_.clock)[None] + rng.integers(-1, 2, (6, 64))
    peers[0] = cells(jrt_.clock)
    peers = peers.astype(np.int32)
    tres = rt.causal.classify(rt.clock, torch.from_numpy(peers)).to_host()
    jres = jax.device_get(jrt_.causal.classify(jrt_.clock, jnp.asarray(peers)))
    assert tres.engine == jres.engine == "i32"
    for key in ("q_le_p", "p_le_q", "sum_p"):
        np.testing.assert_array_equal(getattr(tres, key),
                                      np.asarray(getattr(jres, key)), key)
    for a, b in zip(tres.fp_after(), np.asarray(jres.fp_after())):
        assert_fp_close(a, b)
    # the default observer is the null one in both
    bare = trt.ClockRuntime(trt.ClockConfig(m=64), device=CPU)
    assert not bare.obs and not jrt.ClockRuntime(jrt.ClockConfig(m=64)).obs


# ---------------------------------------------------------------------------
# engines driven side by side
# ---------------------------------------------------------------------------

def test_engine_sequence_matches_reference(model):
    """Admit, decode, migrate and audit: everything the engines decide
    is identical."""
    vocab = model[0].vocab
    a = Pair(model, "A", audit=True)
    s1 = a.admit(prompts(1, vocab))
    tok_j = np.asarray(a.j.generate(s1[0], 5))
    tok_t = a.t.generate(s1[1], 5)
    assert tok_t.dtype == torch.int32 and tok_t.shape == (2, 5)
    np.testing.assert_array_equal(tok_t.numpy(), tok_j)
    s2 = a.admit(prompts(2, vocab, B=3, S=6))
    np.testing.assert_array_equal(a.t.generate(s2[1], 3).numpy(),
                                  np.asarray(a.j.generate(s2[0], 3)))
    a.assert_same_clocks([s1, s2])
    np.testing.assert_allclose(s1[1]["last_logits"].numpy(),
                               np.asarray(s1[0]["last_logits"]),
                               rtol=1e-5, atol=1e-5)

    # replica B saw A's history: it may adopt A's sessions
    b = Pair(model, "B", audit=True)
    for side in ("j", "t"):
        eng = getattr(b, side)
        src = getattr(a, side)
        bc = jbc if side == "j" else tbc
        eng.clock.tick("own", 1)
        eng.clock.clock = bc.merge(eng.clock.clock, src.clock.clock)
    for js, ts in (s1, s2):
        jv, tv = b.j.can_adopt(js), b.t.can_adopt(ts)
        assert tv[:2] == jv[:2] and tv[0], (tv, jv)
        assert_fp_close(tv[2], jv[2])
    # a session from the future (A ticked after B merged) is refused
    s3 = a.admit(prompts(3, vocab))
    a.j.generate(s3[0], 2)
    a.t.generate(s3[1], 2)
    mj = b.j.adopt_many([s1[0], s3[0], s2[0]])
    mt = b.t.adopt_many([s1[1], s3[1], s2[1]])
    assert list(mt) == list(mj) == [True, False, True]
    b.assert_same_clocks()
    assert b.t.adopt(s3[1]) == b.j.adopt(s3[0]) is False

    rj, rt_ = b.jtrail.verdicts(), b.ttrail.verdicts()
    assert len(rt_) == len(rj) == 4
    for x, y in zip(rt_, rj):
        for key in ("seq", "kind", "peer_id", "verdict", "action", "engine",
                    "local_crc", "peer_crc", "local_sum", "peer_sum",
                    "transport", "threshold", "local_frame", "peer_frame"):
            assert getattr(x, key) == getattr(y, key), key
        assert_fp_close(x.fp, y.fp)
    # engine C never saw the sessions' history: it refuses (forked)
    c = Pair(model, "C")
    c.j.clock.tick("own-history")
    c.t.clock.tick("own-history")
    for js, ts in (s1, s2):
        jv, tv = c.j.can_adopt(js), c.t.can_adopt(ts)
        assert tv[:2] == jv[:2] == (False, trt.LineageStatus.FORKED)


def test_temperature_sampling_is_seeded(model):
    _, tcfg, _, tp = model
    logits = torch.randn(4, tcfg.vocab, generator=torch.Generator().manual_seed(0))

    def eng(seed):
        return tse.ServingEngine(tp, tcfg, tse.ServeConfig(temperature=0.7,
                                                           seed=seed),
                                 trt.ClockConfig(m=64), device=CPU)

    e1, e2 = eng(5), eng(5)
    assert torch.equal(e1._sample(logits, 3), e2._sample(logits, 3))
    draws = torch.stack([e1._sample(logits, s) for s in range(8)])
    assert draws.dtype == torch.int32 and len(set(draws[:, 0].tolist())) > 1
    assert not torch.equal(draws, torch.stack([eng(6)._sample(logits, s)
                                               for s in range(8)]))
    greedy = tse.ServingEngine(tp, tcfg, tse.ServeConfig(), trt.ClockConfig(m=64),
                               device=CPU)
    assert torch.equal(greedy._sample(logits, 0),
                       logits.argmax(-1).to(torch.int32))


# ---------------------------------------------------------------------------
# the reference's serving cases, mirrored
# ---------------------------------------------------------------------------

def test_adopt_many_merge_survives_int32_wrap(model):
    """``tests/test_serve_pipeline.py``'s int32-wrap case on both
    engines: a sane ancestor peer is adopted and the bulk merge keeps
    the local clock's mod-2^32 position."""
    M = 32
    p = Pair(model, "rim", m=M, threshold=1.0, max_seq=32)
    wrapped = np.uint64(I32_MAX) + np.uint64(21)     # 2**31 + 20
    local_u32 = np.full(M, wrapped, np.uint64)
    local_i32 = local_u32.astype(np.uint32).view(np.int32)
    p.j.clock.clock = jbc.BloomClock(cells=jnp.asarray(local_i32),
                                     base=jnp.zeros((), jnp.int32), k=4)
    p.t.clock.clock = tbc.BloomClock(cells=torch.from_numpy(local_i32.copy()),
                                     base=torch.zeros((), dtype=torch.int32),
                                     k=4)
    jpeer = jbc.BloomClock(cells=jnp.full((M,), 100, jnp.int32),
                           base=jnp.zeros((), jnp.int32), k=4)
    tpeer = tbc.BloomClock(cells=torch.full((M,), 100, dtype=torch.int32),
                           base=torch.zeros((), dtype=torch.int32), k=4)
    mj = p.j.adopt_many([{"clock": types.SimpleNamespace(clock=jpeer)}])
    mt = p.t.adopt_many([{"clock": types.SimpleNamespace(clock=tpeer)}])
    assert list(mt) == list(mj) == [True]
    after = cells(p.t.clock.clock).astype(np.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(after, local_u32.astype(np.int64))
    p.assert_same_clocks()


def test_adopt_routes_through_batched_classify_audit(model):
    """``tests/test_serve_pipeline.py``'s audit case: single-session
    adopt() is the batch-of-one path, its record carries the real
    engine label, and the trail replays clean, in both packages."""
    p = Pair(model, "A", m=32, threshold=1.0, audit=True, max_seq=32)
    for side, mod, bc in (("j", jrt, jbc), ("t", trt, tbc)):
        eng = getattr(p, side)
        eng.clock.tick("warm", 1)
        kw = {} if side == "j" else {"device": CPU}
        peer = mod.ClockRuntime(eng.clock.cfg, run_id="serve", **kw)
        peer.clock = bc.merge(peer.clock, eng.clock.clock)
        assert eng.adopt({"clock": peer})
    jr = [r for r in p.jtrail.verdicts() if r.transport == "serving"]
    tr = [r for r in p.ttrail.verdicts() if r.transport == "serving"]
    assert tr and tr[-1].action == "adopt" and tr[-1].engine == jr[-1].engine
    assert (tr[-1].local_crc, tr[-1].peer_crc) == (jr[-1].local_crc,
                                                   jr[-1].peer_crc)
    rep = p.ttrail.replay_frames(
        policy=dataclasses.replace(p.t.clock.policy, observer=None),
        device=CPU)
    assert rep.matched == rep.checked and not rep.mismatches
    p.assert_same_clocks()


def test_generate_and_migration_guard(model):
    """``tests/test_integration.py``'s migration guard on the port: B,
    which merged A's clock, adopts A's session; C refuses it."""
    _, tcfg, _, tp = model
    c_cfg = trt.ClockConfig(m=256, fp_threshold=1.0 - 1e-6)
    eng_a = tse.ServingEngine(tp, tcfg, tse.ServeConfig(max_seq=64), c_cfg,
                              replica_id="A", device=CPU)
    sess = eng_a.admit(torch.from_numpy(prompts(4, tcfg.vocab)))
    assert eng_a.generate(sess, 4).shape == (2, 4)
    eng_b = tse.ServingEngine(tp, tcfg, tse.ServeConfig(max_seq=64), c_cfg,
                              replica_id="B", device=CPU)
    eng_b.clock.clock = tbc.merge(eng_b.clock.clock, eng_a.clock.clock)
    ok, status, _ = eng_b.can_adopt(sess)
    assert ok, status
    eng_c = tse.ServingEngine(tp, tcfg, tse.ServeConfig(max_seq=64), c_cfg,
                              replica_id="C", device=CPU)
    eng_c.clock.tick("own-history")
    ok2, status2, _ = eng_c.can_adopt(sess)
    assert not ok2 and status2 == trt.LineageStatus.FORKED
    mask = eng_b.adopt_many([sess])
    assert list(mask) == [True]
    assert sess["sid"] in eng_b.sessions


def test_session_registry_bounded_and_releasable(model):
    """``tests/test_integration.py``'s bounded registry, on both engines
    side by side: FIFO eviction at capacity, release, adopt writes the
    minted sid back (capacity 16: ``max(16, 8 * max_batch)``)."""
    p = Pair(model, "A", m=128, max_batch=2)
    cap = p.t.sessions.capacity
    assert cap == p.j.sessions.capacity
    pr = prompts(5, model[0].vocab, S=4)
    last = None
    for _ in range(cap + 3):
        last = p.admit(pr)
    assert len(p.t.sessions) == len(p.j.sessions) == cap
    assert last[1]["sid"] in p.t.sessions
    p.assert_same_clocks()
    p.j.release(last[0])
    p.t.release(last[1])
    assert last[1]["sid"] not in p.t.sessions
    assert len(p.t.sessions) == cap - 1
    migrated_j, migrated_t = {"clock": last[0]["clock"]}, {"clock": last[1]["clock"]}
    assert p.j.adopt(migrated_j) and p.t.adopt(migrated_t)
    assert migrated_t["sid"] == migrated_j["sid"]
    assert migrated_t["sid"] in p.t.sessions
    p.assert_same_clocks()


# ---------------------------------------------------------------------------
# the launcher, in a process that cannot import JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--tiered", "--hybrid"]])
def test_serve_launcher_smoke_without_jax(tmp_path, extra):
    fake = tmp_path / "nojax" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(
        "raise ImportError('this process must not import jax')\n")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(fake.parent), SRC])}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--gen", "4", *extra],
        env=env, capture_output=True, text=True, timeout=120)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "[serve] qwen0.5-smoke on cpu: prefill 4x32" in out
    assert "[serve] engine clock sum: 32" in out      # (4 admits + 4 tokens) x k
    assert "must not import jax" not in out
    if extra:
        assert "[serve] tiered admission: same" in out
        assert "[serve] hybrid classify[" in out
