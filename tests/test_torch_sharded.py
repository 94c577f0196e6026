"""The mesh-sharded fleet registry of the port against its unsharded slab
and against the JAX package's sharded registry, on the CPU.

It mirrors ``tests/test_sharded_fleet.py`` at its sizes (capacity 32,
m 192, k 3).  The port's mesh places every shard on the CPU
(``make_fleet_mesh(s, device="cpu")``), so each shard runs the kernels'
plain versions; the JAX side runs its shard_map'ed kernels over the 8
forced host devices ``tests/conftest.py`` sets up (``host_devices``).

The all-pairs group holds the port's ring (the default strategy) at 1,
2, 3, 4 and 8 shards against the JAX ring at the same count, through
``ops._compare_matrix_packed_sharded`` and through registries with dead
slots and promoted rows, beside the port's "replicated" strategy and
its unsharded slab; a private autotune table names "replicated" where a
test needs it.

Tolerances: across the port's shard counts everything is exact
(statuses, flags, sums, fp bits, cells, wire bytes).  Against the JAX
package: statuses, flags, integers and float32 sums identical; the
one-vs-many fp bit-identical; all-pairs fp within a relative 5e-2
(values at or below the 1e-30 clip floor count as equal).  Both sides
pin bm = 512.

The last group holds the reference's public names that the port gained
with this slice (``CausalPolicy.merged``, ``FleetView.slots``,
``ClockRegistry.cells``, ``BloomClock.sum``, ``core.clock.compare``,
``FleetHealth.mean_predicted_fp``, ``core.sim.monte_carlo_overlap``,
``EvictedRow``), each against the reference.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import causal as jcausal  # noqa: E402
from repro.core import clock as jbc  # noqa: E402
from repro.core import sim as jsim  # noqa: E402
from repro.fleet import ClockRegistry as JRegistry  # noqa: E402
from repro.fleet import GossipConfig as JGossipConfig  # noqa: E402
from repro.fleet import fleet_health as jfleet_health  # noqa: E402
from repro.fleet import gossip_round as jgossip_round  # noqa: E402
from repro.launch.mesh import make_fleet_mesh as jmake_fleet_mesh  # noqa: E402
from repro_torch import causal as tcausal  # noqa: E402
from repro_torch import convert, sharding  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.core import clock as tbc  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.fleet import ClockRegistry as TRegistry  # noqa: E402
from repro_torch.fleet import GossipConfig as TGossipConfig  # noqa: E402
from repro_torch.fleet import fleet_health as tfleet_health  # noqa: E402
from repro_torch.fleet import gossip_round as tgossip_round  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh, mesh_axes  # noqa: E402
from repro_torch.runtime import ClockConfig, ClockRuntime  # noqa: E402

SHARD_COUNTS = (1, 2, 4, 8)
CAP, M, K = 32, 192, 3
FP_RTOL = 5e-2
FP_FLOOR = 1e-30
CPU = "cpu"


def host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_fp_close(a, b):
    a, b = host(a).astype(np.float64), host(b).astype(np.float64)
    assert a.shape == b.shape
    keep = ~((a == b) | ((np.abs(a) <= FP_FLOOR) & (np.abs(b) <= FP_FLOOR)))
    np.testing.assert_allclose(a[keep], b[keep], rtol=FP_RTOL, atol=0)


def tmesh(shards: int):
    return make_fleet_mesh(shards, device=CPU)


def tpolicy(**kw):
    return tcausal.CausalPolicy(bm=512, bn=8, **kw)


def jpolicy(**kw):
    return jcausal.CausalPolicy(bm=512, bn=8, autotune=False, **kw)


def random_rows(seed: int, cap: int = CAP, m: int = M) -> np.ndarray:
    """Peer rows with per-row offsets (non-uniform §4 bases), as the
    reference's harness makes them."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 20, (cap, m)) + rng.integers(0, 300, (cap, 1))


def wide_row(at, value: int) -> np.ndarray:
    row = np.zeros(M, np.int64)
    row[at] = value
    return row


def tclock(row) -> tbc.BloomClock:
    return tbc.BloomClock(torch.as_tensor(np.asarray(row, np.int32)),
                          torch.zeros((), dtype=torch.int32), K)


def jclock(row) -> jbc.BloomClock:
    return jbc.BloomClock(jnp.asarray(row, jnp.int32),
                          jnp.zeros((), jnp.int32), K)


def peers_of(rows: dict, make) -> dict:
    return {pid: make(r) for pid, r in rows.items()}


def fleet(seed: int, wide: dict | None = None, cap: int = CAP) -> dict:
    rows = random_rows(seed, cap)
    out = {f"peer{i}": rows[i] for i in range(cap)}
    out.update(wide or {})
    return out


def tfilled(rows: dict, shards: int | None = None, cap: int = CAP,
            **kw) -> TRegistry:
    if shards is None:
        reg = TRegistry(cap, M, K, policy=tpolicy(**kw), device=CPU)
    else:
        reg = TRegistry(cap, M, K, mesh=tmesh(shards), policy=tpolicy(**kw))
    reg.admit_many(peers_of(rows, tclock))
    return reg


def jfilled(rows: dict, shards: int | None = None, cap: int = CAP,
            **kw) -> JRegistry:
    mesh = None if shards is None else jmake_fleet_mesh(shards)
    reg = JRegistry(capacity=cap, m=M, k=K, mesh=mesh, policy=jpolicy(**kw))
    reg.admit_many(peers_of(rows, jclock))
    return reg


def plant_strategy(monkeypatch, tmp_path, strategy: str, shard_counts,
                   cap: int = CAP) -> None:
    """A private autotune table whose CPU ``matrix_sharded`` entries name
    ``strategy`` at these shard counts (the registry's shape)."""
    table = {autotune.key_for("matrix_sharded", cap, cap, M, "cpu", d):
             {"strategy": strategy, "bi": 64, "bj": 64, "bm": 512}
             for d in shard_counts}
    path = tmp_path / f"{strategy}.json"
    path.write_text(json.dumps(table))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", str(path))


def evict_some(reg, seed: int, n_evict: int = 5):
    rng = np.random.default_rng(1000 + seed)
    gone = rng.choice(sorted(reg.peer_ids()), size=n_evict, replace=False)
    reg.evict_many(list(gone))


def assert_views_identical(got, ref):
    np.testing.assert_array_equal(got.status, ref.status)
    np.testing.assert_array_equal(got.alive, ref.alive)
    assert (host(got.fp) == host(ref.fp)).all(), "fp must be bit-identical"
    assert (host(got.sums) == host(ref.sums)).all()
    assert got.local_sum == ref.local_sum


def assert_pairs_identical(got, ref):
    got, ref = got.to_host(), ref.to_host()
    for key in ("a_le_b", "b_le_a", "concurrent"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert (got["fp"] == ref["fp"]).all(), "fp must be bit-identical"
    for key in ("row_sums", "col_sums"):
        assert (got[key] == ref[key]).all(), key


def assert_pairs_match_jax(got, jres):
    got = got.to_host()
    for key in ("a_le_b", "b_le_a", "concurrent", "row_sums", "col_sums"):
        np.testing.assert_array_equal(got[key], np.asarray(jres[key]),
                                      err_msg=key)
    assert_fp_close(got["fp"], np.asarray(jres["fp"]))


# ---------------------------------------------------------------------------
# the mesh and the shard helpers
# ---------------------------------------------------------------------------

def test_make_fleet_mesh_places_every_shard_on_the_device_it_is_given():
    mesh = make_fleet_mesh(4, device=CPU)
    assert isinstance(mesh, FleetMesh)
    assert mesh.devices == (torch.device(CPU),) * 4
    assert mesh.shape[sharding.FLEET_AXIS] == 4
    assert mesh_axes(mesh) == ("fleet",)
    assert hash(mesh) == hash(make_fleet_mesh(4, device=CPU))
    assert len(make_fleet_mesh(device=CPU).devices) == 1
    with pytest.raises(ValueError):
        make_fleet_mesh(0, device=CPU)


def test_make_fleet_mesh_refuses_more_cuda_shards_than_cards():
    """Without ``device=`` the mesh takes distinct cards only: asking
    for one more than there are raises, never shares a card or falls
    back to the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA devices"):
        make_fleet_mesh(n + 1)


def test_slot_groups_and_split_rows():
    slots = np.asarray([9, 0, 31, 8, 15, 16])
    groups = sharding.slot_groups(slots, 8)
    assert [g[0] for g in groups] == [0, 1, 2, 3]
    for shard, local, pos in groups:
        np.testing.assert_array_equal(local, slots[pos] % 8)
        assert (slots[pos] // 8 == shard).all()
    assert sorted(np.concatenate([g[2] for g in groups])) == list(range(6))
    assert sharding.shard_rows(17, 8) == (2, 1)
    x = torch.arange(24).reshape(8, 3)
    parts = sharding.split_rows(x, (torch.device(CPU),) * 4)
    assert len(parts) == 4 and torch.equal(torch.cat(parts), x)
    with pytest.raises(ValueError, match="not divisible"):
        sharding.split_rows(x, (torch.device(CPU),) * 3)


def test_policy_carries_the_mesh():
    mesh = tmesh(4)
    pol = tcausal.CausalPolicy(mesh=mesh)
    jpol = jcausal.CausalPolicy(mesh=jmake_fleet_mesh(4))
    assert pol.sharded and pol.shards == 4
    assert not tcausal.CausalPolicy().sharded
    assert tcausal.CausalPolicy().shards == 1
    assert pol.label() == jpol.label()
    assert "shards=4:fleet" in pol.label()
    assert hash(pol) == hash(tcausal.CausalPolicy(mesh=tmesh(4)))


def test_registry_folds_mesh_into_policy():
    reg = TRegistry(CAP, M, K, policy=tcausal.CausalPolicy(mesh=tmesh(2)))
    assert reg.n_shards == 2 and reg.mesh == tmesh(2)
    assert reg.policy.shards == 2 and reg.device == torch.device(CPU)
    assert [sh.cells_u8.shape for sh in reg.shards] == [(CAP // 2, M)] * 2
    assert TRegistry(CAP, M, K, device=CPU).n_shards == 1


def test_registry_capacity_must_divide_shards():
    with pytest.raises(ValueError, match="not divisible"):
        TRegistry(30, M, K, mesh=tmesh(4))


# ---------------------------------------------------------------------------
# the port across shard counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_classify_all_shard_invariance(seed):
    """classify_all at 1, 2, 4, 8 shards is bit-identical to the
    unsharded slab, dead slots included; one packed dispatch over the
    shards at the full-N blocks."""
    rows = fleet(seed)
    local = tbc.merge(tclock(rows["peer0"]), tclock(rows["peer3"]))
    ref_reg = tfilled(rows)
    evict_some(ref_reg, seed)
    ref = ref_reg.classify_all(local)
    for shards in SHARD_COUNTS:
        reg = tfilled(rows, shards)
        assert reg.n_shards == shards
        evict_some(reg, seed)
        got = reg.classify_all(local)
        assert_views_identical(got, ref)
        assert got.engine == "packed_sharded"
        assert tops.LAST_DISPATCH["shards"] == shards
        assert tops.LAST_DISPATCH["bm"] == 512


@pytest.mark.parametrize("alive", ["full", "dead"])
@pytest.mark.parametrize("seed", range(2))
def test_all_pairs_shard_invariance(seed, alive):
    rows = fleet(seed)
    ref_reg = tfilled(rows)
    if alive == "dead":
        evict_some(ref_reg, seed)
    ref = ref_reg.all_pairs()
    for shards in SHARD_COUNTS:
        reg = tfilled(rows, shards)
        if alive == "dead":
            evict_some(reg, seed)
        got = reg.all_pairs()
        assert_pairs_identical(got, ref)
        assert got.engine == "ring_full"
        assert dict(got.blocks)["shards"] == shards
        assert dict(got.blocks)["strategy"] == "ring"


@pytest.mark.parametrize("shards", (2, 8))
def test_sharded_promoted_rows_classify_and_pairs(shards):
    rows = fleet(5, {"peer7": wide_row(slice(None, None, 7), 1000)})
    local = tbc.merge(tclock(rows["peer1"]), tclock(rows["peer2"]))
    ref_reg = tfilled(rows)
    assert not ref_reg.packed
    reg = tfilled(rows, shards)
    assert not reg.packed
    got = reg.classify_all(local)
    assert_views_identical(got, ref_reg.classify_all(local))
    assert got.engine == "packed_sharded+wide_overlay"
    assert_pairs_identical(reg.all_pairs(), ref_reg.all_pairs())
    # and against the reference's sharded registry at the same count
    jreg = jfilled(rows, shards)
    jview = jreg.classify_all(jclock(host(local.logical_cells())))
    np.testing.assert_array_equal(got.status, jview.status)
    np.testing.assert_array_equal(host(got.sums), np.asarray(jview.sums))
    assert (host(got.fp) == np.asarray(jview.fp)).all()


def test_replica_follows_every_mutation(tmp_path, monkeypatch):
    """The gathered replica of the "replicated" strategy (named by the
    table's entry) is memoised on the shards' version counters: an
    all_pairs after a write sees the new rows, and a repeat call without
    one reuses the copy."""
    plant_strategy(monkeypatch, tmp_path, "replicated", (4,))
    rows = fleet(3)
    reg = tfilled(rows, 4)
    ref = tfilled(rows)
    got = reg.all_pairs()
    assert got.engine == "replicated_tri"
    assert_pairs_identical(got, ref.all_pairs())
    n_cached = len(tops._REPLICA_CACHE)
    hit = tops._gathered_replica(reg._slab().cells_u8, reg.device)
    reg.all_pairs()
    assert len(tops._REPLICA_CACHE) == n_cached
    assert tops._gathered_replica(reg._slab().cells_u8, reg.device) is hit
    new = {"peer5": random_rows(77)[0], "peer30": random_rows(78)[1]}
    for r in (reg, ref):
        r.update_many(peers_of(new, tclock))
    assert_pairs_identical(reg.all_pairs(), ref.all_pairs())
    mask = np.zeros(CAP, bool)
    mask[[3, 12, 29]] = True
    for r in (reg, ref):
        r.broadcast(mask, tclock(random_rows(79)[2]))
    assert_pairs_identical(reg.all_pairs(), ref.all_pairs())


def test_ring_strategy_raises():
    """The ring is ported: "ring" and "replicated" give the unsharded
    slab's matrices bit for bit, through the op and its deprecated public
    name; only an unknown strategy or engine raises."""
    reg = tfilled(fleet(2), 4)
    slab = reg._slab()
    ref = tfilled(fleet(2)).all_pairs().to_host()
    kw = dict(mesh=reg.mesh, uniform_base=False)
    for strategy, label in (("ring", "ring_full"),
                            ("replicated", "replicated_tri")):
        out = tops._compare_matrix_packed_sharded(
            slab.cells_u8, slab.base, strategy=strategy, **kw)
        assert tops.LAST_DISPATCH["engine"] == label
        assert tops.LAST_DISPATCH["strategy"] == strategy
        assert tops.LAST_DISPATCH["shards"] == 4
        for key in ("a_le_b", "b_le_a", "concurrent", "fp", "row_sums"):
            assert torch.equal(out[key], torch.as_tensor(ref[key])), key
    with pytest.warns(DeprecationWarning):
        shim = tops.compare_matrix_packed_sharded(slab.cells_u8, slab.base,
                                                  **kw)
    assert torch.equal(shim["a_le_b"], out["a_le_b"])
    assert "compare_matrix_packed_sharded" in tops.__all__
    with pytest.raises(ValueError, match="unknown sharded strategy"):
        tops._compare_matrix_packed_sharded(slab.cells_u8, slab.base,
                                            strategy="tree", **kw)
    with pytest.raises(ValueError, match="unknown packed engine"):
        tops._compare_matrix_packed_sharded(slab.cells_u8, slab.base,
                                            engine="tree", **kw)
    with pytest.raises(ValueError, match="row shards"):
        tops._compare_matrix_packed_sharded(slab.cells_u8[:3], slab.base,
                                            **kw)


def test_mutations_write_each_row_to_its_owning_shard():
    rows = fleet(9)
    reg = tfilled(rows, 4)
    ref = tfilled(rows)
    for r in (reg, ref):
        evict_some(r, 9)
        r.quarantine_rows(sorted(r.peer_ids())[1:4])
    for name in ("cells_u8", "base", "sums", "alive"):
        np.testing.assert_array_equal(host(getattr(reg, name)),
                                      host(getattr(ref, name)), err_msg=name)
        whole = torch.cat([getattr(sh, name) for sh in reg.shards])
        assert torch.equal(whole, getattr(reg, name))
    assert torch.equal(reg.cells, ref.cells)
    assert reg.check_integrity() == ref.check_integrity() == []
    for pid in ("peer0", "peer8", "peer31"):
        if pid in reg:
            assert torch.equal(reg.get(pid).logical_cells(),
                               ref.get(pid).logical_cells())
    local = tclock(rows["peer2"])
    mask = np.zeros(CAP, bool)
    mask[[2, 6, 17, 25]] = True
    assert torch.equal(reg.union(mask, local).logical_cells(),
                       ref.union(mask, local).logical_cells())


def test_evict_hook_captures_rows_from_every_shard():
    rows = fleet(4, {"peer3": wide_row(5, 3000)})
    got, want = {}, {}
    reg = tfilled(rows, 8)
    ref = tfilled(rows)
    reg.on_evict, ref.on_evict = got.update, want.update
    victims = ["peer0", "peer3", "peer12", "peer31", "peer17"]
    reg.evict_many(victims)
    ref.evict_many(victims)
    assert list(got) == list(want) == victims
    for pid in victims:
        a, b = got[pid], want[pid]
        np.testing.assert_array_equal(a.cells_u8, b.cells_u8)
        assert (a.base, a.sum) == (b.base, b.sum)
        np.testing.assert_array_equal(a.logical(), b.logical())


# ---------------------------------------------------------------------------
# the port against the JAX package at the same shard count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_classify_all_matches_jax(host_devices, shards):
    rows = fleet(shards)
    local_row = random_rows(40 + shards)[0] + 100
    treg, jreg = tfilled(rows, shards), jfilled(rows, shards)
    evict_some(treg, shards)
    evict_some(jreg, shards)
    tview = treg.classify_all(tclock(local_row))
    jview = jreg.classify_all(jclock(local_row))
    np.testing.assert_array_equal(tview.status, jview.status)
    np.testing.assert_array_equal(tview.alive, jview.alive)
    np.testing.assert_array_equal(host(tview.sums), np.asarray(jview.sums))
    assert (host(tview.fp) == np.asarray(jview.fp)).all()
    assert tview.local_sum == jview.local_sum
    assert treg.n_shards == jreg.n_shards == shards


@pytest.mark.parametrize("shards", (2, 8))
def test_all_pairs_matches_jax(host_devices, shards):
    rows = fleet(20 + shards)
    treg, jreg = tfilled(rows, shards), jfilled(rows, shards)
    evict_some(treg, shards)
    evict_some(jreg, shards)
    assert_pairs_match_jax(treg.all_pairs(), jreg.all_pairs())


def test_gossip_round_sharded_matches_unsharded_and_jax(host_devices):
    rows = fleet(11)
    local = rows["peer2"]
    tcfg = TGossipConfig(policy=tcausal.CausalPolicy(fp_threshold=1.0),
                         push_back=True)
    jcfg = JGossipConfig(policy=jcausal.CausalPolicy(fp_threshold=1.0),
                         push_back=True)
    m_ref, r_ref = tgossip_round(tfilled(rows), tclock(local), tcfg)
    assert r_ref.shards == 1
    for shards in (2, 4):
        reg = tfilled(rows, shards)
        m_got, r_got = tgossip_round(reg, tclock(local), tcfg)
        for key in ("accepted", "quarantined", "stragglers", "unconfident"):
            np.testing.assert_array_equal(getattr(r_got, key),
                                          getattr(r_ref, key), err_msg=key)
        assert r_got.pushback_bytes == r_ref.pushback_bytes
        assert r_got.shards == shards
        assert torch.equal(m_got.logical_cells(), m_ref.logical_cells())
        jreg = jfilled(rows, shards)
        m_j, r_j = jgossip_round(jreg, jclock(local), jcfg)
        np.testing.assert_array_equal(r_got.accepted, r_j.accepted)
        np.testing.assert_array_equal(r_got.view.status, r_j.view.status)
        assert r_got.pushback_bytes == r_j.pushback_bytes
        assert r_j.shards == shards
        np.testing.assert_array_equal(host(m_got.logical_cells()),
                                      np.asarray(m_j.logical_cells()))
        np.testing.assert_array_equal(host(reg.cells), np.asarray(jreg.cells))


def test_gossip_session_spans_carry_shards():
    from repro_torch.obs import Observer, Tracer
    tracer = Tracer()
    reg = tfilled(fleet(12), 4)
    cfg = TGossipConfig(policy=tcausal.CausalPolicy(fp_threshold=1.0),
                        observer=Observer(trace=tracer))
    tgossip_round(reg, tclock(fleet(12)["peer1"]), cfg)
    sess = [e for e in tracer.events() if e["name"] == "gossip.session"]
    assert sess and sess[0]["attrs"]["shards"] == 4


def test_fleet_health_sharded_matches(host_devices):
    rows = fleet(13)
    ref = tfleet_health(tfilled(rows))
    got = tfleet_health(tfilled(rows, 4))
    jgot = jfleet_health(jfilled(rows, 4))
    for other in (ref, jgot):
        assert got.n_alive == other.n_alive
        assert got.n_components == other.n_components
        assert got.comparable_fraction == other.comparable_fraction
        np.testing.assert_array_equal(got.component, other.component)
        np.testing.assert_array_equal(got.straggler_mask,
                                      other.straggler_mask)
    np.testing.assert_array_equal(got.fp_hist, ref.fp_hist)
    assert got.mean_strict_fp == ref.mean_strict_fp
    assert_fp_close([got.mean_strict_fp], [jgot.mean_strict_fp])
    assert got.shards == jgot.shards == 4 and ref.shards == 1
    assert "shards=4" in got.summary()
    hinted = tfleet_health(tfilled(rows, 2), engine="tri")
    assert hinted.n_components == ref.n_components


def test_watch_span_carries_shards():
    from repro_torch.fleet import watch
    from repro_torch.obs import Observer, Tracer
    tracer = Tracer()
    reg = tfilled(fleet(14), 2)
    [h] = list(watch(reg, interval=0.0, samples=1,
                     observer=Observer(trace=tracer)))
    assert h.shards == 2
    spans = [e for e in tracer.events() if e["name"] == "fleet.health"]
    assert spans[0]["attrs"]["shards"] == 2


@pytest.mark.parametrize("promoted", [False, True])
def test_engine_i32_hint_survives_every_path(promoted):
    rows = fleet(31, {"peer9": wide_row(4, 3000)} if promoted else None)
    ref = tfilled(rows).all_pairs()
    for shards in (None, 4):
        got = tfilled(rows, shards).all_pairs(engine="i32")
        assert_pairs_identical(got, ref)


@pytest.mark.parametrize("engine", ["full", "mxu"])
def test_engine_hints_run_replicated(engine, tmp_path, monkeypatch,
                                     host_devices):
    """The packed engines asked for by name, on a sharded slab, run the
    packed ring, or under a "replicated" table entry the replica's
    default engine, as the reference does (its labels: ``ring_full``,
    ``replicated_tri``): flags and sums identical to the unsharded
    engine's."""
    rng = np.random.default_rng(8)
    rows = {f"p{i}": 500 + rng.integers(0, 40, M) for i in range(CAP)}
    ref = tfilled(rows).all_pairs(engine=engine)
    assert ref.engine == engine
    got = tfilled(rows, 4).all_pairs(engine=engine)
    assert got.engine == jfilled(rows, 4).all_pairs(engine=engine).engine
    assert got.engine == "ring_full"
    assert_pairs_identical(got, ref)
    plant_strategy(monkeypatch, tmp_path, "replicated", (4,))
    got = tfilled(rows, 4).all_pairs(engine=engine)
    assert got.engine == "replicated_tri"
    assert_pairs_identical(got, ref)


@pytest.mark.parametrize("shards", (2, 8))
def test_gossip_sim_sharded_zero_false_negatives(shards):
    """§3 on a sharded registry: the audited sim never calls a
    truth-ordered peer FORKED, and takes the unsharded run's verdicts."""
    factory = lambda cap, m, k: TRegistry(cap, m, k, mesh=tmesh(shards))
    cfg = tsim.SimConfig(n_nodes=8, n_events=240, m=64, k=3, seed=3)
    res = tsim.run_gossip_sim(cfg, n_rounds=5, registry_factory=factory,
                              device=CPU)
    ref = tsim.run_gossip_sim(cfg, n_rounds=5, device=CPU)
    assert res.false_negatives == 0
    assert res.rounds == 5 and res.claims > 0
    assert res.within_eq3_band
    assert dataclasses.asdict(res) == dataclasses.asdict(ref)


def test_runtime_make_registry_sharded():
    rt = ClockRuntime(ClockConfig(m=M, k=K), device=CPU)
    reg = rt.make_registry(CAP, mesh=tmesh(4))
    assert (reg.m, reg.k, reg.n_shards) == (M, K, 4)
    assert reg.policy.fp_threshold == rt.policy.fp_threshold
    reg.admit_many(peers_of(fleet(17), tclock))
    view = rt.classify_fleet(reg)
    assert view.alive.all()
    with pytest.raises(ValueError, match="not divisible"):
        rt.make_registry(30, mesh=tmesh(4))


def test_registry_device_beside_a_mesh():
    """``device=`` beside a mesh names the mesh's first device, compared
    once both carry their index; another device is refused."""
    from repro_torch.device import indexed_device
    assert indexed_device(CPU) == torch.device("cpu")
    reg = TRegistry(CAP, M, K, mesh=tmesh(4), device=CPU)
    assert reg.device == torch.device("cpu") and reg.n_shards == 4
    rt = ClockRuntime(ClockConfig(m=M, k=K), device=CPU)
    assert rt.make_registry(CAP, mesh=tmesh(2)).device == rt.device
    with pytest.raises(ValueError, match="not the mesh's first device"):
        TRegistry(CAP, M, K, mesh=tmesh(4), device="meta")


def test_tiers_strip_the_mesh():
    from repro_torch.serve import TieredRegistry, TierConfig
    tiers = TieredRegistry(TierConfig(hot_capacity=8, warm_capacity=16),
                           m=64, k=K, device=CPU,
                           policy=tcausal.CausalPolicy(mesh=tmesh(4)))
    assert tiers.policy.mesh is None and tiers.hot.n_shards == 1


# ---------------------------------------------------------------------------
# wire round trips across shard boundaries, and state from the reference
# ---------------------------------------------------------------------------

def _wire_roundtrip(src: TRegistry, dst: TRegistry):
    snaps = {pid: tbc.to_wire(src.get(pid)) for pid in src.peer_ids()}
    dst.admit_many({pid: tbc.from_wire(s, device=CPU)
                    for pid, s in snaps.items()})
    for pid in src.peer_ids():
        assert torch.equal(src.get(pid).logical_cells(),
                           dst.get(pid).logical_cells()), pid


@pytest.mark.parametrize("src_shards,dst_shards", [(4, None), (None, 8)])
def test_wire_roundtrip_sharded_and_unsharded(src_shards, dst_shards):
    src = tfilled(fleet(21), src_shards)
    dst = (TRegistry(CAP, M, K, device=CPU) if dst_shards is None
           else TRegistry(CAP, M, K, mesh=tmesh(dst_shards)))
    _wire_roundtrip(src, dst)
    assert torch.equal(src.cells, dst.cells)


def test_wire_roundtrip_across_shard_counts_with_wide_row():
    rows = fleet(23, {"peer5": wide_row(3, 5000)})
    src = tfilled(rows, 2)
    dst = TRegistry(CAP, M, K, mesh=tmesh(8))
    _wire_roundtrip(src, dst)
    assert not dst.packed
    jsrc = jfilled(rows, 2)
    for pid in src.peer_ids():
        assert (tbc.to_wire(dst.get(pid))["cells"].tobytes()
                == np.asarray(jbc.to_wire(jsrc.get(pid))["cells"]).tobytes())


@pytest.mark.parametrize("shards", (2, 8))
def test_registry_from_state_into_a_sharded_registry(host_devices, shards):
    rows = fleet(33, {"peer6": wide_row(2, 4000)})
    jreg = jfilled(rows, shards)
    evict_some(jreg, 33)
    state = {"cells_u8": np.asarray(jreg.cells_u8),
             "base": np.asarray(jreg.base), "sums": np.asarray(jreg.sums),
             "alive": np.asarray(jreg.alive), "slot_of": dict(jreg._slot_of),
             "wide": dict(jreg._wide), "crc": jreg._crc_host,
             "free": list(jreg._free)}
    treg = convert.registry_from_state(state, M, K, mesh=tmesh(shards),
                                       policy=tpolicy())
    assert treg.n_shards == shards
    np.testing.assert_array_equal(host(treg.cells), np.asarray(jreg.cells))
    local = random_rows(34)[0] + 50
    tview = treg.classify_all(tclock(local))
    jview = jreg.classify_all(jclock(local))
    np.testing.assert_array_equal(tview.status, jview.status)
    np.testing.assert_array_equal(host(tview.sums), np.asarray(jview.sums))
    assert_fp_close(tview.fp, np.asarray(jview.fp))
    assert treg.check_integrity() == []
    ref = convert.registry_from_state(state, M, K, policy=tpolicy(),
                                      device=CPU)
    assert_views_identical(tview, ref.classify_all(tclock(local)))


# ---------------------------------------------------------------------------
# the all-pairs ring against the JAX ring at the same shard count
# ---------------------------------------------------------------------------

RING_COUNTS = (1, 2, 3, 4, 8)
RING_N = 48                       # divisible by every count above


def ring_slab(seed: int, uniform: bool, n: int = RING_N):
    """u8 residuals and int32 bases of n rows around one template, so
    that many pairs are ordered and many concurrent."""
    rng = np.random.default_rng(seed)
    t = rng.integers(10, 60, M)
    logical = (t + rng.integers(0, 3, (n, 1))
               + rng.integers(0, 2, (n, M)) * (rng.random((n, M)) < 0.03))
    base = np.zeros(n, np.int64) if uniform else rng.integers(0, 8, n)
    return (logical - base[:, None]).astype(np.uint8), base.astype(np.int32)


def tsharded(cells: np.ndarray, base: np.ndarray, shards: int, **kw):
    mesh = tmesh(shards)
    out = tops._compare_matrix_packed_sharded(
        sharding.split_rows(torch.as_tensor(cells), mesh.devices),
        sharding.split_rows(torch.as_tensor(base), mesh.devices), mesh=mesh,
        **kw)
    return out, dict(tops.LAST_DISPATCH)


def jring(cells: np.ndarray, base: np.ndarray, shards: int, uniform: bool):
    from repro.kernels import ops as jops
    out = jops._compare_matrix_packed_sharded(
        jnp.asarray(cells), jnp.asarray(base), mesh=jmake_fleet_mesh(shards),
        axis=sharding.FLEET_AXIS, strategy="ring", uniform_base=uniform,
        use_autotune=False)
    return {k: np.asarray(v) for k, v in out.items()}, dict(jops.LAST_DISPATCH)


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "based"])
@pytest.mark.parametrize("shards", RING_COUNTS)
def test_ring_matches_jax_ring(host_devices, shards, uniform):
    """``_compare_matrix_packed_sharded(strategy="ring")`` against the JAX
    ring at the same shard count: flags and row sums identical, fp
    within 5e-2; bit-identical to the port's unsharded slab and to its
    "replicated" strategy; the reference's dispatch label."""
    cells, base = ring_slab(shards, uniform)
    got, label = tsharded(cells, base, shards, strategy="ring",
                          uniform_base=uniform)
    want, jlabel = jring(cells, base, shards, uniform)
    for key in ("a_le_b", "b_le_a", "concurrent", "row_sums", "col_sums"):
        np.testing.assert_array_equal(host(got[key]), want[key], err_msg=key)
    assert_fp_close(got["fp"], want["fp"])
    assert got["a_le_b"].any() and got["concurrent"].any()
    for key in ("engine", "shards", "strategy"):
        assert label[key] == jlabel[key], key
    one = tops._compare_matrix_packed(torch.as_tensor(cells),
                                      torch.as_tensor(base),
                                      uniform_base=uniform)
    rep, rlabel = tsharded(cells, base, shards, strategy="replicated",
                           uniform_base=uniform)
    assert rlabel["engine"] == "replicated_tri"
    for key in ("a_le_b", "b_le_a", "concurrent", "fp", "row_sums"):
        assert torch.equal(got[key], one[key]), key
        assert torch.equal(rep[key], one[key]), key


@pytest.mark.parametrize("shards", RING_COUNTS)
def test_ring_launch_plan(shards, monkeypatch):
    """d tri calls (the diagonal blocks) and d(d - 1)/2 rect-u8 calls (the
    halved off-diagonal blocks, the even-d half-way offset once), as the
    kernels' launches on the card; no pair is computed twice."""
    calls = {"tri": [], "rect": []}
    tri, rect = tops.tri_flags, tops.rect_u8_flags

    def count_tri(cells, *a, **kw):
        calls["tri"].append(cells.shape[0] ** 2)
        return tri(cells, *a, **kw)

    def count_rect(rows, cols, *a, **kw):
        calls["rect"].append(rows.shape[0] * cols.shape[0])
        return rect(rows, cols, *a, **kw)

    monkeypatch.setattr(tops, "tri_flags", count_tri)
    monkeypatch.setattr(tops, "rect_u8_flags", count_rect)
    cells, base = ring_slab(7, False)
    tsharded(cells, base, shards, strategy="ring", uniform_base=False)
    assert len(calls["tri"]) == shards
    assert len(calls["rect"]) == shards * (shards - 1) // 2
    assert sum(calls["tri"]) + 2 * sum(calls["rect"]) == RING_N ** 2


@pytest.mark.parametrize("shards", (2, 4))
def test_ring_departs_from_jax_only_at_a_2_31_base_gap(host_devices, shards):
    """The tri departure (``tests/test_torch_pairs.py``) on the ring: where
    two bases are exactly 2^31 apart, a mirrored flag differs from a
    computed one.  Both rings compute the off-diagonal block (i, i + s)
    and mirror it, so they agree there; on a diagonal block the JAX ring
    computes the shard's pairs whole and the port computes i <= j and
    mirrors i > j.  The two agree on every other pair."""
    cells, _ = ring_slab(11, True)
    n = RING_N
    base = np.where(np.arange(n) % 2, -2 ** 31, 0).astype(np.int32)
    got, _ = tsharded(cells, base, shards, strategy="ring",
                      uniform_base=False)
    want, _ = jring(cells, base, shards, False)
    le, ge = host(got["a_le_b"]), host(got["b_le_a"])
    i, j = np.indices((n, n))
    apart = (base[:, None].astype(np.int64) - base[None, :]) % 2 ** 32 \
        == 2 ** 31
    nd = n // shards
    mirrored = apart & (i > j) & (i // nd == j // nd)
    assert mirrored.any()
    np.testing.assert_array_equal(le[~mirrored], want["a_le_b"][~mirrored])
    np.testing.assert_array_equal(ge[~mirrored], want["b_le_a"][~mirrored])
    np.testing.assert_array_equal(le[mirrored], want["b_le_a"].T[mirrored])
    np.testing.assert_array_equal(ge[mirrored], want["a_le_b"].T[mirrored])
    assert want["a_le_b"][mirrored].all() and not want["b_le_a"][mirrored].any()
    assert not le[mirrored].any() and ge[mirrored].all()


PAIR_CAP = 48                     # divisible by 2, 3, 4 and 8


@pytest.mark.parametrize("case", ["full", "dead", "promoted"])
@pytest.mark.parametrize("shards", (2, 3, 4, 8))
def test_ring_pairs_match_jax_and_replicated(host_devices, tmp_path,
                                             monkeypatch, shards, case):
    """``ClockRegistry.all_pairs`` over a sharded registry with no table
    entry runs the ring (dead slots masked on the device, promoted rows
    patched in through the int32 rim): flags, concurrency and sums
    identical to the JAX registry's ring and fp within 5e-2; every field
    bit-identical to the port's unsharded registry and to the
    "replicated" strategy (a table entry naming it); the reference's
    labels."""
    wide = {"peer7": wide_row(slice(None, None, 7), 1000),
            "peer40": wide_row(3, 5000)} if case == "promoted" else None
    rows = fleet(60 + shards, wide, cap=PAIR_CAP)
    regs = {"t": tfilled(rows, shards, cap=PAIR_CAP),
            "j": jfilled(rows, shards, cap=PAIR_CAP),
            "one": tfilled(rows, cap=PAIR_CAP)}
    if case != "full":
        rng = np.random.default_rng(1000 + shards)
        gone = rng.choice(sorted(set(rows) - set(wide or {})), size=6,
                          replace=False)
        for r in regs.values():
            r.evict_many(list(gone))
    assert regs["t"].packed == (case != "promoted")
    got, jres = regs["t"].all_pairs(), regs["j"].all_pairs()
    assert got.engine == jres.engine == (
        "ring_full+wide_rim" if case == "promoted" else "ring_full")
    assert dict(got.blocks)["strategy"] == "ring"
    assert_pairs_match_jax(got, jres)
    assert_pairs_identical(got, regs["one"].all_pairs())
    plant_strategy(monkeypatch, tmp_path, "replicated", (shards,), PAIR_CAP)
    rep = regs["t"].all_pairs()
    assert rep.engine.startswith("replicated_tri")
    assert dict(rep.blocks)["strategy"] == "replicated"
    assert_pairs_identical(rep, got)


def test_strategy_resolves_from_the_table_else_ring(tmp_path, monkeypatch):
    """``strategy=None`` reads the table's ``matrix_sharded`` entry for the
    backend, global shape and shard count, else runs "ring"; an explicit
    strategy wins over the entry."""
    cells, base = ring_slab(3, True, n=CAP)
    plant_strategy(monkeypatch, tmp_path, "ring", ())
    assert tsharded(cells, base, 4)[1]["strategy"] == "ring"
    plant_strategy(monkeypatch, tmp_path, "replicated", (4,))
    assert tsharded(cells, base, 4)[1]["strategy"] == "replicated"
    assert tsharded(cells, base, 2)[1]["strategy"] == "ring"
    assert tsharded(cells, base, 4, strategy="ring")[1]["strategy"] == "ring"
    assert tsharded(cells, base, 4, use_autotune=False)[1]["strategy"] \
        == "ring"


# ---------------------------------------------------------------------------
# the reference's public names the port gained, each against the reference
# ---------------------------------------------------------------------------

def test_policy_merged_matches_reference():
    for kw in ({}, {"fp_threshold": 0.5, "engine": None},
               {"engine": "full", "bm": 256, "bn": None}):
        t = tcausal.CausalPolicy().merged(**kw)
        j = jcausal.CausalPolicy().merged(**kw)
        assert t.label() == j.label()
        assert (t.fp_threshold, t.engine, t.bm, t.bn) == \
            (j.fp_threshold, j.engine, j.bm, j.bn)
    base = tcausal.CausalPolicy(fp_threshold=0.2)
    assert base.merged(bm=None) is base


def test_fleet_view_slots_and_registry_cells_match_reference():
    rows = fleet(41, {"peer4": wide_row(7, 2000)})
    treg, jreg = tfilled(rows), jfilled(rows)
    evict_some(treg, 41)
    evict_some(jreg, 41)
    np.testing.assert_array_equal(host(treg.cells), np.asarray(jreg.cells))
    local = random_rows(42)[0] + 60
    tview = treg.classify_all(tclock(local))
    jview = jreg.classify_all(jclock(local))
    for code in tfleet.STATUS_NAMES:
        np.testing.assert_array_equal(tview.slots(code), jview.slots(code))


def test_bloom_clock_sum_and_deprecated_compare_match_reference():
    rows = random_rows(43, cap=2)
    ta, tb = tclock(rows[0]), tclock(rows[1] + rows[0])
    ja, jb = jclock(rows[0]), jclock(rows[1] + rows[0])
    assert float(ta.sum()) == float(ja.sum())
    assert float(tb.sum()) == float(tbc.clock_sum(tb))
    with pytest.warns(DeprecationWarning):
        t = tbc.compare(ta, tb)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        j = jbc.compare(ja, jb)
    for key in ("a_le_b", "b_le_a", "concurrent", "equal"):
        assert bool(getattr(t, key)) == bool(getattr(j, key)), key
    assert_fp_close([float(t.fp_a_before_b)], [float(j.fp_a_before_b)])
    assert "compare" in tbc.__all__


def test_mean_predicted_fp_matches_reference(host_devices):
    rows = fleet(44)
    t, j = tfleet_health(tfilled(rows)), jfleet_health(jfilled(rows))
    assert t.mean_predicted_fp == t.mean_strict_fp
    assert_fp_close([t.mean_predicted_fp], [j.mean_predicted_fp])


@pytest.mark.parametrize("args", [(6, 7, 10, 2000, 0), (64, 40, 90, 500, 3),
                                  (16, 12, 12, 300, 11)])
def test_monte_carlo_overlap_matches_reference(args):
    m, sa, sb, trials, seed = args
    assert (tsim.monte_carlo_overlap(m, sa, sb, trials, seed)
            == jsim.monte_carlo_overlap(m, sa, sb, trials, seed))


def test_evicted_row_is_exported():
    from repro.fleet import registry as jreg_mod
    assert "EvictedRow" in tfleet.__all__
    assert "EvictedRow" in jreg_mod.__all__
    assert tfleet.EvictedRow is tfleet.registry.EvictedRow
