"""The port's ``MeshCollectiveTransport`` and the sim's mesh fabric
against the JAX package's (``tests/test_transport.py``'s three mesh
cases), on the CPU at the same shard counts.

The port's mesh puts every shard on the CPU (``make_fleet_mesh(s,
device="cpu")``), so its digest ring runs the copy primitive's
same-device path and each shard the kernels' plain versions; the JAX
side runs its ppermute ring over the forced host devices of
``tests/conftest.py`` (``host_devices``).

Tolerances: digests (sums, bases, m, k), digest bytes, masks, merged
cells, push-back bytes and the sim's counts identical; the session's fp
bit-identical to the port's loopback session and within a relative 5e-2
of the reference (values at or below the 1e-30 clip floor count as
equal).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.causal import CausalPolicy as JPolicy  # noqa: E402
from repro.core import clock as jbc  # noqa: E402
from repro.core.sim import SimConfig as JSimConfig  # noqa: E402
from repro.core.sim import run_gossip_sim as jrun_gossip_sim  # noqa: E402
from repro.fleet import ClockRegistry as JRegistry  # noqa: E402
from repro.fleet import GossipConfig as JGossipConfig  # noqa: E402
from repro.fleet import MeshCollectiveTransport as JMesh  # noqa: E402
from repro.fleet import anti_entropy_session as jsession  # noqa: E402
from repro.launch.mesh import make_fleet_mesh as jmake_fleet_mesh  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.causal import CausalPolicy as TPolicy  # noqa: E402
from repro_torch.core import clock as tbc  # noqa: E402
from repro_torch.core.sim import SimConfig, run_gossip_sim  # noqa: E402
from repro_torch.fleet import ClockRegistry as TRegistry  # noqa: E402
from repro_torch.fleet import GossipConfig as TGossipConfig  # noqa: E402
from repro_torch.fleet import MeshCollectiveTransport, gossip_round  # noqa: E402
from repro_torch.fleet.transport import anti_entropy_session  # noqa: E402
from repro_torch.launch.mesh import make_fleet_mesh  # noqa: E402

CAP, M, K = 8, 128, 3
FP_RTOL = 5e-2
FP_FLOOR = 1e-30
CPU = "cpu"


def assert_fp_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    keep = ~((a == b) | ((np.abs(a) <= FP_FLOOR) & (np.abs(b) <= FP_FLOOR)))
    np.testing.assert_allclose(a[keep], b[keep], rtol=FP_RTOL, atol=0)


def _ticked(c, events):
    for e in events:
        c = jbc.tick(c, jnp.uint32(e >> 32), jnp.uint32(e & 0xFFFFFFFF))
    return c


def fixture_rows(seed: int = 0) -> tuple[dict, np.ndarray]:
    """The reference fixture's rows (every status kind, a laggard and a
    promoted row) as numpy logical cells, and the local clock's."""
    rng = np.random.default_rng(seed)
    local = _ticked(jbc.zeros(M, K), range(30))
    wide = np.zeros(M, np.int64)
    wide[3] = 700                      # span > 255: promoted row
    rows = {
        "anc": _ticked(jbc.zeros(M, K), range(12)),
        "same": local,
        "desc": _ticked(local, range(200, 208)),
        "fork": _ticked(jbc.zeros(M, K), range(900, 912)),
        "lag": _ticked(jbc.zeros(M, K), range(2)),
        "wide": wide,
        "rand": rng.integers(0, 6, M),
    }
    cells = {pid: np.asarray(r.logical_cells() if hasattr(r, "logical_cells")
                             else r, np.int64) for pid, r in rows.items()}
    return cells, np.asarray(local.logical_cells(), np.int64)


def tclock(row) -> tbc.BloomClock:
    return tbc.BloomClock(torch.as_tensor(np.asarray(row, np.int32)),
                          torch.zeros((), dtype=torch.int32), K)


def jclock(row) -> jbc.BloomClock:
    return jbc.BloomClock(jnp.asarray(row, jnp.int32), jnp.zeros((), jnp.int32),
                          K)


def tregistry(rows: dict, shards: int | None) -> TRegistry:
    mesh = None if shards is None else make_fleet_mesh(shards, device=CPU)
    reg = TRegistry(CAP, M, K, mesh=mesh, device=CPU)
    reg.admit_many({pid: tclock(r) for pid, r in rows.items()})
    return reg


def jregistry(rows: dict, shards: int | None) -> JRegistry:
    mesh = None if shards is None else jmake_fleet_mesh(shards)
    reg = JRegistry(capacity=CAP, m=M, k=K, mesh=mesh)
    reg.admit_many({pid: jclock(r) for pid, r in rows.items()})
    return reg


def test_mesh_transport_needs_mesh():
    with pytest.raises(ValueError, match="mesh-sharded registry"):
        MeshCollectiveTransport(TRegistry(4, 64, 3, device=CPU))
    assert "MeshCollectiveTransport" in tfleet.__all__
    assert tfleet.MeshCollectiveTransport is MeshCollectiveTransport


@pytest.mark.parametrize("shards", (1, 2, 4, 8))
def test_mesh_digest_ring_matches_slab(host_devices, shards):
    """The ring's digests are the slab's sums and bases, and they and
    the digest bytes equal the reference's at the same shard count."""
    rows, _ = fixture_rows()
    reg = tregistry(rows, shards)
    tp = MeshCollectiveTransport(reg)
    digests, nbytes = tp.digests()
    jdigests, jbytes = JMesh(jregistry(rows, shards)).digests()
    assert nbytes == jbytes == 9 * CAP * (shards - 1) // shards
    assert set(digests) == set(jdigests) == set(rows)
    sums = reg.sums.numpy()
    for pid, d in digests.items():
        slot = reg.slot_of(pid)
        assert d.clock_sum == float(sums[slot])
        assert d.base == int(reg.base[slot])
        j = jdigests[pid]
        assert (d.peer_id, d.clock_sum, d.base, d.m, d.k, d.crc) == \
            (j.peer_id, j.clock_sum, j.base, j.m, j.k, j.crc)
    assert tp.pull(["anc"]) == ({}, 0)
    assert tp.push(["anc", "desc"], b"abc") == 6


@pytest.mark.parametrize("shards", (2, 4))
def test_mesh_session_matches_loopback(host_devices, shards):
    """A mesh session's masks, fp, merged cells and push-back bytes equal
    the port's loopback round (fp bit for bit) and the reference's mesh
    session (fp within tolerance), with its digest bytes."""
    rows, local = fixture_rows()
    tcfg = TGossipConfig(policy=TPolicy(fp_threshold=1.0))
    jcfg = JGossipConfig(policy=JPolicy(fp_threshold=1.0))
    m_ref, r_ref = gossip_round(tregistry(rows, None), tclock(local), tcfg)
    reg = tregistry(rows, shards)
    m_got, r_got = anti_entropy_session(reg, tclock(local),
                                        MeshCollectiveTransport(reg), tcfg)
    jreg = jregistry(rows, shards)
    m_j, r_j = jsession(jreg, jclock(local), JMesh(jreg), jcfg)
    assert r_got.transport == r_j.transport == "mesh"
    assert r_got.shards == r_j.shards == shards
    for mask in ("accepted", "quarantined", "stragglers", "unconfident"):
        np.testing.assert_array_equal(getattr(r_got, mask),
                                      getattr(r_ref, mask), err_msg=mask)
        np.testing.assert_array_equal(getattr(r_got, mask),
                                      getattr(r_j, mask), err_msg=mask)
    assert (r_got.view.fp == r_ref.view.fp).all()
    assert_fp_close(r_got.view.fp, np.asarray(r_j.view.fp))
    np.testing.assert_array_equal(m_got.logical_cells().numpy(),
                                  m_ref.logical_cells().numpy())
    np.testing.assert_array_equal(m_got.logical_cells().numpy(),
                                  np.asarray(m_j.logical_cells()))
    assert r_got.pushback_bytes == r_ref.pushback_bytes == r_j.pushback_bytes
    assert r_got.digest_bytes == r_j.digest_bytes > 0
    assert r_got.wire_bytes == r_j.wire_bytes
    np.testing.assert_array_equal(reg.cells.numpy(), np.asarray(jreg.cells))


def test_gossip_sim_mesh_transport_no_false_negatives(host_devices):
    """``run_gossip_sim(transport="mesh")`` over 4 shards: fn == 0, and
    counts and wire bytes equal to the reference's sim at the same seed;
    a callable transport builds the same fabric."""
    factory = lambda cap, m, k: TRegistry(
        cap, m, k, mesh=make_fleet_mesh(4, device=CPU))
    jfactory = lambda cap, m, k: JRegistry(
        capacity=cap, m=m, k=k, mesh=jmake_fleet_mesh(4))
    cfg = dict(n_nodes=5, n_events=120, m=64, k=3, seed=3)
    r = run_gossip_sim(SimConfig(**cfg), n_rounds=4, registry_factory=factory,
                       transport="mesh", device=CPU)
    j = jrun_gossip_sim(JSimConfig(**cfg), n_rounds=4,
                        registry_factory=jfactory, transport="mesh")
    assert r.transport == j.transport == "mesh"
    assert r.false_negatives == 0
    assert r.digest_bytes > 0 and r.delta_bytes == 0
    for key in ("rounds", "false_negatives", "claims", "false_positives",
                "merges", "quarantines", "digest_bytes", "delta_bytes",
                "pushback_bytes", "wire_bytes", "within_eq3_band"):
        assert getattr(r, key) == getattr(j, key), key
    assert_fp_close([r.mean_predicted_fp], [j.mean_predicted_fp])
    assert f"wire={r.wire_bytes}B[mesh]" in r.summary()
    again = run_gossip_sim(SimConfig(**cfg), n_rounds=4,
                           registry_factory=factory,
                           transport=MeshCollectiveTransport, device=CPU)
    assert dataclasses.asdict(again) == dataclasses.asdict(r)
    with pytest.raises(ValueError, match="unknown transport"):
        run_gossip_sim(SimConfig(**cfg), transport="carrier", device=CPU)
