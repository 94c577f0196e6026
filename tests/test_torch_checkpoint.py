"""The port's checkpoints (``repro_torch.checkpoint``) and the checkpoint
half of ``ClockRuntime`` against the JAX package's on the CPU.

A directory written by either package's ``CheckpointManager`` restores
in the other with identical leaves (the same npz keys, dtypes and
bytes, the same manifest).  ``classify_checkpoints`` and
``admit_restore_latest`` give the reference's statuses, safe flags and
latest step over the same directory; fp within a relative 5e-2 (Eq. 3
across math libraries, ROADMAP.md queue 3).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.optim.adamw import OptConfig as JOpt  # noqa: E402
from repro.runtime import clock_runtime as JR  # noqa: E402
from repro.runtime.training import init_train_state as j_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager as TManager  # noqa: E402
from repro_torch.optim.adamw import Moment, OptConfig as TOpt  # noqa: E402
from repro_torch.runtime import clock_runtime as TR  # noqa: E402
from repro_torch.runtime.training import TrainState, init_train_state  # noqa: E402

FP_RTOL = 5e-2
ARCH = "qwen1_5_0_5b"


def states(state_dtype="float32"):
    """The reference's smoke state and the same state in the port."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    jst = j_init(jax.random.PRNGKey(0), jcfg,
                 JOpt(total_steps=10, state_dtype=state_dtype),
                 JR.ClockConfig(m=64))
    tst = convert.train_state_from_jax(jax.tree.map(np.asarray, jst),
                                       tconfigs.get_smoke_config(ARCH),
                                       device="cpu")
    return jst, tst


def leaves_of(state) -> dict:
    from repro_torch.checkpoint.manager import _leaves
    return {k: v for k, v in _leaves(state)}


def assert_same_state(a: TrainState, b: TrainState):
    la, lb = leaves_of(a), leaves_of(b)
    assert list(la) == list(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_save_restore_round_trip(tmp_path, state_dtype):
    """Save (async, then ``wait``) and restore into the state's own
    structure: every leaf identical, int8 moments as ``Moment``s."""
    _, tst = states(state_dtype)
    rt = TR.ClockRuntime(TR.ClockConfig(m=64), run_id="t0", device="cpu")
    rt.tick_step(0)
    mgr = TManager(str(tmp_path), run_id="t0")
    mgr.save(1, tst, rt.snapshot())
    mgr.wait()
    assert "snapshot_s" in mgr.last_save and "write_s" in mgr.last_save
    restored, manifest = mgr.restore(target_structure=tst, device="cpu")
    assert manifest["step"] == 1 and manifest["run_id"] == "t0"
    assert manifest["n_leaves"] == len(leaves_of(tst))
    assert_same_state(restored, tst)
    if state_dtype == "int8":
        assert isinstance(restored.opt["m"]["layers/mlp/w_up"], Moment)
    clock = TR.ClockRuntime.clock_from_snapshot(manifest["clock"])
    assert torch.equal(clock.logical_cells(), rt.clock.logical_cells())


def test_restore_refuses_shardings_and_missing_leaves(tmp_path):
    _, tst = states()
    mgr = TManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    mgr.save(2, {"w": torch.zeros(3)}, TR.ClockRuntime(
        TR.ClockConfig(m=64), device="cpu").snapshot(), block=True)
    # shardings place the leaves of a target structure; without one
    # there is nothing to place (the placed restore is in
    # tests/test_torch_model_mesh.py)
    with pytest.raises(ValueError, match="needs target_structure"):
        mgr.restore(shardings=object())
    with pytest.raises(KeyError, match="missing leaves"):
        mgr.restore(target_structure=tst, device="cpu")
    flat, _ = mgr.restore()
    assert list(flat) == ["w"] and isinstance(flat["w"], np.ndarray)


def test_keep_gc_and_clock_manifests_match_reference(tmp_path):
    """``keep=2``: the two newest steps survive; ``clock_manifests``
    lists them with the same manifests as the reference writes."""
    snap_rt = TR.ClockRuntime(TR.ClockConfig(m=64, k=3), device="cpu")
    jm, tm = JManager(str(tmp_path / "j"), keep=2), TManager(str(tmp_path / "t"), keep=2)
    for step in (3, 1, 5, 4):
        snap_rt.tick_step(step)
        jm.save(step, {"w": np.full(2, step, np.float32)}, snap_rt.snapshot(),
                extra={"note": "x"}, block=True)
        tm.save(step, {"w": torch.full((2,), float(step))}, snap_rt.snapshot(),
                extra={"note": "x"})
    tm.wait()
    assert tm.list_steps() == jm.list_steps() == [4, 5]
    assert tm.latest_step() == 5
    assert tm.clock_manifests() == jm.clock_manifests()


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path):
    """A directory written by the JAX package's manager restores in the
    port, and one written by the port restores in the JAX package: the
    same keys, dtypes and bytes both ways, the manifests equal."""
    jst, tst = states("int8")
    snap = TR.ClockRuntime(TR.ClockConfig(m=64), device="cpu").snapshot()
    JManager(str(tmp_path / "j")).save(3, jst, snap, block=True)
    TManager(str(tmp_path / "t")).save(3, tst, snap, block=True)

    from_jax, jman = TManager(str(tmp_path / "j")).restore(
        target_structure=tst, device="cpu")
    assert_same_state(from_jax, tst)
    from_port, tman = JManager(str(tmp_path / "t")).restore(target_structure=jst)
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(from_port)[0],
                          jax.tree.leaves(jst)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, kp
        np.testing.assert_array_equal(a, b, err_msg=str(kp))
    assert tman == jman
    with open(tmp_path / "j" / "step_3" / "manifest.json") as f:
        assert json.load(f) == jman


def test_bfloat16_leaves_cross_as_their_bits(tmp_path):
    """A bfloat16 leaf is stored as the reference stores it (a 2-byte
    void dtype of the same bits) and restores as bfloat16 in both."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 5)).astype(np.float32)
    j_tree = {"p": jnp.asarray(x, jnp.bfloat16)}
    t_tree = {"p": torch.from_numpy(x).to(torch.bfloat16)}
    snap = TR.ClockRuntime(TR.ClockConfig(m=64), device="cpu").snapshot()
    JManager(str(tmp_path / "j")).save(1, j_tree, snap, block=True)
    TManager(str(tmp_path / "t")).save(1, t_tree, snap, block=True)
    with np.load(tmp_path / "j" / "step_1" / "state.npz") as j, \
            np.load(tmp_path / "t" / "step_1" / "state.npz") as t:
        assert t["p"].dtype == j["p"].dtype
        assert t["p"].tobytes() == j["p"].tobytes()
    back, _ = TManager(str(tmp_path / "j")).restore(target_structure=t_tree,
                                                    device="cpu")
    assert back["p"].dtype == torch.bfloat16 and torch.equal(back["p"], t_tree["p"])


# ---------------------------------------------------------------------------
# lineage over a directory (tests/test_pack.py's cases)
# ---------------------------------------------------------------------------

def lineage_dir(tmp_path, Manager, Runtime, dev_kw):
    """Steps 1-3 ticked and saved, the runtime moved on (step 99), then a
    forked runtime's checkpoint at step 4."""
    rt = Runtime.ClockRuntime(Runtime.ClockConfig(m=128, k=3, fp_threshold=1.0),
                              **dev_kw)
    mgr = Manager(str(tmp_path), keep=0)
    for step in (1, 2, 3):
        rt.tick_step(step)
        mgr.save(step, {"w": np.zeros(2)}, rt.snapshot(), block=True)
    rt.tick_step(99)
    forked = Runtime.ClockRuntime(Runtime.ClockConfig(m=128, k=3),
                                  run_id="other", **dev_kw)
    forked.tick_step(1)
    mgr.save(4, {"w": np.zeros(2)}, forked.snapshot(), block=True)
    return rt, mgr


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_classify_checkpoints_matches_reference(tmp_path, writer):
    """The same directory (written by either package) classified by both
    runtimes: statuses, safe flags, latest safe step identical; fp
    within 5e-2; the port's batch verdicts agree with its one-at-a-time
    ``admit_restore`` on clocks decoded by the static
    ``clock_from_snapshot``."""
    if writer == "jax":
        jrt, mgr = lineage_dir(tmp_path, JManager, JR, {})
        trt = TR.ClockRuntime(TR.ClockConfig(m=128, k=3, fp_threshold=1.0),
                              device="cpu")
        for step in (1, 2, 3, 99):
            trt.tick_step(step)
    else:
        trt, mgr = lineage_dir(tmp_path, TManager, TR, {"device": "cpu"})
        jrt = JR.ClockRuntime(JR.ClockConfig(m=128, k=3, fp_threshold=1.0))
        for step in (1, 2, 3, 99):
            jrt.tick_step(step)
    tl = trt.classify_checkpoints(mgr)
    jl = jrt.classify_checkpoints(mgr)
    np.testing.assert_array_equal(tl.steps, jl.steps)
    np.testing.assert_array_equal(tl.steps, [1, 2, 3, 4])
    assert tl.status == jl.status
    assert tl.status[:3] == [TR.LineageStatus.ANCESTOR] * 3
    assert tl.status[3] == TR.LineageStatus.FORKED
    np.testing.assert_array_equal(tl.safe, jl.safe)
    np.testing.assert_allclose(tl.fp, jl.fp, rtol=FP_RTOL)
    assert tl.summary() == jl.summary()
    assert tl.latest_safe() == jl.latest_safe() == 3
    step, lineage = trt.admit_restore_latest(mgr)
    assert step == jrt.admit_restore_latest(mgr)[0] == 3
    for s, status, ok in zip(lineage.steps, lineage.status, lineage.safe):
        man = dict(mgr.clock_manifests())[int(s)]
        ok1, st1, _ = trt.admit_restore(
            TR.ClockRuntime.clock_from_snapshot(man["clock"]))
        assert (st1, ok1) == (status, ok)


def test_classify_checkpoints_empty(tmp_path):
    rt = TR.ClockRuntime(TR.ClockConfig(m=64, k=3), device="cpu")
    lineage = rt.classify_checkpoints(TManager(str(tmp_path)))
    assert lineage.latest_safe() is None and len(lineage.status) == 0
    assert rt.admit_restore_latest(TManager(str(tmp_path)))[0] is None


def test_ancestor_restore_admitted_fork_refused():
    """``tests/test_integration.py``'s lineage case on the port, beside
    the reference: an ancestor is admitted, a fork refused."""
    out = {}
    for name, mod, kw in (("jax", JR, {}), ("port", TR, {"device": "cpu"})):
        ck = mod.ClockConfig(m=256, fp_threshold=0.5)
        live, ckpt = mod.ClockRuntime(ck, run_id="r", **kw), mod.ClockRuntime(
            ck, run_id="r", **kw)
        for s in range(5):
            live.tick_step(s)
            ckpt.tick_step(s)
        live.tick_step(5)
        anc = live.admit_restore(ckpt.clock)
        forked = mod.ClockRuntime(ck, run_id="r", **kw)
        for s in range(5):
            forked.tick_step(s)
        forked.tick("rogue-event")
        live.tick_step(6)
        out[name] = (anc, live.admit_restore(forked.clock))
    (t_ok, t_st, t_fp), (f_ok, f_st, _) = out["port"]
    assert (t_ok, t_st) == (True, TR.LineageStatus.ANCESTOR)
    assert (f_ok, f_st) == (False, TR.LineageStatus.FORKED)
    assert out["port"][0][:2] == out["jax"][0][:2]
    assert out["port"][1][:2] == out["jax"][1][:2]
    np.testing.assert_allclose(t_fp, out["jax"][0][2], rtol=FP_RTOL)


def test_clock_from_snapshot_is_static_and_admitted_by_a_runtime():
    """The repair: ``clock_from_snapshot`` is a static method (as the
    reference's) that decodes on the CPU unless given a device; a CPU
    runtime admits the decoded clock (the card's case is in
    ``tests/test_torch_gpu.py``), and the merge after it is the
    reference's."""
    assert isinstance(TR.ClockRuntime.__dict__["clock_from_snapshot"],
                      staticmethod)
    jrt = JR.ClockRuntime(JR.ClockConfig(m=64))
    for s in range(4):
        jrt.tick_step(s)
    snap = jrt.snapshot()
    clock = TR.ClockRuntime.clock_from_snapshot(snap)
    assert clock.cells.device.type == "cpu"
    np.testing.assert_array_equal(
        clock.logical_cells().numpy(),
        np.asarray(JR.ClockRuntime.clock_from_snapshot(snap).logical_cells()))
    rt = TR.ClockRuntime(TR.ClockConfig(m=64), device="cpu")
    ok, status, fp = rt.admit_restore(clock)
    j_ok, j_status, j_fp = JR.ClockRuntime(JR.ClockConfig(m=64)).admit_restore(
        JR.ClockRuntime.clock_from_snapshot(snap))
    assert (ok, status) == (j_ok, j_status) == (True, TR.LineageStatus.DESCENDANT)
    np.testing.assert_allclose(fp, j_fp, rtol=FP_RTOL)
    assert rt.lineage(clock)[0] == status
    assert rt.admit_merge(clock)[1] == status


def test_init_train_state_shapes_follow_the_table():
    """``init_train_state`` from a ``torch.Generator``: every param of
    the table, zero moments (int8 ``Moment``s where the last dim is at
    least 128), an empty clock, step 0."""
    from repro_torch.models.params import param_table
    from repro_torch.runtime.clock_runtime import ClockConfig

    cfg = tconfigs.get_smoke_config(ARCH)
    st = init_train_state(torch.Generator().manual_seed(0), cfg,
                          TOpt(state_dtype="int8"), ClockConfig(m=32),
                          device="cpu")
    table = param_table(cfg)
    assert list(st.params) == list(table)
    for k, info in table.items():
        assert tuple(st.params[k].shape) == tuple(info.shape)
        m = st.opt["m"][k]
        assert isinstance(m, Moment) == (info.shape[-1] >= 128), k
    assert st.clock_cells.shape == (32,) and not st.clock_cells.any()
    assert int(st.step) == 0 and int(st.opt["step"]) == 0
