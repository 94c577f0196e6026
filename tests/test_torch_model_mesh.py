"""The port's model mesh against the JAX package's, on the CPU: the rule
table, ``logical_to_pspec`` and ``param_pspecs`` entry for entry,
``shapes``, the abstract params and state beside ``jax.eval_shape``,
``launch.specs``'s inputs and shardings, ``restore(shardings=)`` and
the dry run's skips (its argument bytes beside the reference's are in
``tests/test_torch_model_mesh_dryrun.py``).

Tolerances: none; every comparison here is of shapes, dtypes or specs,
and is exact.  A decode cache's ``length`` and ``pos`` are host
integers in the port where the reference has int32 arrays.

Every case that starts a process group (the meshes' fake groups, the
restore's mesh) does so in a subprocess of its own, so that no two
cases share a default group.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import shapes as jshapes  # noqa: E402
from repro import sharding as jsharding  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.optim.adamw import Moment as JMoment  # noqa: E402
from repro.optim.adamw import OptConfig as JOptConfig  # noqa: E402
from repro.runtime.clock_runtime import ClockConfig as JClockConfig  # noqa: E402
from repro_torch import shapes as tshapes  # noqa: E402
from repro_torch import sharding as tsharding  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.optim.adamw import Moment, OptConfig  # noqa: E402
from repro_torch.runtime.clock_runtime import ClockConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

#: the meshes the rules are held on, as ``mesh.shape`` mappings
MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x4": {"data": 2, "model": 4},
    "1x8": {"data": 1, "model": 8},
}
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def stub(sizes: dict):
    """A mesh that is only its ``shape`` (and axis names): all
    ``logical_to_pspec`` reads, on either side."""
    return types.SimpleNamespace(shape=dict(sizes),
                                 mesh_dim_names=tuple(sizes))


def entries(spec) -> tuple:
    return tuple(spec)


def dtype_name(x) -> str:
    """numpy's name of a leaf's dtype, for either package."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).rsplit(".", 1)[-1]
    return np.dtype(x.dtype).name


def run(code: str, timeout: int = 240, **env) -> str:
    """``code`` in a fresh interpreter with ``src`` on the path and
    without this process's forced host devices; its stdout."""
    e = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
             OMP_NUM_THREADS="2", **env)
    e.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         env=e, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


# ---------------------------------------------------------------------------
# rules and specs
# ---------------------------------------------------------------------------

def test_default_rules_and_make_rules_identical():
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    over = dict(act_seq="model", embed=None)
    assert tsharding.make_rules(**over) == jsharding.make_rules(**over)
    assert tsharding.make_rules() is not tsharding.DEFAULT_RULES


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_to_pspec_and_param_pspecs_identical(mesh, arch):
    """Every parameter of the full config on every mesh: the port's
    ``param_pspecs`` and ``logical_to_pspec`` give the reference's
    ``logical_to_pspec`` entries (None, an axis, a tuple of axes)."""
    m = stub(MESHES[mesh])
    rules = tsharding.DEFAULT_RULES
    table = TP.param_table(get_config(arch))
    jtable = JP.param_table(jget_config(arch))
    assert list(table) == list(jtable)
    got = tsharding.param_pspecs(m, rules, table)
    for path, info in table.items():
        want = entries(jsharding.logical_to_pspec(m, rules, info.axes,
                                                  info.shape))
        assert entries(got[path].spec) == want, path
        assert entries(tsharding.logical_to_pspec(
            m, rules, info.axes, info.shape)) == want, path


@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_to_pspec_fallbacks_identical(mesh):
    """Activation names: the tuple rule ``act_batch`` with its axes
    missing, shortened to a prefix or dropped where the batch does not
    divide; first-come-wins when two dims name one axis; ``*_v`` names
    replicated; overridden rules."""
    m = stub(MESHES[mesh])
    cases = [
        (("act_batch", "act_seq", "act_embed"), (64, 128, 256)),
        (("act_batch", "act_seq", "act_embed"), (2, 128, 256)),
        (("act_batch", "act_seq", "act_embed"), (6, 128, 256)),
        (("act_batch", "act_seq", "act_vocab"), (32, 8, 1000)),
        (("act_batch", "act_seq", "act_vocab"), (32, 8, 1024)),
        (("vocab", "embed"), (151936, 1024)),
        (("q_heads", "mlp"), (64, 64)),
        (("embed_v",), (1024,)),
        (("layers", "act_batch", "act_seq_cache", "act_kv_cache", None),
         (2, 128, 32768, 2, 16)),
        ((None, "unknown", "experts"), (4, 4, 8)),
    ]
    for rules in (tsharding.DEFAULT_RULES,
                  tsharding.make_rules(act_seq="model", act_batch=("data", "pod"))):
        for axes, shape in cases:
            assert entries(tsharding.logical_to_pspec(m, rules, axes, shape)) \
                == entries(jsharding.logical_to_pspec(m, rules, axes, shape)), \
                (axes, shape)


def test_placements_of_specs():
    """A spec's DTensor placements: Shard(d) on each mesh dim that dim
    d names, major to minor for a tuple; Replicate elsewhere; axes out
    of the mesh's order are refused."""
    from torch.distributed.tensor import Replicate, Shard

    m = stub(MESHES["2x16x16"])
    P = tsharding.P
    assert tsharding.placements(m, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert tsharding.placements(m, P(None, "data")) == (
        Replicate(), Shard(1), Replicate())
    assert tsharding.placements(m, P()) == (Replicate(),) * 3
    assert P(("data",), None) == ("data", None)
    with pytest.raises(ValueError, match="order"):
        tsharding.placements(m, P(("data", "pod")))


def test_shard_and_replicated_without_a_mesh():
    """Without ``use_mesh_rules`` (and with a None mesh) ``shard``
    returns its input; ``replicated`` of a plain ``like`` too."""
    x = torch.ones(4, 8)
    assert tsharding.shard(x, ("act_batch", "act_embed")) is x
    with tsharding.use_mesh_rules(None):
        assert tsharding.shard(x, ("act_batch", "act_embed")) is x
        assert tsharding.current_mesh() is None
    assert tsharding.replicated(x, torch.zeros(2)) is x
    assert tsharding.to_local(x) is x
    assert tsharding.reshape(x, 2, 16).shape == (2, 16)
    m = stub(MESHES["2x4"])
    with tsharding.use_mesh_rules(m):
        assert tsharding.current_mesh() is m
    assert tsharding.current_mesh() is None


def test_shapes_identical():
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    fams = {a: get_config(a).family for a in ARCHS}
    assert tshapes.cells(fams) == jshapes.cells(fams)
    for fam in set(fams.values()):
        for s in tshapes.SHAPES:
            assert tshapes.runnable(fam, s) == jshapes.runnable(fam, s)


# ---------------------------------------------------------------------------
# abstract params and state, batch and cache specs
# ---------------------------------------------------------------------------

def same_leaf(got, want, what: str) -> None:
    assert tuple(got.shape) == tuple(want.shape), what
    assert dtype_name(got) == dtype_name(want), what
    assert got.device.type == "meta", what


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_eval_shape(arch):
    got = TP.abstract_params(get_smoke_config(arch))
    want = jax.eval_shape(lambda: JP.init_params(jax.random.PRNGKey(0),
                                                 jget_smoke(arch)))
    assert list(got) == list(JP.param_table(jget_smoke(arch)))
    assert set(got) == set(want)
    for k in want:
        same_leaf(got[k], want[k], k)
    assert TS.abstract_params_dict(get_smoke_config(arch)).keys() == got.keys()


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_matches_eval_shape(arch, state_dtype):
    got = TS.abstract_state(get_smoke_config(arch),
                            OptConfig(state_dtype=state_dtype), ClockConfig())
    want = JS.abstract_state(jget_smoke(arch),
                             JOptConfig(state_dtype=state_dtype),
                             JClockConfig())
    for k in want.params:
        same_leaf(got.params[k], want.params[k], k)
        for mom in ("m", "v"):
            g, w = got.opt[mom][k], want.opt[mom][k]
            assert isinstance(g, Moment) == isinstance(w, JMoment), k
            if isinstance(w, JMoment):
                same_leaf(g.codes, w.codes, f"{mom} {k} codes")
                same_leaf(g.scale, w.scale, f"{mom} {k} scale")
                assert g.d == w.d
            else:
                same_leaf(g, w, f"{mom} {k}")
    same_leaf(got.opt["step"], want.opt["step"], "opt step")
    same_leaf(got.clock_cells, want.clock_cells, "clock cells")
    same_leaf(got.step, want.step, "step")


#: decode-cache fields of the port's dataclasses -> the reference's leaf
_CACHE_FIELDS = {("attn", "k"): "k", ("attn", "v"): "v",
                 ("attn", "ckv"): "ckv", ("attn", "krope"): "krope",
                 ("ssm", "conv"): "conv", ("ssm", "state"): "state",
                 ("cross", "k"): 0, ("cross", "v"): 1}


def cache_leaves(caches: dict, ref: bool) -> dict:
    """{(cache key, field): leaf} of either package's decode caches."""
    out = {}
    for (key, field), rfield in _CACHE_FIELDS.items():
        c = caches.get(key)
        if c is None:
            continue
        if ref:
            leaf = c[rfield] if isinstance(c, tuple) else getattr(c, rfield, None)
        else:
            leaf = getattr(c, field, None)
        if leaf is not None:
            out[(key, field)] = leaf
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match(arch):
    """``batch_specs`` and ``cache_specs`` give the reference's shapes
    and dtypes; the caches' ``length`` and ``pos`` are host integers
    where the reference has int32 arrays of one a layer."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    for s in tshapes.SHAPES:
        shape = tshapes.SHAPES[s]
        got, want = TS.batch_specs(cfg, shape), JS.batch_specs(jcfg, shape)
        assert list(got) == list(want)
        for k in want:
            same_leaf(got[k], want[k], f"{s} {k}")
        if shape.kind != "decode":
            continue
        lc = s == "long_500k"
        gc, wc = TS.cache_specs(cfg, shape, lc), JS.cache_specs(jcfg, shape, lc)
        assert set(gc) == set(wc)
        gl, wl = cache_leaves(gc, False), cache_leaves(wc, True)
        assert list(gl) == list(wl)
        for key in wl:
            same_leaf(gl[key], wl[key], f"{s} {key}")
        for key in ("attn",):
            if key in wc:
                for f in ("length", "pos"):
                    assert isinstance(getattr(gc[key], f), int)
                    assert getattr(wc[key], f).shape == (cfg.n_layers,)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_state_shardings_identical_on_auto_2x4(arch, host_devices):
    """``cache_shardings``, ``state_shardings`` and ``batch_shardings``:
    the reference's specs on an Auto 2x4 mesh of the 8 forced host
    devices, the port's on a 2x4 mesh that is only its shape."""
    jmesh = jax.make_mesh((2, 4), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2,
                          devices=host_devices[:8])
    m = stub(MESHES["2x4"])
    rules = tsharding.DEFAULT_RULES
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    for s in ("decode_32k", "long_500k"):
        shape = tshapes.SHAPES[s]
        if not tshapes.runnable(cfg.family, s):
            continue
        lc = s == "long_500k"
        got = cache_leaves(TS.cache_shardings(m, rules,
                                              TS.cache_specs(cfg, shape, lc)),
                           False)
        want = cache_leaves(JS.cache_shardings(jmesh, rules,
                                               JS.cache_specs(jcfg, shape, lc)),
                            True)
        assert list(got) == list(want)
        for key in want:
            assert entries(got[key].spec) == entries(want[key].spec), (s, key)
    for sd in ("float32", "int8"):
        opt, jopt = OptConfig(state_dtype=sd), JOptConfig(state_dtype=sd)
        got = TS.state_shardings(m, rules, cfg, TS.abstract_state(
            cfg, opt, ClockConfig()))
        want = JS.state_shardings(jmesh, rules, jcfg, JS.abstract_state(
            jcfg, jopt, JClockConfig()))
        for k in want.params:
            assert entries(got.params[k].spec) == entries(want.params[k].spec), k
            for mom in ("m", "v"):
                g, w = got.opt[mom][k], want.opt[mom][k]
                pairs = ([(g.codes, w.codes), (g.scale, w.scale)]
                         if isinstance(w, JMoment) else [(g, w)])
                for a, b in pairs:
                    assert entries(a.spec) == entries(b.spec), (sd, mom, k)
        for a, b in ((got.opt["step"], want.opt["step"]),
                     (got.clock_cells, want.clock_cells),
                     (got.step, want.step)):
            assert entries(a.spec) == entries(b.spec)
    shape = tshapes.SHAPES["train_4k"]
    got = TS.batch_shardings(m, TS.batch_specs(cfg, shape))
    want = JS.batch_shardings(jmesh, JS.batch_specs(jcfg, shape))
    assert {k: entries(v.spec) for k, v in got.items()} \
        == {k: entries(v.spec) for k, v in want.items()}


# ---------------------------------------------------------------------------
# the meshes and restore(shardings=), each in a process with a fake group
# ---------------------------------------------------------------------------

def test_production_and_local_meshes_on_a_fake_group():
    """``make_production_mesh`` over the first 256 / 512 ranks, raising
    on a group with fewer ranks (and with none); ``make_local_mesh``
    clamped to the group's size."""
    out = run("""
        import json, torch.distributed as dist
        from repro_torch.launch import mesh as M
        res = {}
        try:
            M.make_production_mesh()
        except RuntimeError as e:
            res["no_group"] = "process group" in str(e)
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512)
        for mp in (False, True):
            m = M.make_production_mesh(multi_pod=mp)
            res[str(mp)] = [list(m.shape), list(m.mesh_dim_names),
                            m.device_type]
        loc = M.make_local_mesh(64, 64)
        res["local"] = [list(loc.shape), list(loc.mesh_dim_names)]
        dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=128)
        try:
            M.make_production_mesh()
        except ValueError as e:
            res["few"] = "needs 256 ranks" in str(e)
        print(json.dumps(res))
    """)
    res = json.loads(out.strip().splitlines()[-1])
    assert res["no_group"] and res["few"]
    assert res["False"] == [[16, 16], ["data", "model"], "cpu"]
    assert res["True"] == [[2, 16, 16], ["pod", "data", "model"], "cpu"]
    assert res["local"] == [[64, 8], ["data", "model"]]


@pytest.mark.parametrize("config,kind", [
    ("cpu:gloo,cuda:gloo", "cpu"), ("cpu:gloo", "cpu"),
    ("cpu:fake,cuda:fake,hpu:fake,xpu:fake", "cpu"), ("nccl", "cuda"),
    ("cuda:nccl", "cuda"), ("cpu:gloo,cuda:nccl", "cuda")])
def test_mesh_device_type_from_the_backend_config(monkeypatch, config, kind):
    """The model meshes lie on the cards wherever the group runs CUDA
    tensors on NCCL, whatever string set the group up (a group without
    one reports the backend "undefined" and the config
    "cpu:gloo,cuda:nccl" on a host with cards); on the CPU under gloo
    and the fake backend.  The group's answers are stubbed: no NCCL
    here."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "undefined")
    monkeypatch.setattr(dist, "get_backend_config", lambda *a: config)
    assert M._device_type() == kind


def test_restore_places_leaves_by_shardings(tmp_path):
    """A saved state restored with ``state_shardings`` on a 2x4 mesh of a
    fake 8-rank group: every leaf a DTensor with its sharding's
    placements and the global shape, rank 0 holding exactly its shards
    of the stored value (the plain restore's)."""
    out = run(f"""
        import json, torch, torch.distributed as dist
        from torch.distributed.tensor import DTensor
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch import sharding as SH
        from repro_torch.checkpoint.manager import (CheckpointManager, _leaves,
                                                   _rebuild)
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch import specs as S
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.optim.adamw import OptConfig
        from repro_torch.runtime.clock_runtime import ClockConfig, ClockRuntime
        from repro_torch.runtime.training import init_train_state
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        mesh = make_local_mesh(2, 4)
        cfg = get_smoke_config("qwen1_5_0_5b")
        opt, clk = OptConfig(state_dtype="int8"), ClockConfig(m=64)
        st = init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                              clk, "cpu")
        mgr = CheckpointManager({str(tmp_path)!r})
        mgr.save(3, st, ClockRuntime(clk, device="cpu").snapshot(),
                 block=True)
        sh = S.state_shardings(mesh, SH.DEFAULT_RULES, cfg,
                               S.abstract_state(cfg, opt, clk))
        got, man = mgr.restore(target_structure=st, shardings=sh)
        plain, _ = mgr.restore(target_structure=st, device="cpu")
        shs, sharded, n = dict(_leaves(sh)), 0, 0
        for key, leaf in _leaves(got):
            want = dict(_leaves(plain))[key]
            assert isinstance(leaf, DTensor), key
            assert tuple(leaf.placements) == shs[key].placements, key
            assert leaf.shape == want.shape, key
            local = want
            for i, p in enumerate(leaf.placements):
                if p.is_shard():
                    local = local.chunk(mesh.shape[i], dim=p.dim)[0]
            assert torch.equal(leaf.to_local(), local), key
            sharded += leaf.to_local().numel() < want.numel()
            n += 1
        # (DeviceMesh, placements) pairs as the leaves work as well
        pairs = _rebuild(sh, lambda key, s: (mesh, s.placements))
        got2, _ = mgr.restore(target_structure=st, shardings=pairs)
        for key, leaf in _leaves(got2):
            assert tuple(leaf.placements) == shs[key].placements, key
        print(json.dumps({{"n": n, "sharded": sharded, "step": man["step"]}}))
    """)
    res = json.loads(out.strip().splitlines()[-1])
    assert res["step"] == 3 and res["n"] > 20 and res["sharded"] > 10


def test_dryrun_skips_full_attention_long_500k():
    """The eight full-attention archs skip long_500k before any mesh is
    made (no group is needed); the record says why."""
    full = [a for a in ARCHS
            if get_config(a).family not in ("ssm", "hybrid")]
    assert len(full) == 8
    for a in full:
        rec = TD.run_cell(a, "long_500k", quiet=True)
        assert rec["status"] == "skip" and rec["mesh"] == "16x16", a
        assert "sub-quadratic" in rec["reason"]
