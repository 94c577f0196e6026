"""The model mesh's explicit collectives on four gloo ranks, a 2x2
("data", "model") mesh, against the plain port and the JAX package's
``shard_map`` paths:

- ``decode_attention_split_kv`` alone (split-KV decode), float32, at
  window 0 and 5 and with ``kv_valid`` inside each seq shard: within
  rtol 1e-5 / atol 1e-6 of the reference's and of the port's
  ``attention_core``;
- ``cache_update(sharded_axis_mesh=)`` (``_sharded_slot_update``,
  owner-writes) on a linear and a ring cache, at a slot in each shard:
  the buffer bit-identical to the plain write, written in place, and no
  collective under ``CommDebugMode``;
- Qwen1.5-0.5B's smoke config with ``decode_attn="split_kv"``: prefill
  and four greedy decode steps give the plain port's tokens;
- ``_moe_alltoall`` on grok-1's smoke config in float32: at the default
  capacity each token shard keeps the same slots as the reference's
  local routing, and y and aux agree with the reference's within
  ``MOE_TOL``; at ``capacity_factor=64`` (no drops) ``forward_train``'s
  logits within the reference test's rtol/atol 1e-3 of the plain gather
  path and of the reference's ``alltoall`` forward;
- one ``alltoall`` train step of DeepSeek-V2's smoke config at
  ``capacity_factor=64`` (the gather path at the global capacity and
  the all-to-all at each shard's drop no token, so both compute one
  function) against the plain step: loss and grad norm within
  ``LOSS_RTOL``, params within the AdamW bound, moments within the MoE
  config's ``MOMENT_RTOL`` (``tests/test_torch_model_mesh_ranks.py``).

Every case also asserts that its collective path ran (calls counted,
all-to-alls seen by ``CommDebugMode``), so a silent fallback to the
gather paths fails.  The port's ranks run this file as a script, in
subprocesses; the reference runs in its own subprocess with 4 forced
host devices and an Auto-axis mesh (``jax.make_mesh`` gives Explicit
axes under JAX 0.9, on which the reference's gather path raises;
nothing under ``src/repro`` changes).  Both start side by side.

The dry run (``launch.dryrun.run_cell`` over a fake 512-rank group)
takes both overrides: ``decode_attn="split_kv"`` on Qwen's smoke decode
cell drops the cache writes from ``replicated_fallback`` and moves less
all-gather than the default cell; ``moe_impl="alltoall"`` on grok-1's
smoke train cell, with ``moe_replicas=4`` so that its 16 physical
experts divide the 16-wide model axis, shows ``all-to-all``; in both,
the per-device argument bytes equal the reference's ``run_cell`` with
the same override (decode's host scalars aside, as in
``tests/test_torch_model_mesh_dryrun.py``).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, HERE)

import test_torch_model_mesh_ranks as R  # noqa: E402

#: split-KV cases: (window, kv_valid); a seq shard holds 8 of 16 slots
SPLIT_CASES = [(0, 5), (0, 13), (5, 5), (5, 13)]
SPLIT_TOL = dict(rtol=1e-5, atol=1e-6)
#: slot-update cases: (ring, slot), a slot in each shard of 16
SLOT_CASES = [(False, 3), (False, 11), (True, 3), (True, 11)]
#: the reference test's tolerance for alltoall against gather
A2A_TOL = dict(rtol=1e-3, atol=1e-3)
#: ``_moe_alltoall``'s y and aux against the reference's, float32
#: (matmuls summed in each framework's order)
MOE_TOL = dict(rtol=1e-4, atol=1e-5)
#: the float32 grok config's inputs: tokens and a token slab
T_MOE, D_MOE = 64, 64
MOE_ARCH, TRAIN_ARCH, QWEN = "grok_1_314b", "deepseek_v2_236b", "qwen1_5_0_5b"
N_DECODE = 4
#: ``CommDebugMode``'s names of the functional collectives
A2A, ALL_REDUCE = ("c10d_functional.all_to_all_single",
                   "c10d_functional.all_reduce")


def split_inputs():
    """q [4, 1, 4, 16], k/v [4, 16, 2, 16], float32."""
    rng = np.random.default_rng(7)
    return (rng.standard_normal((4, 1, 4, 16)).astype(np.float32),
            rng.standard_normal((4, 16, 2, 16)).astype(np.float32),
            rng.standard_normal((4, 16, 2, 16)).astype(np.float32))


def moe_inputs():
    """The token slab [T, D] and tokens [4, 16] of the MoE cases."""
    rng = np.random.default_rng(8)
    return (rng.standard_normal((T_MOE, D_MOE)).astype(np.float32),
            rng.integers(0, 512, (4, 16), dtype=np.int32))


# ---------------------------------------------------------------------------
# the port's worker (this file run as a script, one process a rank)
# ---------------------------------------------------------------------------

class Calls:
    """While active, counts the calls of ``module.name`` (and hands each
    result to ``record``)."""

    def __init__(self, module, name: str, record=None):
        self.n, self.module, self.name = 0, module, name
        self.fn, self.record = getattr(module, name), record

    def __enter__(self):
        def counted(*a, **kw):
            self.n += 1
            out = self.fn(*a, **kw)
            if self.record is not None:
                self.record(out)
            return out
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _split(mesh, dev) -> dict:
    import torch
    from repro_torch.models import attention as A

    q, k, v = (torch.from_numpy(a).to(dev) for a in split_inputs())
    out = {}
    for w, valid in SPLIT_CASES:
        got = A.decode_attention_split_kv(q, k, v, kv_valid=valid, window=w,
                                          q_pos=valid - 1, mesh=mesh)
        core = A.attention_core(q, k, v, causal=False, window=w,
                                q_offset=valid - 1, kv_valid=valid, chunk=64)
        out[f"{w},{valid}"] = [got.cpu().numpy().tolist(),
                               core.cpu().numpy().tolist()]
    return out


def _slots(mesh, dev) -> dict:
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import sharding as SH
    from repro_torch.models import attention as A

    g = torch.Generator().manual_seed(6)
    out = {}
    for ring, slot in SLOT_CASES:
        k, v = (torch.randn((4, 16, 2, 16), generator=g).to(dev)
                for _ in range(2))
        kn, vn = (torch.randn((4, 1, 2, 16), generator=g).to(dev)
                  for _ in range(2))
        pos = slot + 16 if ring else slot
        plain = A.cache_update(A.KVCache(k.clone(), v.clone(), 9, pos, ring),
                               kn, vn)
        buf_pl = SH.placements(mesh, SH.P("data", "model", None, None))
        row_pl = SH.placements(mesh, SH.P("data", None, None, None))
        dk, dv = (distribute_tensor(t, mesh, buf_pl) for t in (k, v))
        dkn, dvn = (distribute_tensor(t, mesh, row_pl) for t in (kn, vn))
        with Calls(A, "_sharded_slot_update") as calls, \
                CommDebugMode() as comm:
            got = A.cache_update(A.KVCache(dk, dv, 9, pos, ring), dkn, dvn,
                                 sharded_axis_mesh=mesh)
        out[f"{ring},{slot}"] = {
            "equal": [torch.equal(got.k.full_tensor(), plain.k),
                      torch.equal(got.v.full_tensor(), plain.v)],
            "in_place": got.k is dk and got.v is dv,
            "collectives": comm.get_total_counts(),
            "calls": calls.n, "length": got.length, "pos": got.pos}
    return out


def _qwen_decode(mesh, dev) -> dict:
    """Greedy tokens of the plain port and of the split-KV decode on the
    mesh, the split-KV calls and the decode's collectives."""
    import dataclasses
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import sharding as SH
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_smoke_config(QWEN), decode_attn="split_kv")
    params = init_params(torch.Generator().manual_seed(0), cfg, dev)
    dparams = specs.place(params, specs.params_shardings(
        mesh, SH.DEFAULT_RULES, cfg))
    tokens = torch.randint(0, cfg.vocab, (4, 8),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    buf = 8 + N_DECODE
    toks, calls, counts = {}, 0, {}
    with torch.no_grad():
        for side, p, m in (("plain", params, None), ("mesh", dparams, mesh)):
            with SH.use_mesh_rules(m), CommDebugMode() as comm, \
                    Calls(A, "decode_attention_split_kv") as split:
                lg, caches = T.prefill(T.build(p, cfg), cfg, tokens,
                                       buf_len=buf)
                out = [SH.to_local(lg).argmax(-1)]
                for i in range(N_DECODE):
                    lg, caches = T.decode_step(p, cfg, caches,
                                               out[-1].to(torch.int32), 8 + i)
                    out.append(SH.to_local(lg).argmax(-1))
            toks[side] = [t.cpu().tolist() for t in out]
            if m is not None:
                calls = split.n
                counts = {str(k): n for k, n in
                          comm.get_comm_counts().items()}
    return {"tokens": toks, "split_calls": calls, "counts": counts}


def _moe_params(npz: str, cfg, dev) -> dict:
    import torch
    from repro_torch.models.params import param_table

    with np.load(npz) as z:
        return {path: torch.from_numpy(z[path].copy()).to(dev)
                for path in param_table(cfg)}


def _moe(mesh, dev, npz: str) -> dict:
    """``_moe_alltoall`` alone at the default capacity (y, aux, every
    rank's ``keep``) and ``forward_train`` at capacity 64, on the mesh
    (alltoall) and plain (gather)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import sharding as SH
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_smoke_config(MOE_ARCH), dtype="float32",
                              moe_impl="alltoall")
    params = _moe_params(npz, cfg, dev)
    x, tokens = moe_inputs()
    x, tokens = torch.from_numpy(x).to(dev), torch.from_numpy(tokens).to(dev)
    layer = {k: params[f"layers/moe/{k}"][0]
             for k in ("router", "w_gate", "w_up", "w_down")}
    keeps = []
    dx = distribute_tensor(x, mesh, SH.placements(mesh, SH.P("data", None)))
    with torch.no_grad(), CommDebugMode() as comm, Calls(
            M, "_route_and_bucket",
            record=lambda out: keeps.append(out[1][2])) as route:
        y, aux = M._moe_alltoall(layer, cfg, dx, mesh, ("data",), "model")
    mine = keeps[0].cpu().numpy().astype(int).tolist()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    a2a = {str(k): n for k, n in comm.get_comm_counts().items()}
    cfg64 = dataclasses.replace(cfg, capacity_factor=64.0)
    dparams = specs.place(params, specs.params_shardings(
        mesh, SH.DEFAULT_RULES, cfg64))
    with torch.no_grad(), Calls(M, "_moe_alltoall") as calls:
        plain, _ = T.forward_train(params, cfg64, tokens)
        with SH.use_mesh_rules(mesh):
            lg, _ = T.forward_train(dparams, cfg64, tokens)
    return {"y": y.full_tensor().cpu().numpy().tolist(),
            "aux": float(aux.full_tensor()), "keep": every,
            "route_calls": route.n, "counts": a2a,
            "logits": SH.to_local(lg).cpu().numpy().tolist(),
            "plain_logits": plain.cpu().numpy().tolist(),
            "a2a_calls": calls.n}


def _train(mesh, dev) -> dict:
    """One DeepSeek-V2 smoke train step with ``moe_impl="alltoall"`` at
    capacity 64 on the mesh beside the plain step (gather path)."""
    import dataclasses
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import sharding as SH
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs
    from repro_torch.models import moe as M
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import init_train_state, make_train_step

    cfg = dataclasses.replace(get_smoke_config(TRAIN_ARCH),
                              moe_impl="alltoall", capacity_factor=64.0)
    opt, clk = R._opt(cfg), ClockConfig()
    st = init_train_state(torch.Generator().manual_seed(2), cfg, opt, clk,
                          dev)
    dst = specs.place(st, specs.state_shardings(
        mesh, SH.DEFAULT_RULES, cfg, specs.abstract_state(cfg, opt, clk)))
    tokens = torch.from_numpy(moe_inputs()[1]).to(dev)
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1), "ev_hi": 7,
             "ev_lo": 9}
    step = make_train_step(cfg, opt, clk)
    s1, m1 = step(st, batch)
    with SH.use_mesh_rules(mesh), CommDebugMode() as comm, \
            Calls(M, "_moe_alltoall") as calls:
        s2, m2 = step(dst, batch)
    return {
        "metrics": {k: [float(m2[k]), float(m1[k])]
                    for k in ("loss", "grad_norm", "clock_sum")},
        "param_gap": max(R._gap(s2.params[k], s1.params[k])
                         for k in s1.params),
        "param_bound": max(
            2 * R.LR * (1 + R.WD * float(st.params[k].float().abs().max()))
            for k in st.params),
        "moment_rel": R._moment_rel(s2.opt, s1.opt),
        "clock_equal": bool(torch.equal(SH.to_local(s2.clock_cells),
                                        s1.clock_cells)),
        "a2a_calls": calls.n,
        "counts": {str(k): n for k, n in comm.get_comm_counts().items()}}


def _worker(argv: list) -> None:
    args = json.loads(argv[0])
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh

    dev = R._setup(args["backend"], args["rank"], 4, args["port"])
    mesh = make_local_mesh(2, 2)
    res = {"split": _split(mesh, dev), "slots": _slots(mesh, dev),
           "qwen": _qwen_decode(mesh, dev), "moe": _moe(mesh, dev, args["npz"]),
           "train": _train(mesh, dev)}
    if args["rank"] == 0:
        with open(args["out"], "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


class Ranks(R.Job):
    """This file's four workers, started at once."""

    def __init__(self, out: str, **args):
        port = R.free_port()
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        self.out = out
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, json.dumps(dict(
                args, rank=r, port=port, out=out))],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(4)]
        self._res = None


def port_moe_inputs(path: str) -> None:
    """The port's own float32 grok smoke weights in ``path`` (where JAX
    is not installed)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_smoke_config(MOE_ARCH), dtype="float32")
    params = init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    np.savez(path, **{k: v.numpy() for k, v in params.items()})


def check_port(res: dict) -> None:
    """The port's figures against its own plain paths (every case but
    the reference's)."""
    for key, (got, core) in res["split"].items():
        np.testing.assert_allclose(np.asarray(got), np.asarray(core),
                                   err_msg=key, **SPLIT_TOL)
    for (ring, slot), r in zip(SLOT_CASES, res["slots"].values()):
        check_slot(r, ring, slot)
    check_qwen(res["qwen"])
    m = res["moe"]
    assert m["route_calls"] == 1
    assert m["counts"].get(A2A) == 2, m["counts"]
    check_moe_forward(m)
    check_train(res["train"])


def check_slot(r: dict, ring: bool, slot: int) -> None:
    """Both buffers the plain write's, written in place, by two calls
    (K and V), with no collective."""
    assert r["equal"] == [True, True], r
    assert r["in_place"] and r["calls"] == 2, r
    assert r["collectives"] == 0, r
    assert (r["length"], r["pos"]) == (10, slot + 16 * ring + 1), r


def check_qwen(q: dict) -> None:
    """The plain tokens, one split-KV attention a layer a decode step (2
    layers), each with its three all-reduces."""
    assert q["tokens"]["mesh"] == q["tokens"]["plain"], q["tokens"]
    assert q["split_calls"] == 2 * N_DECODE, q["split_calls"]
    assert q["counts"].get(ALL_REDUCE, 0) >= 3 * 2 * N_DECODE, q["counts"]


def check_moe_forward(m: dict) -> None:
    """One all-to-all path a layer (2 layers), within the reference
    test's tolerance of the plain gather path."""
    assert m["a2a_calls"] == 2, m["a2a_calls"]
    np.testing.assert_allclose(np.asarray(m["logits"]),
                               np.asarray(m["plain_logits"]), **A2A_TOL)


def check_train(t: dict) -> None:
    """The all-to-all path ran (two all-to-alls a layer forward, two
    back) and the step is within the four-rank tolerances."""
    assert t["a2a_calls"] >= 2 and t["counts"].get(A2A, 0) >= 4, t
    for k, (mesh, plain) in t["metrics"].items():
        assert abs(mesh - plain) <= R.LOSS_RTOL * abs(plain), (k, mesh, plain)
    assert t["param_gap"] <= t["param_bound"], t["param_gap"]
    for k, rel in t["moment_rel"].items():
        assert rel <= R.MOMENT_RTOL[MOE_ARCH], (k, rel)
    assert t["clock_equal"]


# ---------------------------------------------------------------------------
# the reference (its own subprocess) and the dry runs
# ---------------------------------------------------------------------------

_REF = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    sys.path.insert(0, {here!r})
    from test_torch_explicit_collectives import (
        SPLIT_CASES, split_inputs, moe_inputs, MOE_ARCH)
    from repro.configs import get_smoke_config
    from repro.models import attention as A, moe as M, transformer as T
    from repro.models.params import init_params
    from repro.sharding import use_mesh_rules, make_rules

    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    q, k, v = split_inputs()
    split = {{}}
    for w, valid in SPLIT_CASES:
        out = A.decode_attention_split_kv(q, k, v, kv_valid=valid, window=w,
                                          q_pos=valid - 1, mesh=mesh)
        split[f"{{w}},{{valid}}"] = np.asarray(out).tolist()
    cfg = dataclasses.replace(get_smoke_config(MOE_ARCH), dtype="float32",
                              moe_impl="alltoall")
    params = init_params(jax.random.PRNGKey(3), cfg)
    x, tokens = moe_inputs()
    layer = {{n: params[f"layers/moe/{{n}}"][0]
             for n in ("router", "w_gate", "w_up", "w_down")}}
    y, aux = jax.jit(lambda p, x: M._moe_alltoall(
        p, cfg, x, mesh, ("data",), "model"))(layer, x)
    E = cfg.n_experts * cfg.moe_replicas
    T_loc = x.shape[0] // 4
    C_loc = max(1, int(cfg.capacity_factor * T_loc * cfg.top_k / E))
    keep = []
    for s in range(4):      # shard (data, model) = (s // 2, s % 2)
        _, (_, _, kp, _), _ = M._route_and_bucket(
            cfg, x[s * T_loc:(s + 1) * T_loc], layer["router"], E, C_loc)
        keep.append(np.asarray(kp).astype(int).tolist())
    cfg64 = dataclasses.replace(cfg, capacity_factor=64.0)
    with use_mesh_rules(mesh, make_rules()):
        lg, _ = jax.jit(lambda p, t: T.forward_train(p, cfg64, t))(
            params, tokens)
    print(json.dumps({{"split": split, "y": np.asarray(y).tolist(),
                      "aux": float(aux), "keep": keep,
                      "logits": np.asarray(lg).tolist()}}))
"""

#: the dry-run cells: (arch, shape, override); grok's 4 experts take
#: moe_replicas 4 so that 16 physical experts divide the model axis
DRY = [(QWEN, "decode_32k", {}), (QWEN, "decode_32k",
                                 {"decode_attn": "split_kv"}),
       (MOE_ARCH, "train_4k", {"moe_impl": "alltoall", "moe_replicas": 4})]
DRY_CHUNKS = dict(attn_chunk=2048, ssm_chunk=256)

_REF_DRY = """
    import dataclasses, json
    import jax
    from jax.sharding import AxisType
    from repro.launch import dryrun
    from repro.configs import get_smoke_config

    def mesh(multi_pod=False):
        return jax.make_mesh((16, 16), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    dryrun.make_production_mesh = mesh
    for a, s, over in {cells!r}:
        cfg = dataclasses.replace(get_smoke_config(a), **{chunks!r}, **over)
        rec = dryrun.run_cell(a, s, cfg_override=cfg, quiet=True)
        print(json.dumps([a, s, over, rec["status"],
                          rec["bytes_per_device"]["argument"]]), flush=True)
"""

_PORT_DRY = """
    import dataclasses, json
    from repro_torch.launch import dryrun
    from repro_torch.configs import get_smoke_config
    dryrun.init_fake_group(512)
    for a, s, over in {cells!r}:
        cfg = dataclasses.replace(get_smoke_config(a), **{chunks!r}, **over)
        rec = dryrun.run_cell(a, s, cfg_override=cfg, quiet=True)
        print(json.dumps([a, s, over, rec["status"],
                          rec["bytes_per_device"]["argument"],
                          rec["collectives"],
                          rec["replicated_fallback"]["gathers"]]), flush=True)
"""


def _start(code: str, **fmt) -> subprocess.Popen:
    e = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
             OMP_NUM_THREADS="2")
    e.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code.format(**fmt))],
        cwd=ROOT, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _lines(p: subprocess.Popen) -> list:
    out, err = p.communicate(timeout=600)
    assert p.returncode == 0, err[-4000:]
    return [json.loads(s) for s in out.splitlines() if s[:1] in "[{"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks, the reference and both dry runs, side by side."""
    import dataclasses
    import jax
    from repro.configs import get_smoke_config
    from repro.models import params as JP

    d = tmp_path_factory.mktemp("collectives")
    cfg = dataclasses.replace(get_smoke_config(MOE_ARCH), dtype="float32")
    npz = str(d / "grok.npz")
    np.savez(npz, **{k: np.asarray(v) for k, v in
                     JP.init_params(jax.random.PRNGKey(3), cfg).items()})
    procs = {"ranks": Ranks(str(d / "ranks.json"), backend="gloo", npz=npz),
             "ref": _start(_REF, here=HERE),
             "port_dry": _start(_PORT_DRY, cells=DRY, chunks=DRY_CHUNKS),
             "ref_dry": _start(_REF_DRY, cells=DRY, chunks=DRY_CHUNKS)}
    return {"ranks": procs["ranks"].result(),
            "ref": _lines(procs["ref"])[0],
            "port_dry": _lines(procs["port_dry"]),
            "ref_dry": _lines(procs["ref_dry"])}


def test_split_kv_matches_reference_and_attention_core(runs):
    for key, (got, core) in runs["ranks"]["split"].items():
        np.testing.assert_allclose(np.asarray(got), np.asarray(core),
                                   err_msg=key, **SPLIT_TOL)
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(runs["ref"]["split"][key]),
                                   err_msg=key, **SPLIT_TOL)


@pytest.mark.parametrize("ring,slot", SLOT_CASES)
def test_owner_writes_bit_identical_without_collectives(runs, ring, slot):
    check_slot(runs["ranks"]["slots"][f"{ring},{slot}"], ring, slot)


def test_qwen_split_kv_decode_gives_plain_tokens(runs):
    check_qwen(runs["ranks"]["qwen"])


def test_moe_alltoall_keeps_the_reference_slots_per_shard(runs):
    m, ref = runs["ranks"]["moe"], runs["ref"]
    assert m["route_calls"] == 1
    assert m["counts"].get(A2A) == 2, m["counts"]
    assert m["keep"] == ref["keep"]
    assert any(0 in k for k in ref["keep"])     # the capacity drops some
    np.testing.assert_allclose(np.asarray(m["y"]), np.asarray(ref["y"]),
                               **MOE_TOL)
    np.testing.assert_allclose(m["aux"], ref["aux"], **MOE_TOL)


def test_moe_alltoall_forward_matches_gather_and_reference(runs):
    m = runs["ranks"]["moe"]
    check_moe_forward(m)
    np.testing.assert_allclose(np.asarray(m["logits"]),
                               np.asarray(runs["ref"]["logits"]), **A2A_TOL)


def test_alltoall_train_step_within_four_rank_tolerance(runs):
    check_train(runs["ranks"]["train"])


def test_remat_recompute_sees_the_mesh_rules_on_another_thread():
    """The card runs a backward, and with it a remat recompute, on an
    autograd worker thread, where a context variable set by the caller
    is not set: the recompute must still see the forward's mesh rules
    (the MoE layer's choice of path reads them), so a backward run on
    another thread here must too."""
    import dataclasses
    import threading
    from repro_torch import sharding as SH
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_smoke_config(QWEN), remat_policy="dots")
    seen = []

    def fn(x):
        seen.append(SH.current_mesh())
        return torch.sin(x) * 2

    mesh = object()
    x = torch.randn(4, requires_grad=True)
    with SH.use_mesh_rules(mesh):
        y = T._remat(fn, cfg)(x).sum()
    grads = []
    worker = threading.Thread(
        target=lambda: grads.append(torch.autograd.grad(y, [x])[0]))
    worker.start()
    worker.join()
    assert seen == [mesh, mesh], seen        # the forward, the recompute
    torch.testing.assert_close(grads[0], 2 * torch.cos(x.detach()))


def _dry(runs, side: str) -> dict:
    return {(r[0], r[1], json.dumps(r[2], sort_keys=True)): r[3:]
            for r in runs[side]}


@pytest.mark.parametrize("arch,shape,over", DRY)
def test_dryrun_overrides_argument_bytes_match_reference(runs, arch, shape,
                                                         over):
    import test_torch_model_mesh_dryrun as DR

    key = (arch, shape, json.dumps(over, sort_keys=True))
    port, ref = _dry(runs, "port_dry")[key], _dry(runs, "ref_dry")[key]
    assert port[0] == "ok" and ref[0] == "ok", (port[0], ref[0])
    gap = sum(DR.host_scalars(arch).values()) if shape == "decode_32k" else 0
    assert port[1] == ref[1] - gap, (port[1], ref[1])


def test_dryrun_split_kv_writes_the_cache_in_place(runs):
    dry = _dry(runs, "port_dry")
    plain = dry[(QWEN, "decode_32k", "{}")]
    split = dry[(QWEN, "decode_32k", json.dumps({"decode_attn": "split_kv"}))]
    # the owner writes a seq-sharded cache's slot with either decode
    # attention: neither gathers the cache, to write it or to attend
    # (all-gathers below one layer's K for a rank's batch rows)
    from repro_torch.configs import get_smoke_config
    from repro_torch.shapes import SHAPES

    cfg, shape = get_smoke_config(QWEN), SHAPES["decode_32k"]
    layer_k = (shape.global_batch // 16 * shape.seq_len * cfg.n_kv_heads
               * cfg.d_head * 2)
    assert "assign" not in plain[3], plain[3]
    assert "assign" not in split[3], split[3]
    for rec in (plain, split):
        assert rec[2]["all-gather"] < layer_k, (rec[2], layer_k)
    assert split[2]["counts"]["all-reduce"] > 0


def test_dryrun_alltoall_issues_all_to_all(runs):
    dry = _dry(runs, "port_dry")
    rec = dry[(MOE_ARCH, "train_4k",
               json.dumps({"moe_impl": "alltoall", "moe_replicas": 4},
                          sort_keys=True))]
    assert rec[2]["counts"]["all-to-all"] > 0 and rec[2]["all-to-all"] > 0


if __name__ == "__main__":
    _worker(sys.argv[1:])
