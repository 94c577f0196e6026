"""The MoE gather path's experts on their shards
(``models.moe._moe_on_shards``), on the CPU.

- Four ranks, gloo groups in subprocesses (this file run as a script),
  on a (1, 4) and a (2, 2) (data, model) mesh: grok-1's and
  DeepSeek-V2's smoke configs (4 experts, which the model axis
  divides: each rank builds only its experts' buckets), grok-1's with
  ``n_experts=6`` on (1, 4) (the axis divides its experts' hidden dim
  instead: each rank keeps the whole bucket and runs its slice of that
  dim), grok-1's with ``n_experts=6`` and ``moe_d_ff=66`` on (1, 4)
  (the axis divides neither: the expert leaves are replicated over it
  and the layer keeps ``_moe_gather``'s replicated body), DeepSeek-V2's at capacity factor 0.6 on (1, 4) (drops) and
  grok-1's at capacity factor 8 on (2, 2) (the expert leaves' d_model
  shards gathered; at the default capacity each rank contracts its
  d_model shard).  ``moe_ffn`` of layer 0's weights, carried over from
  the JAX package's ``init_params``: y and aux within ``BF16_TOL`` of
  the plain port's and of the JAX ``moe_ffn`` (its ``_moe_gather``) on
  the same input; in float32 within ``F32_TOL`` of both, and the kept
  slots of every rank identical to the plain port's.  A
  ``TorchDispatchMode`` over the mesh forward and backward sees no
  local [T * k, D] slab (its rows the product of the leading dims),
  and where the experts are sharded no bucket of more than ceil(E /
  model) * C rows and one of exactly that many.  One train step of the
  smoke model within ``test_torch_model_mesh_ranks``' four-rank
  tolerances, and in float32 (where the routes are the plain step's:
  bfloat16 routes part at near ties) loss and grad norm within 1e-5
  and each moment within 1e-4; every MoE layer through
  ``_moe_on_shards`` where the model axis splits the experts or their
  hidden dim.
- The dry run on a fake 512-rank group (one subprocess): deepseek-v2
  and grok-1 at ``prefill_32k``, full widths, depth cut to 1, and
  hymba-1.5b at ``long_500k`` uncut: temp within the bounds below, and
  argument bytes those of the record before the repair, and temp
  within 10% of the repaired record.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, HERE)

from test_torch_model_mesh_ranks import (BF16_TOL, LOSS_RTOL,  # noqa: E402
                                         MOMENT_RTOL)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
#: name: (arch, overrides of its smoke config, mesh (data, model))
CASES = {
    "grok_1x4": ("grok_1_314b", {}, [1, 4]),
    "deepseek_1x4": ("deepseek_v2_236b", {}, [1, 4]),
    "grok_e6_1x4": ("grok_1_314b", {"n_experts": 6}, [1, 4]),
    "grok_e6_ff66_1x4": ("grok_1_314b", {"n_experts": 6, "moe_d_ff": 66},
                         [1, 4]),
    "deepseek_drops_1x4": ("deepseek_v2_236b", {"capacity_factor": 0.6},
                           [1, 4]),
    "grok_2x2": ("grok_1_314b", {}, [2, 2]),
    "deepseek_2x2": ("deepseek_v2_236b", {}, [2, 2]),
    "grok_cap8_2x2": ("grok_1_314b", {"capacity_factor": 8.0}, [2, 2]),
}
MESHES = {"1x4": [1, 4], "2x2": [2, 2]}
#: the MoE layer's input [B, S, D] and the train step's tokens [B, S]:
#: T = 40 tokens, so that neither T nor T / data is a multiple of a
#: case's capacity C (25, 16, 12 and 160) and T * k = 80 is no weight's
#: rows: a bucket and a slot slab are told apart by their rows.  On
#: (2, 2) the expert leaves shard d_model over "data": at C = 25 (2 C <
#: 3 D) each rank contracts its d_model shard, at capacity factor 8 (C
#: = 160) the leaves' shards are gathered
B, S = 4, 10
#: a moment's relative norm against the plain step's: the MoE
#: four-rank tolerance (tokens at near-tie routes take other experts)
MOMENT_TOL = MOMENT_RTOL["grok_1_314b"]
#: the same in float32 on both sides, where the routes are the plain
#: step's: ``test_torch_head_views``' float32 limit
F32_MOMENT_RTOL = 1e-4
#: the reference's dry run (``scripts/reference_dryrun.py``, 16 x 16),
#: temp bytes a device
REF_TEMP = {("deepseek_v2_236b", "prefill_32k"): 147_210_406_840,
            ("grok_1_314b", "prefill_32k"): 95_143_462_584,
            ("hymba_1_5b", "long_500k"): 19_456_448}
#: the port's record before the repair (``python -m
#: repro_torch.launch.dryrun``'s ``run_cell``, 16 x 16, the cells and
#: depths below): argument bytes a device and temp
DRY_RECORD = {("deepseek_v2_236b", "prefill_32k"): (47_273_984,
                                                     297_084_581_894),
              ("grok_1_314b", "prefill_32k"): (51_324_928, 133_351_919_620),
              ("hymba_1_5b", "long_500k"): (118_575_748, 52_784_476)}
#: the same cells' temp after the repair (the same run): a rise of more
#: than ``DRY_SLACK`` is a regression even inside the bounds above (a
#: [T * k, D] slab or a whole ye at full width stays under them).
#: hymba-1.5b's decode writes its SSM caches in place since, so the step
#: creates no output and its temp is its whole transient, a layer's
#: weight casts (844,636 before: the end-of-step high less the restacked
#: caches it created; peak 126,016,784 -> 121,430,944 bytes)
DRY_REPAIRED = {("deepseek_v2_236b", "prefill_32k"): 27_156_172_800,
                ("grok_1_314b", "prefill_32k"): 80_386_285_572,
                ("hymba_1_5b", "long_500k"): 2_851_180}
DRY_SLACK = 1.1
#: the card's memory case: (tokens, d_model) of one routed layer of
#: DeepSeek-V2's routing shape (``_memory``)
CARD_MEMORY = (4096, 5120)
#: depth of each dry-run cell (None: the config's own)
DRY_DEPTH = {("deepseek_v2_236b", "prefill_32k"): 1,
             ("grok_1_314b", "prefill_32k"): 1,
             ("hymba_1_5b", "long_500k"): None}


def smoke(name: str, package: str = "repro_torch", **kw):
    import dataclasses
    import importlib
    arch, over, _ = CASES[name]
    cfg = importlib.import_module(f"{package}.configs").get_smoke_config(arch)
    return dataclasses.replace(cfg, **over, **kw)


def layer_input(cfg) -> np.ndarray:
    return np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def train_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(4).integers(0, cfg.vocab, (B, S),
                                             dtype=np.int32)


def expected(cfg, model: int) -> dict:
    """T * k, C, the bucket rows a rank builds where the model axis
    shards the experts (None where it keeps the whole bucket), and
    whether the layer runs ``_moe_on_shards`` (the axis divides the
    experts or their hidden dim)."""
    E = cfg.n_experts * cfg.moe_replicas
    T = B * S
    C = max(1, int(cfg.capacity_factor * T * cfg.top_k / E))
    return {"Tk": T * cfg.top_k, "C": C, "T": T,
            "rows": -(-E // model) * C if E % model == 0 else None,
            "on_shards": E % model == 0 or cfg.moe_d_ff % model == 0}


# ---------------------------------------------------------------------------
# the worker (this file run as a script, in its own process)
# ---------------------------------------------------------------------------

def _rows_seen():
    """A dispatch mode recording (rows, last dim) of every local
    floating tensor of two or more dims an op returns, rows the product
    of the leading dims (DTensor ops are passed on to DTensor, which
    runs them as local ops seen here; its shape propagation's fake
    tensors are not recorded)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    fake = torch._subclasses.FakeTensor

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            self.shapes.update(
                (math.prod(t.shape[:-1]), t.shape[-1])
                for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.ndim >= 2
                and t.is_floating_point() and not isinstance(t, fake))
            return out
    return Seen()


class _Calls:
    """Counts the calls of ``mod.name`` (and records each output with
    ``record``) while active."""

    def __init__(self, mod, name: str, record=None):
        self.mod, self.name, self.record, self.n = mod, name, record, 0

    def __enter__(self):
        fn = self.orig = getattr(self.mod, self.name)

        def wrapped(*a, **k):
            self.n += 1
            out = fn(*a, **k)
            if self.record:
                self.record(out)
            return out
        setattr(self.mod, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def _load(cfg, npz: str, dev) -> dict:
    import torch
    from repro_torch.models.params import param_table
    with np.load(npz) as z:
        return {p: torch.from_numpy(z[p].copy()).to(dev)
                for p in param_table(cfg)}


def _forward(name: str, mesh, dev, params, dparams) -> dict:
    """``moe_ffn`` of layer 0 plain and on ``mesh``, bfloat16 (with the
    backward, under the dispatch mode) and float32: y, aux, the kept
    slots of each rank."""
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as SH
    from repro_torch.models import moe as M

    def layer0(p):
        return {k[len("layers/moe/"):]: v[0] for k, v in p.items()
                if k.startswith("layers/moe/")}

    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = smoke(name, dtype=dtype)
        x = torch.from_numpy(layer_input(cfg)).to(dev, cfg.compute_dtype)
        w = torch.from_numpy(np.random.default_rng(6).standard_normal(
            x.shape).astype(np.float32)).to(dev, cfg.compute_dtype)
        keeps = {}
        res = {}
        for side, p, m in (("plain", params, None), ("mesh", dparams, mesh)):
            seen = _rows_seen()
            with SH.use_mesh_rules(m), _Calls(
                    M, "_route", lambda o: keeps.__setitem__(
                        side, o[0][2].cpu().numpy().astype(int).tolist())), \
                    _Calls(M, "_moe_on_shards") as calls:
                xi = x.detach().requires_grad_(dtype == "bfloat16")
                xm = SH.shard(xi, ("act_batch", "act_seq", "act_embed"))
                with (seen if m is not None and dtype == "bfloat16"
                      else _rows_seen()):
                    y, aux = M.moe_ffn(layer0(p), cfg, xm, mesh=m,
                                       dp_axes=("data",) if m else None)
                    if dtype == "bfloat16":
                        ((SH.to_local(y) * w).sum()
                         + SH.to_local(aux)).backward()
            res[side] = [SH.to_local(y.detach()).float().cpu().numpy().tolist(),
                         float(SH.to_local(aux.detach()))]
            if m is not None:
                res["calls"] = calls.n
                if dtype == "bfloat16":
                    res["shapes"] = [list(s) for s in seen.shapes]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, keeps["mesh"])
        res["keep"] = {"plain": keeps["plain"], "mesh": every}
        out[dtype] = res
    return out


def _train(name: str, mesh, dev, params, dparams) -> dict:
    """One train step of the smoke model plain and on ``mesh`` from the
    same state, in bfloat16 and (``"f32"``) in float32."""
    import torch
    from repro_torch import sharding as SH
    from repro_torch.launch import specs
    from repro_torch.models import moe as M
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import init_train_state, make_train_step
    from test_torch_model_mesh_ranks import (LR, WD, _gap, _moment_rel, _opt,
                                             _value)

    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = smoke(name, dtype=dtype)
        opt, clk = _opt(cfg), ClockConfig()
        st = init_train_state(torch.Generator().manual_seed(2), cfg, opt,
                              clk, dev)
        st.params.update(params)
        sh = specs.state_shardings(mesh, SH.DEFAULT_RULES, cfg,
                                   specs.abstract_state(cfg, opt, clk))
        dst = specs.place(st, sh)
        step = make_train_step(cfg, opt, clk)
        tokens = torch.from_numpy(train_tokens(cfg)).to(dev)
        batch = {"tokens": tokens, "labels": tokens.roll(1, 1), "ev_hi": 7,
                 "ev_lo": 9}
        routes = {"plain": [], "mesh": []}

        def route(side):
            # each call's slot destinations and kept slots (every rank
            # routes the same global view)
            return _Calls(M, "_route", lambda o: routes[side].append(
                [o[0][1].tolist(), o[0][2].tolist()]))
        with route("plain"):
            s1, m1 = step(st, batch)
        with SH.use_mesh_rules(mesh), route("mesh"), \
                _Calls(M, "_moe_on_shards") as calls:
            s2, m2 = step(dst, batch)
        res = {
            "calls": calls.n,
            "routes_agree": routes["plain"] == routes["mesh"],
            "metrics": {k: [float(m2[k]), float(m1[k])]
                        for k in ("loss", "grad_norm", "clock_sum")},
            "moment_rel": _moment_rel(s2.opt, s1.opt),
            "moment_norm": {
                f"{mom} {k}": [float(_value(s2.opt[mom][k]).norm()),
                               float(_value(s1.opt[mom][k]).norm())]
                for mom in ("m", "v") for k in s1.opt[mom]}}
        if dtype == "float32":
            out["f32"] = res
            continue
        res["param_gap"] = max(_gap(s2.params[k], s1.params[k])
                               for k in s1.params)
        res["param_bound"] = max(
            2 * LR * (1 + WD * float(st.params[k].float().abs().max()))
            for k in st.params)
        out.update(res)
    return out


def _memory(mesh, dev, tokens: int, width: int) -> dict:
    """One routed MoE layer of DeepSeek-V2's routing shape (160 experts,
    top-6, capacity factor 1.25; no shared experts) at d_model
    ``width`` and d_ff ``width * 3 / 10`` over ``tokens`` tokens, on
    ``mesh`` and plain, from seeded weights: y's gap, the mesh layer's
    ``max_memory_allocated`` above its start (on the card) and one
    rank's whole bucket [E * C, D] in bytes."""
    import dataclasses

    import torch
    from repro_torch import sharding as SH
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.models import moe as M
    from repro_torch.models.params import param_table

    cfg = dataclasses.replace(get_config("deepseek_v2_236b"), n_layers=1,
                              d_model=width, moe_d_ff=width * 3 // 10,
                              n_shared_experts=0)
    table = {k[len("layers/moe/"):]: v for k, v in param_table(cfg).items()
             if k.startswith("layers/moe/")}
    g = torch.Generator(dev).manual_seed(0)
    layer = {k: torch.randn(info.shape[1:], generator=g, device=dev,
                            dtype=cfg.compute_dtype) * 0.02
             for k, info in table.items()}
    placed = {k: specs.place(v, SH.NamedSharding(mesh, SH.logical_to_pspec(
        mesh, SH.DEFAULT_RULES, table[k].axes[1:], v.shape)))
        for k, v in layer.items()}
    x = torch.randn((1, tokens, width), generator=g, device=dev,
                    dtype=cfg.compute_dtype)
    E = cfg.n_experts * cfg.moe_replicas
    C = max(1, int(cfg.capacity_factor * tokens * cfg.top_k / E))
    out = {"whole_bucket": E * C * width * x.element_size()}
    cuda = dev.type == "cuda"
    with torch.no_grad(), SH.use_mesh_rules(mesh):
        xm = SH.shard(x, ("act_batch", "act_seq", "act_embed"))
        M.moe_ffn(placed, cfg, xm, mesh=mesh)      # NCCL and cuBLAS set-up
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.memory_allocated(dev)
        y, _ = M.moe_ffn(placed, cfg, xm, mesh=mesh)
        if cuda:
            torch.cuda.synchronize(dev)
            out["transient"] = torch.cuda.max_memory_allocated(dev) - start
        y = SH.to_local(y).float()
    with torch.no_grad():
        want, _ = M.moe_ffn(layer, cfg, x)
    want = want.float()
    out["inside_tol"] = bool((y - want).abs().le(
        BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs()).all())
    out["gap"] = float((y - want).abs().max())
    return out


def _worker(argv: list) -> None:
    import torch.distributed as dist
    from repro_torch import sharding as SH
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_local_mesh
    from test_torch_model_mesh_ranks import _setup

    args = json.loads(argv[0])
    dev = _setup(args.get("backend", "gloo"), args["rank"], args["world"],
                 args["port"])
    mesh = make_local_mesh(*args["mesh"])
    res = {}
    if "memory" in args:
        res["memory"] = _memory(mesh, dev, *args["memory"])
    for name in args.get("cases", ()):
        cfg = smoke(name)
        params = _load(cfg, args["npz"][name], dev)
        dparams = specs.place(params, specs.params_shardings(
            mesh, SH.DEFAULT_RULES, cfg))
        res[name] = {"forward": _forward(name, mesh, dev, params, dparams),
                     "train": _train(name, mesh, dev, params, dparams)}
    if args["rank"] == 0:
        with open(args["out"], "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def ranks(out: str, mesh: list, **args) -> list:
    """This file's worker on four processes (rank 0 writes ``out``),
    started at once."""
    from test_torch_model_mesh_ranks import free_port

    port = free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, __file__, json.dumps(dict(
            args, rank=r, world=4, port=port, out=out, mesh=mesh))],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]


def result(procs: list, out: str) -> dict:
    """Rank 0's output once every process of ``procs`` has exited 0."""
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    with open(out) as f:
        return json.load(f)


def jax_case(name: str, path: str) -> dict:
    """The JAX package's weights of ``smoke(name)`` in ``path`` (float32
    masters), and the JAX ``moe_ffn`` of layer 0 on ``layer_input`` in
    bfloat16 and float32: (y, aux)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.models import moe as JM
    from repro.models import params as JP

    cfg = smoke(name, "repro")
    params = JP.init_params(jax.random.PRNGKey(3), cfg)
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    layer = {k[len("layers/moe/"):]: v[0] for k, v in params.items()
             if k.startswith("layers/moe/")}
    out = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        x = jnp.asarray(layer_input(c)).astype(c.compute_dtype)
        y, aux = jax.jit(lambda p, x: JM.moe_ffn(p, c, x))(layer, x)
        out[dtype] = (np.asarray(y, np.float32), float(aux))
    return out


def port_case(name: str, path: str) -> None:
    """The port's own weights of ``smoke(name)`` (a seeded generator) in
    ``path``: the inputs where JAX is not installed."""
    import torch
    from repro_torch.models.params import init_params

    params = init_params(torch.Generator().manual_seed(3), smoke(name), "cpu")
    np.savez(path, **{k: v.numpy() for k, v in params.items()})


_DRY = """
    import dataclasses, json
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    dryrun.init_fake_group(512)
    out = {{}}
    for (arch, shape), depth in {cells!r}:
        cfg = get_config(arch)
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        rec = dryrun.run_cell(arch, shape, quiet=True, cfg_override=cfg)
        out[f"{{arch}}:{{shape}}"] = {{
            "status": rec["status"],
            "argument": rec["bytes_per_device"]["argument"],
            "temp": rec["bytes_per_device"]["temp"],
            "gathers": rec["replicated_fallback"]["gathers"]}}
    print(json.dumps(out), flush=True)
"""


def dry_run() -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_DRY.format(
            cells=list(DRY_DEPTH.items())))],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def card_cases(tmp, backend: str) -> dict:
    """The (1, 4) cases on ``backend`` from the port's weights (the
    four-card ``gpu`` case): rank 0's results by case name."""
    npz = {n: str(tmp / f"{n}.npz") for n, c in CASES.items()
           if c[2] == MESHES["1x4"]}
    for n, p in npz.items():
        port_case(n, p)
    out = str(tmp / "1x4.json")
    return result(ranks(out, MESHES["1x4"], backend=backend,
                        cases=list(npz), npz=npz), out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two four-rank jobs and the dry run, side by side; the JAX
    forwards in this process meanwhile."""
    d = tmp_path_factory.mktemp("moe_mesh")
    dry = dry_run()
    npz, ref = {}, {}
    for n in CASES:
        npz[n] = str(d / f"{n}.npz")
        ref[n] = jax_case(n, npz[n])
    jobs = {m: ranks(str(d / f"{m}.json"), mesh, backend="gloo",
                     cases=[n for n, c in CASES.items() if c[2] == mesh],
                     npz=npz)
            for m, mesh in MESHES.items()}
    out = {"ref": ref}
    for m, procs in jobs.items():
        out.update(result(procs, str(d / f"{m}.json")))
    stdout, stderr = dry.communicate(timeout=600)
    assert dry.returncode == 0, stderr[-4000:]
    out["dry"] = json.loads(stdout.strip().splitlines()[-1])
    return out


def check_forward(name: str, res: dict, ref=None) -> None:
    """y and aux on the mesh within the dtype's tolerance of the plain
    port's (and of the JAX ``moe_ffn``'s where given), the kept slots
    of every rank identical to the plain port's, and the mesh forward
    through ``_moe_on_shards`` where the model axis splits the experts
    or their hidden dim (else not)."""
    on_shards = expected(smoke(name), CASES[name][2][1])["on_shards"]
    for dtype, tol in (("bfloat16", BF16_TOL), ("float32", F32_TOL)):
        r = res[dtype]
        assert r["calls"] == int(on_shards), r["calls"]
        y, aux = np.asarray(r["mesh"][0]), r["mesh"][1]
        wants = [(np.asarray(r["plain"][0]), r["plain"][1])]
        if ref is not None:
            wants.append(ref[dtype])
        for wy, waux in wants:
            np.testing.assert_allclose(y, wy, **tol, err_msg=dtype)
            np.testing.assert_allclose(aux, waux, **tol, err_msg=dtype)
        for keep in r["keep"]["mesh"]:
            assert keep == r["keep"]["plain"], dtype


def check_bounds(name: str, res: dict) -> None:
    """No local [T * k, D] tensor; where the experts are sharded no
    bucket (rows of D a multiple of C past the token counts) of more
    than ceil(E / model) * C rows, and one of exactly that many."""
    cfg = smoke(name)
    data, model = CASES[name][2]
    want = expected(cfg, model)
    shapes = [tuple(s) for s in res["bfloat16"]["shapes"]]
    widths = (cfg.d_model, cfg.d_model // data)   # a d_model shard
    assert shapes
    assert (want["Tk"], cfg.d_model) not in shapes, want
    if want["rows"] is None:
        return
    tokens = (want["T"], want["T"] // data)
    assert all(t % want["C"] for t in tokens), want
    buckets = [s for s in shapes if s[0] % want["C"] == 0
               and s[0] not in tokens and s[1] in widths]
    assert buckets and max(b[0] for b in buckets) == want["rows"], \
        (buckets, want)


def check_train(name: str, res: dict) -> None:
    """The train step on the mesh against the plain one, every MoE layer
    through ``_moe_on_shards`` (again in its remat recompute) where the
    model axis splits the experts or their hidden dim.  In
    bfloat16 the loss and the params within the four-rank tolerances,
    and, where every route of the step is the plain step's, the grad
    norm and the moments too: where a near tie routes a token to
    another expert (the head-split attention's partial sums move the
    router's input by an ulp), its gradient goes elsewhere and only the
    float32 step compares them.  In float32 the routes must agree, the
    loss and grad norm within ``F32_TOL``'s rtol and each moment within
    ``F32_MOMENT_RTOL``."""
    cfg = smoke(name)
    runs = 1 if cfg.remat_policy == "full" else 2
    if not expected(cfg, CASES[name][2][1])["on_shards"]:
        runs = 0
    for r in (res, res["f32"]):
        assert r["calls"] == runs * cfg.n_layers, r["calls"]
    held = ("loss", "grad_norm", "clock_sum") if res["routes_agree"] \
        else ("loss", "clock_sum")
    for k in held:
        mesh, plain = res["metrics"][k]
        assert abs(mesh - plain) <= LOSS_RTOL * abs(plain), (k, mesh, plain)
    assert res["param_gap"] <= res["param_bound"], res["param_gap"]
    if res["routes_agree"]:
        for k, rel in res["moment_rel"].items():
            assert rel <= MOMENT_TOL, (k, rel, res["moment_norm"][k])
    f32 = res["f32"]
    assert f32["routes_agree"]
    for k, (mesh, plain) in f32["metrics"].items():
        assert abs(mesh - plain) <= F32_TOL["rtol"] * abs(plain), \
            (k, mesh, plain)
    for k, rel in f32["moment_rel"].items():
        assert rel <= F32_MOMENT_RTOL, (k, rel, f32["moment_norm"][k])


@pytest.mark.parametrize("name", list(CASES))
def test_four_rank_moe_forward_matches_plain_and_jax(runs, name):
    res = runs[name]["forward"]
    check_forward(name, res, runs["ref"][name])
    # the capacity case drops slots; the others may
    assert "drops" not in name or 0 in res["float32"]["keep"]["plain"]


@pytest.mark.parametrize("name", list(CASES))
def test_four_rank_moe_holds_no_slot_slab_nor_foreign_buckets(runs, name):
    check_bounds(name, runs[name]["forward"])


@pytest.mark.parametrize("name", list(CASES))
def test_four_rank_moe_train_step_within_tolerance(runs, name):
    check_train(name, runs[name]["train"])


@pytest.mark.parametrize("cell", list(DRY_DEPTH))
def test_dry_run_moe_and_hymba_temp_within_bounds(runs, cell):
    """temp a device no higher than the reference's for deepseek-v2,
    within 1.5x of it for grok-1 (and no higher than the record before
    the repair) and for hymba-1.5b, and within ``DRY_SLACK`` of the
    repaired record; argument bytes the record's; no MoE gather of a
    sharded tensor."""
    rec = runs["dry"][":".join(cell)]
    assert rec["status"] == "ok", rec
    argument, temp = DRY_RECORD[cell]
    assert rec["argument"] == argument, rec
    bound = (REF_TEMP[cell] if cell[0] == "deepseek_v2_236b"
             else min(1.5 * REF_TEMP[cell], temp))
    assert rec["temp"] <= bound, (rec["temp"], bound)
    assert rec["temp"] <= DRY_SLACK * DRY_REPAIRED[cell], \
        (rec["temp"], DRY_REPAIRED[cell])
    assert "moe" not in rec["gathers"], rec["gathers"]


if __name__ == "__main__":
    _worker(sys.argv[1:])
