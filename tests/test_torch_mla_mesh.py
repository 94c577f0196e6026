"""MLA's latent decode cache on its seq shards, and the SSM decode
caches written as they are placed, on the CPU.

- Four ranks, gloo groups in subprocesses (this file run as a script),
  on a (1, 4) and a (2, 2) (data, model) mesh: DeepSeek-V2's smoke
  config with the JAX package's weights carried over
  (``convert.params_from_jax``).  The prompt is prefilled plain, the
  caches placed by ``launch.specs.cache_shardings`` (the latents' seq
  over the model axis), and ``N_DECODE`` steps decoded on the mesh
  beside the plain port, on the same seeded tokens:

  * each step writes the latents in place (the buffers it returns are
    the objects that went in), each layer's owner writing its slot
    (``attention._sharded_slot_update``, two a layer) and the absorbed
    attention running on the shards (``mla._absorbed_on_shards``, one a
    layer);
  * after each step the buffers are bit-identical to the plain port's
    write of the same rows (``sharding.assign`` of the rows the step
    wrote, into a plain copy of the buffers before it), layer 0 (whose
    input is the token's embedding on both sides) bit-identical to the
    plain port's decode, and the whole within ``BF16_TOL`` of it;
  * each step's logits within ``BF16_TOL`` of the plain port's and of
    the JAX package's ``decode_step`` (its ``mla_block``) on the same
    tokens; in float32 each side's greedy tokens identical;
  * no ``assign`` or ``einsum`` in ``sharding.FALLBACKS``, no
    collective reads a cache's storage, the step's collectives (kind and
    bytes) the same with a cache of twice the slots (none scales with
    the cache), and on (1, 4) no all-gather at all (on (2, 2) the
    weights' FSDP dims are gathered over "data", as every use of a
    weight gathers them).

- mamba2-130m's smoke config on (1, 4): the conv and state buffers
  after each decode step bit-identical to the values the step wrote
  (``sharding.assign``'s whole-buffer write, in place: the objects that
  went in), layer 0 bit-identical to the plain port's decode and the
  logits within ``BF16_TOL``; no ``assign`` fallback, no collective
  reads a cache, and no all-gather of a layer's conv buffer's bytes
  (the in-projection's output and the conv's are still gathered for
  their splits: [B, 1, width] activations that the model axis shards
  off the split's boundaries).

- The dry run on a fake 512-rank group (one subprocess), full configs
  at ``decode_32k`` on 16 x 16: deepseek-v2, mamba2-130m and
  hymba-1.5b.  all-gather a device a step at or below the reference's
  listed bytes (``GATHER_BOUND``; deepseek-v2's all collectives too),
  argument bytes the record before the repair (``DRY_RECORD``), peak at
  most 1% above it, and deepseek-v2's temp at most 4.61e9 bytes.  temp
  is not held to the record elsewhere: a step that writes its caches in
  place creates no output, so its temp is its whole transient, where
  the record's was the end-of-step high less the rewritten caches it
  created (hymba-1.5b's rises 67,581,840 -> 69,229,936 bytes while its
  peak falls 951,403,184 -> 900,312,208).
"""
import copy
import dataclasses
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

from test_torch_model_mesh_ranks import BF16_TOL  # noqa: E402

#: float32 on both sides: ``test_torch_moe``'s port-against-JAX limit
F32_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = {"bfloat16": BF16_TOL, "float32": F32_TOL}

MLA_ARCH, SSM_ARCH = "deepseek_v2_236b", "mamba2_130m"
MESHES = {"1x4": [1, 4], "2x2": [2, 2]}
#: prompt [B, S], then ``N_DECODE`` steps into a buffer of ``BUF``
#: slots: the slots written (4..9) fall in shards 1-3 of 3 slots on
#: (1, 4) and in both shards of 6 on (2, 2)
B, S, N_DECODE, BUF = 4, 4, 6, 12
#: the functional collectives' names -> kind
KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all"}
#: the dry run's cells (16 x 16, full configs): the bound on all-gather
#: bytes a device a step, from the reference's listed bytes
#: (``scripts/reference_dryrun.py``): deepseek-v2's 166,287,872 a layer
#: (its HLO lists the scanned layer once) x 60, and its collectives in
#: all (175,885,856 a layer) x 60; mamba2-130m's 211,939,840 for the
#: cell; hymba-1.5b 0.35e9 (the reference lists 92,103,680 for its
#: scanned layer)
GATHER_BOUND = {"deepseek_v2_236b": 9.96e9, "mamba2_130m": 0.212e9,
                "hymba_1_5b": 0.35e9}
COLLECTIVE_BOUND = {"deepseek_v2_236b": 10.56e9}
#: the record before the repair (``python -m repro_torch.launch.dryrun``,
#: 16 x 16, ``decode_32k``): argument and peak bytes a device
DRY_RECORD = {"deepseek_v2_236b": (3_469_240_352, 9_163_954_480),
              "mamba2_130m": (168_707_360, 529_151_624),
              "hymba_1_5b": (830_568_224, 951_403_184)}
DRY_SLACK = 1.01
#: deepseek-v2's temp a device at most (the reference lists 8.01e9)
TEMP_BOUND = {"deepseek_v2_236b": 4.61e9}
#: the card's memory case (``_memory``): batch and latent cache slots of
#: one MLA layer at DeepSeek-V2's full attention widths
CARD_MEMORY = (4, 4096)


def smoke(arch: str, package: str = "repro_torch", **kw):
    import importlib
    cfg = importlib.import_module(f"{package}.configs").get_smoke_config(arch)
    return dataclasses.replace(cfg, **kw)


def tokens(cfg) -> tuple:
    """The prompt [B, S] and the fed tokens [N_DECODE, B], int32."""
    rng = np.random.default_rng(5)
    return (rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
            rng.integers(0, cfg.vocab, (N_DECODE, B), dtype=np.int32))


# ---------------------------------------------------------------------------
# the worker (this file run as a script, one process a rank)
# ---------------------------------------------------------------------------

def _collectives(reads_cache):
    """A dispatch mode recording each functional collective's kind,
    output bytes and whether its input is on a storage in
    ``reads_cache`` (a set of storage keys); DTensor ops are passed on
    to DTensor, which runs them as the local ops seen here."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            kind = KINDS.get(func._overloadpacket.__name__)
            if kind is not None:
                src = args[0]
                self.ops.append([kind, out.numel() * out.element_size(),
                                 src.untyped_storage()._cdata in reads_cache])
            return out
    return Seen()


class Calls:
    """While active, counts the calls of ``module.name`` and hands each
    call's arguments to ``record`` and its result to ``out``."""

    def __init__(self, module, name: str, record=None, out=None):
        self.n, self.module, self.name = 0, module, name
        self.fn, self.record, self.out = getattr(module, name), record, out

    def __enter__(self):
        def counted(*a, **kw):
            self.n += 1
            if self.record is not None:
                self.record(*a, **kw)
            res = self.fn(*a, **kw)
            if self.out is not None:
                self.out(res)
            return res
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _leaves(caches: dict) -> dict:
    """{"attn/ckv": tensor, ...}: every tensor field of the caches."""
    return {f"{k}/{f}": t for k, c in caches.items()
            for f, t in vars(c).items() if isinstance(t, torch.Tensor)}


def _whole(t) -> torch.Tensor:
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _storages(caches: dict) -> set:
    """The keys of the storages under the caches' local tensors."""
    return {(t.to_local() if hasattr(t, "to_local") else t)
            .untyped_storage()._cdata for t in _leaves(caches).values()}


def _placed(caches: dict, mesh) -> dict:
    from repro_torch import sharding as SH
    from repro_torch.launch import specs

    return specs.place(copy.deepcopy(caches), specs.cache_shardings(
        mesh, SH.DEFAULT_RULES, caches))


def _mla_steps(mesh, model, dmodel, cfg, prompt, fed, tol) -> list:
    """``N_DECODE`` decode steps of ``fed`` tokens on ``mesh`` from the
    plain prefill's cache placed by ``cache_shardings``, beside the
    plain port's: each step's figures (see the module docstring)."""
    from repro_torch import sharding as SH
    from repro_torch.models import attention as A
    from repro_torch.models import mla as MLA
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    _, pc = T.prefill(model, cfg, prompt, buf_len=BUF)
    dc = _placed(pc, mesh)
    steps = []
    for i in range(N_DECODE):
        before = {k: _whole(t).clone() for k, t in _leaves(dc).items()}
        ins, rows, routes = _leaves(dc), [], {"plain": [], "mesh": []}
        seen = _collectives(_storages(dc))

        def route(side):
            # each MoE layer's slot destinations and kept slots (every
            # rank routes the whole batch)
            return Calls(M, "_route", out=lambda o: routes[side].append(
                [o[0][1].tolist(), o[0][2].tolist()]))
        SH.FALLBACKS.clear()
        with SH.use_mesh_rules(mesh), seen, route("mesh"), \
                Calls(A, "_sharded_slot_update",
                      lambda buf, row, slot, *a, **k: rows.append(
                          (slot, row))) as writes, \
                Calls(MLA, "_absorbed_on_shards") as absorbed:
            ml, dc = T.decode_step(dmodel, cfg, dc, fed[i], S + i)
        fallbacks = dict(SH.FALLBACKS)
        with route("plain"):
            pl, pc = T.decode_step(model, cfg, pc, fed[i], S + i)
        got, plain = _leaves(dc), _leaves(pc)
        # the plain port's write of the step's rows (gathered only now,
        # outside the step), layer by layer: ckv, then krope
        for n, (slot, row) in enumerate(rows):
            name = ("attn/ckv", "attn/krope")[n % 2]
            SH.assign(before[name][n // 2],
                      (..., slice(slot, slot + 1), slice(None)), _whole(row))
        gap = {k: (_whole(t).float() - plain[k].float()).abs()
               for k, t in got.items()}
        steps.append({
            "same_objects": all(got[k] is ins[k] for k in got),
            "written": {k: bool(torch.equal(_whole(t), before[k]))
                        for k, t in got.items()},
            "layer0": {k: bool(torch.equal(_whole(t)[0], plain[k][0]))
                       for k, t in got.items()},
            "cache_gap": {k: float(g.max()) for k, g in gap.items()},
            "within": {k: bool(g.le(tol["atol"] + tol["rtol"]
                                    * plain[k].float().abs()).all())
                       for k, g in gap.items()},
            "routes_agree": routes["mesh"] == routes["plain"],
            "writes": writes.n, "absorbed": absorbed.n,
            "fallbacks": fallbacks, "collectives": seen.ops,
            "logits": SH.to_local(ml).float().cpu().numpy().tolist(),
            "plain_logits": pl.float().cpu().numpy().tolist()})
    return steps


def _mla_case(mesh, dev, npz: str) -> dict:
    """DeepSeek-V2's smoke decode on ``mesh`` beside the plain port, in
    bfloat16 and float32 (``"f32"``): the figures the module docstring
    lists."""
    from repro_torch import convert
    from repro_torch import sharding as SH
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T

    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    out = {}
    with torch.no_grad():
        for dtype in ("bfloat16", "float32"):
            cfg = smoke(MLA_ARCH, dtype=dtype)
            prompt, fed = (torch.from_numpy(a).to(dev) for a in tokens(cfg))
            params = convert.params_from_jax(arrays, cfg, dev)
            dparams = specs.place(params, specs.params_shardings(
                mesh, SH.DEFAULT_RULES, cfg))
            model = T.build(params, cfg)
            with SH.use_mesh_rules(mesh):
                dmodel = T.build(dparams, cfg)
            res = {"steps": _mla_steps(mesh, model, dmodel, cfg, prompt, fed,
                                       TOL[dtype])}
            lg, pc = T.prefill(model, cfg, prompt, buf_len=BUF)
            res["layer_ckv_bytes"] = pc["attn"].ckv[0].numel() * \
                pc["attn"].ckv.element_size()
            if dtype == "float32":
                # each side's greedy tokens
                res["greedy"] = {}
                for side, m, mod, c in (("plain", None, model, pc),
                                        ("mesh", mesh, dmodel,
                                         _placed(pc, mesh))):
                    tok, got = lg.argmax(-1).to(torch.int32), []
                    with SH.use_mesh_rules(m):
                        for i in range(N_DECODE):
                            lgi, c = T.decode_step(mod, cfg, c, tok, S + i)
                            tok = SH.to_local(lgi).argmax(-1).to(torch.int32)
                            got.append(tok.tolist())
                    res["greedy"][side] = got
                out["f32"] = res
                continue
            res["placements"] = {k: [str(p) for p in t.placements]
                                 for k, t in _leaves(_placed(pc, mesh)).items()}
            # one step from a cache of twice the slots: the same collectives
            _, pc2 = T.prefill(model, cfg, prompt, buf_len=2 * BUF)
            seen = _collectives(set())
            with SH.use_mesh_rules(mesh), seen:
                T.decode_step(dmodel, cfg, _placed(pc2, mesh), fed[0], S)
            res["collectives_2x"] = seen.ops
            out.update(res)
    return out


def _memory(mesh, dev, batch: int, slots: int) -> dict:
    """One MLA layer at DeepSeek-V2's full attention widths (d_model
    5,120, 128 heads, kv_lora 512, qk_rope 64) from seeded bfloat16
    weights, decoding ``N_DECODE`` steps from a latent cache of
    ``slots`` slots filled to ``slots - 2 * N_DECODE`` (seeded latents),
    on ``mesh`` (the cache placed by ``cache_shardings``) and plain:
    each step's output gap and whether it is within ``BF16_TOL``, the
    caches bit-identical, the mesh steps' all-gathers under
    ``CommDebugMode``, the largest ``max_memory_allocated`` above a mesh
    step's start (on the card) and one whole layer's ckv in bytes."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import sharding as SH
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.models import layers as L
    from repro_torch.models import mla as MLA
    from repro_torch.models.params import param_table

    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=1)
    dt = cfg.compute_dtype
    table = {k[len("layers/attn/"):]: v for k, v in param_table(cfg).items()
             if k.startswith("layers/attn/")}
    g = torch.Generator(dev).manual_seed(0)
    layer = {k: (torch.randn(info.shape[1:], generator=g, device=dev,
                             dtype=dt) * 0.02 if not k.endswith("norm")
                 else torch.ones(info.shape[1:], device=dev))
             for k, info in table.items()}
    placed = {k: specs.place(v, SH.NamedSharding(mesh, SH.logical_to_pspec(
        mesh, SH.DEFAULT_RULES, table[k].axes[1:], v.shape)))
        for k, v in layer.items()}
    fill = slots - 2 * N_DECODE
    cache = MLA.init_mla_cache(cfg, batch, slots, device=dev)
    cache.ckv[:, :fill] = torch.randn(cache.ckv[:, :fill].shape, generator=g,
                                      device=dev, dtype=dt)
    cache.krope[:, :fill] = torch.randn(cache.krope[:, :fill].shape,
                                        generator=g, device=dev, dtype=dt)
    cache.length = cache.pos = fill
    stacked = {"attn": MLA.MLACache(cache.ckv[None], cache.krope[None],
                                    fill, fill)}
    dcache = _placed(stacked, mesh)["attn"].layer(0)
    out = {"layer_ckv": cache.ckv.numel() * cache.ckv.element_size(),
           "placement": [str(p) for p in dcache.ckv.placements],
           "gaps": [], "inside_tol": True, "transient": 0}
    cuda = dev.type == "cuda"
    counts = {}
    with torch.no_grad():
        for i in range(N_DECODE):
            x = torch.randn((batch, 1, cfg.d_model), generator=g, device=dev,
                            dtype=dt)
            pos = torch.tensor([fill + i], device=dev)
            angles = L.rope_angles(pos, cfg, cfg.qk_rope_dim, cfg.qk_rope_dim)
            want, cache = MLA.mla_block(layer, cfg, x, positions=pos,
                                        cache=cache, angles=angles)
            with SH.use_mesh_rules(mesh):
                xm = SH.shard(x, ("act_batch", "act_seq", "act_embed"))
                dangles = tuple(SH.replicated(a, xm) for a in angles)
                if cuda:
                    torch.cuda.synchronize(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    start = torch.cuda.memory_allocated(dev)
                with CommDebugMode() as comm:
                    y, dcache = MLA.mla_block(placed, cfg, xm, positions=pos,
                                              cache=dcache, angles=dangles)
                    y = SH.summed(y)
                if cuda:
                    torch.cuda.synchronize(dev)
                    out["transient"] = max(
                        out["transient"],
                        torch.cuda.max_memory_allocated(dev) - start)
            for k, n in comm.get_comm_counts().items():
                counts[str(k)] = counts.get(str(k), 0) + n
            y, want = SH.to_local(y).float(), want.float()
            out["gaps"].append(float((y - want).abs().max()))
            out["inside_tol"] &= bool((y - want).abs().le(
                BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs()).all())
        out["caches_equal"] = [
            bool(torch.equal(dcache.ckv.full_tensor(), cache.ckv)),
            bool(torch.equal(dcache.krope.full_tensor(), cache.krope))]
    out["collectives"] = counts
    return out


def _ssm_case(mesh, dev) -> dict:
    """mamba2-130m's smoke decode on ``mesh`` from its own seeded
    weights beside the plain port."""
    from repro_torch import sharding as SH
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = smoke(SSM_ARCH)
    params = init_params(torch.Generator().manual_seed(0), cfg, dev)
    dparams = specs.place(params, specs.params_shardings(
        mesh, SH.DEFAULT_RULES, cfg))
    prompt, fed = (torch.from_numpy(a).to(dev) for a in tokens(cfg))
    steps = []
    with torch.no_grad():
        model = T.build(params, cfg)
        with SH.use_mesh_rules(mesh):
            dmodel = T.build(dparams, cfg)
        _, pc = T.prefill(model, cfg, prompt)
        dc = _placed(pc, mesh)
        for i in range(N_DECODE):
            ins = _leaves(dc)
            values = []
            seen = _collectives(_storages(dc))
            SH.FALLBACKS.clear()
            with SH.use_mesh_rules(mesh), seen, Calls(
                    SH, "assign", lambda buf, key, value: values.append(
                        value)):
                ml, dc = T.decode_step(dmodel, cfg, dc, fed[i], S + i)
            fallbacks = dict(SH.FALLBACKS)
            pl, pc = T.decode_step(model, cfg, pc, fed[i], S + i)
            got, plain = _leaves(dc), _leaves(pc)
            # the layers' writes in order, conv then state, gathered only
            # now, outside the step
            values = [_whole(v) for v in values]
            want = {"ssm/conv": values[0::2], "ssm/state": values[1::2]}
            steps.append({
                "same_objects": all(got[k] is ins[k] for k in got),
                "written": {k: all(torch.equal(_whole(t)[n], v.to(t.dtype))
                                   for n, v in enumerate(want[k]))
                            and len(want[k]) == cfg.n_layers
                            for k, t in got.items()},
                "layer0": {k: bool(torch.equal(_whole(t)[0], plain[k][0]))
                           for k, t in got.items()},
                "fallbacks": fallbacks, "collectives": seen.ops,
                "conv_bytes": plain["ssm/conv"][0].numel()
                * plain["ssm/conv"].element_size(),
                "logits": SH.to_local(ml).float().cpu().numpy().tolist(),
                "plain_logits": pl.float().cpu().numpy().tolist()})
    return {"steps": steps, "placements": {
        k: [str(p) for p in t.placements] for k, t in _leaves(dc).items()}}


def _worker(argv: list) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from test_torch_model_mesh_ranks import _setup

    args = json.loads(argv[0])
    dev = _setup(args.get("backend", "gloo"), args["rank"], 4, args["port"])
    mesh = make_local_mesh(*args["mesh"])
    res = {}
    if "memory" in args:
        res["memory"] = _memory(mesh, dev, *args["memory"])
    if "npz" in args:
        res["mla"] = _mla_case(mesh, dev, args["npz"])
    if args.get("ssm"):
        res["ssm"] = _ssm_case(mesh, dev)
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
            args, rank=r, port=port, out=out, mesh=mesh))],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]


def result(procs: list, out: str) -> dict:
    """Rank 0's output once every process of ``procs`` has exited 0."""
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    with open(out) as f:
        return json.load(f)


def jax_case(path: str) -> dict:
    """The JAX package's weights of DeepSeek-V2's smoke config in
    ``path`` (float32 masters), and by compute dtype the JAX
    ``decode_step``'s logits on ``tokens`` after its prefill into a
    buffer of ``BUF`` slots."""
    import jax
    import jax.numpy as jnp
    from repro.models import params as JP
    from repro.models import transformer as JT

    params = JP.init_params(jax.random.PRNGKey(3), smoke(MLA_ARCH, "repro"))
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = smoke(MLA_ARCH, "repro", dtype=dtype)
        prompt, fed = tokens(cfg)
        _, caches = jax.jit(lambda p, t: JT.prefill(p, cfg, t, buf_len=BUF))(
            params, jnp.asarray(prompt))
        step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, cfg, c, t, pos))
        out[dtype] = []
        for i in range(N_DECODE):
            lg, caches = step(params, caches, jnp.asarray(fed[i]),
                              jnp.asarray(S + i, jnp.int32))
            out[dtype].append(np.asarray(lg, np.float32))
    return out


def port_case(path: str) -> None:
    """The port's own weights of DeepSeek-V2's smoke config (a seeded
    generator) in ``path``: the inputs where JAX is not installed."""
    from repro_torch.models.params import init_params

    params = init_params(torch.Generator().manual_seed(3), smoke(MLA_ARCH),
                         "cpu")
    np.savez(path, **{k: v.numpy() for k, v in params.items()})


_DRY = """
    import json
    from repro_torch.launch import dryrun

    dryrun.init_fake_group(512)
    out = {{}}
    for arch in {archs!r}:
        rec = dryrun.run_cell(arch, "decode_32k", quiet=True)
        out[arch] = {{"status": rec["status"], **rec["bytes_per_device"],
                     **rec["collectives"],
                     "gathers": rec["replicated_fallback"]["gathers"]}}
    print(json.dumps(out), flush=True)
"""


def card_cases(tmp, backend: str) -> dict:
    """The (1, 4) and (2, 2) jobs on ``backend`` from the port's weights,
    and on (1, 4) the full-width layer of ``CARD_MEMORY`` (the four-card
    ``gpu`` case): rank 0's results by mesh."""
    npz = str(tmp / "deepseek.npz")
    port_case(npz)
    jobs = {m: ranks(str(tmp / f"{m}.json"), mesh, backend=backend, npz=npz,
                     ssm=m == "1x4",
                     **({"memory": list(CARD_MEMORY)} if m == "1x4" else {}))
            for m, mesh in MESHES.items()}
    return {m: result(p, str(tmp / f"{m}.json")) for m, p in jobs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two four-rank jobs and the dry run, side by side; the JAX
    decode in this process meanwhile."""
    d = tmp_path_factory.mktemp("mla_mesh")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    dry = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_DRY.format(
            archs=list(GATHER_BOUND)))],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    npz = str(d / "deepseek.npz")
    ref = jax_case(npz)
    jobs = {m: ranks(str(d / f"{m}.json"), mesh, npz=npz, ssm=m == "1x4")
            for m, mesh in MESHES.items()}
    out = {"ref": ref}
    for m, procs in jobs.items():
        out[m] = result(procs, str(d / f"{m}.json"))
    stdout, stderr = dry.communicate(timeout=600)
    assert dry.returncode == 0, stderr[-4000:]
    out["dry"] = json.loads(stdout.strip().splitlines()[-1])
    return out


def held(steps: list) -> int:
    """The leading steps whose MoE routes agree with the plain port's (at
    that step and every one before): in bfloat16 the two sides part at
    a near-tie route, after which the caches hold other latents."""
    n = 0
    while n < len(steps) and steps[n]["routes_agree"]:
        n += 1
    return n


def check_writes(res: dict) -> None:
    """The latents seq-sharded over the model axis, written in place:
    each step's buffers the objects that went in, bit-identical to the
    plain port's write of the step's rows, layer 0 bit-identical to the
    plain decode's, and, while the routes agree, the whole within the
    dtype's tolerance; two owner writes and one shard-local attention a
    layer.  Float32's routes agree at every step."""
    cfg = smoke(MLA_ARCH)
    for k, pl in res["placements"].items():
        assert pl[1] == "S(2)", (k, pl)
    assert held(res["f32"]["steps"]) == N_DECODE
    for steps in (res["steps"], res["f32"]["steps"]):
        assert len(steps) == N_DECODE and held(steps) >= 1
        for i, step in enumerate(steps):
            assert step["same_objects"], i
            assert all(step["written"].values()), (i, step["written"])
            assert all(step["layer0"].values()), (i, step["layer0"])
            assert i >= held(steps) or all(step["within"].values()), \
                (i, step["cache_gap"])
            assert step["writes"] == 2 * cfg.n_layers, (i, step["writes"])
            assert step["absorbed"] == cfg.n_layers, (i, step["absorbed"])


def check_logits(res: dict, ref=None) -> None:
    """Each step's logits, while the routes agree, within the dtype's
    tolerance of the plain port's (and of the JAX decode's where
    given); the float32 greedy tokens identical."""
    for dtype, steps in (("bfloat16", res["steps"]),
                         ("float32", res["f32"]["steps"])):
        for i, step in enumerate(steps[:held(steps)]):
            got = np.asarray(step["logits"])
            np.testing.assert_allclose(got, np.asarray(step["plain_logits"]),
                                       **TOL[dtype],
                                       err_msg=f"{dtype} step {i}")
            if ref is not None:
                np.testing.assert_allclose(got, ref[dtype][i], **TOL[dtype],
                                           err_msg=f"{dtype} step {i}, JAX")
    greedy = res["f32"]["greedy"]
    assert greedy["mesh"] == greedy["plain"], greedy


def check_no_cache_gather(res: dict, model_only: bool) -> None:
    """No ``assign`` or ``einsum`` fallback, no collective reads a
    cache's storage, no all-reduce of one layer's ckv buffer's bytes,
    the collectives of a step the same at twice the slots
    (``collectives_2x``); with ``model_only`` (a (1, 4) mesh) no
    all-gather at all."""
    for r in (res, res["f32"]):
        for i, step in enumerate(r["steps"]):
            assert not {"assign", "einsum"} & set(step["fallbacks"]), \
                (i, step["fallbacks"])
            ops = step["collectives"]
            assert ops and not any(c for _, _, c in ops), (i, ops)
            if model_only:
                assert not any(k == "all-gather" for k, _, _ in ops), (i, ops)
            assert not any(k == "all-reduce" and n >= r["layer_ckv_bytes"]
                           for k, n, _ in ops), (i, ops, r["layer_ckv_bytes"])
    first = sorted((k, n) for k, n, _ in res["steps"][0]["collectives"])
    assert sorted((k, n) for k, n, _ in res["collectives_2x"]) == first


def check_ssm(res: dict) -> None:
    """The conv and state written in place, bit-identical to the values
    written and layer 0 to the plain decode's; logits within
    ``BF16_TOL``; no ``assign`` fallback, no collective reads a cache,
    no all-gather of a layer's conv buffer's bytes."""
    for k, pl in res["placements"].items():
        assert "S(" in pl[1], (k, pl)            # heads / channels split
    for i, step in enumerate(res["steps"]):
        assert step["same_objects"], i
        assert all(step["written"].values()), (i, step["written"])
        assert all(step["layer0"].values()), (i, step["layer0"])
        assert "assign" not in step["fallbacks"], (i, step["fallbacks"])
        ops = step["collectives"]
        assert not any(r for _, _, r in ops), (i, ops)
        assert not any(k == "all-gather" and n >= step["conv_bytes"]
                       for k, n, _ in ops), (i, ops)
        np.testing.assert_allclose(np.asarray(step["logits"]),
                                   np.asarray(step["plain_logits"]),
                                   **BF16_TOL, err_msg=f"step {i}")


def check_memory(res: dict) -> None:
    """The full-width layer on (1, 4): the latents seq-sharded, each
    step's output within ``BF16_TOL`` of the plain layer's, the caches
    bit-identical, no all-gather, and (on the card) the largest
    transient of a step below one whole layer's ckv."""
    assert res["placement"][1] == "S(1)", res["placement"]
    assert res["inside_tol"], res["gaps"]
    assert res["caches_equal"] == [True, True], res["caches_equal"]
    assert not any("all_gather" in k for k in res["collectives"]), \
        res["collectives"]
    assert 0 < res["transient"] < res["layer_ckv"], res


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mla_mesh_decode_writes_the_latents_on_their_shards(runs, mesh):
    check_writes(runs[mesh]["mla"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mla_mesh_decode_matches_plain_and_jax(runs, mesh):
    check_logits(runs[mesh]["mla"], runs["ref"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mla_mesh_decode_gathers_no_cache(runs, mesh):
    check_no_cache_gather(runs[mesh]["mla"], model_only=mesh == "1x4")


def test_ssm_mesh_decode_writes_the_caches_as_placed(runs):
    check_ssm(runs["1x4"]["ssm"])


@pytest.mark.parametrize("arch", list(GATHER_BOUND))
def test_dryrun_decode_gathers_no_cache(runs, arch):
    """all-gather (and deepseek-v2's collectives in all) within the
    reference's bytes; argument bytes the record's, peak at most
    ``DRY_SLACK`` of it, deepseek-v2's temp within ``TEMP_BOUND``; no
    ``assign`` or ``einsum`` gather."""
    rec = runs["dry"][arch]
    assert rec["status"] == "ok", rec
    argument, peak = DRY_RECORD[arch]
    assert rec["argument"] == argument, rec
    assert rec["peak"] <= DRY_SLACK * peak, (rec["peak"], peak)
    assert rec["temp"] <= TEMP_BOUND.get(arch, float("inf")), rec["temp"]
    assert rec["all-gather"] <= GATHER_BOUND[arch], rec["all-gather"]
    total = sum(rec[k] for k in ("all-gather", "all-reduce",
                                 "reduce-scatter", "all-to-all",
                                 "collective-permute"))
    assert total <= COLLECTIVE_BOUND.get(arch, float("inf")), total
    assert not {"assign", "einsum"} & set(rec["gathers"]), rec["gathers"]


if __name__ == "__main__":
    _worker(sys.argv[1:])
