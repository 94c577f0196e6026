"""The heads on their shards, the embedding on the batch shards and
decode over the sharded cache, on the CPU.

- Four ranks on a (1, 4) (data, model) mesh, gloo groups in
  subprocesses (this file run as a script), four smoke configs whose
  heads the model axis splits in each way ``attention.attn_heads`` and
  ``ssm.ssm_heads`` handle: qwen1.5-110b's (8 q heads over 2 KV: the
  heads divide the axis, the KV groups do not), whisper-large-v3's with
  6 q and 6 KV heads, mamba2-130m's with 6 SSM heads and hymba-1.5b's
  with 6 q, 3 KV and 6 SSM heads (4 divides none: ranks 0-2 take two
  heads, rank 3 none, as ``torch.chunk`` splits them).  The forward's
  logits within ``BF16_TOL`` of the plain port and of the JAX forward on
  the same weights; one train step within
  ``test_torch_model_mesh_ranks``' four-rank tolerances;
  the same step in float32 within 1e-5 (loss, grad norm) and 1e-4 (a
  moment leaf); the mesh prefill's caches (attention's K/V, the SSM
  conv tail and state, the cross K/V) within ``BF16_TOL`` of the plain
  prefill's, and decode from them: each step's logits within
  ``BF16_TOL`` on the plain port's tokens, and in float32 the greedy
  tokens identical to the plain port's;
  ``sharding.FALLBACKS`` records no ``reshape`` gather; a
  ``TorchDispatchMode`` over the mesh runs sees no local attention score
  chunk (or SSD chunk state) with more than ceil(H / 4) heads, and does
  see ones with ceil(H / 4).
- The vocab-parallel lookup (``transformer.embed_lookup``) on a (2, 2)
  mesh: output and the table's gradient equal the plain lookup's bit for
  bit (V = 64, which the model axis splits, and V = 63, which the rules
  replicate) at a batch of more tokens than a rank's table rows and at a
  decode-sized one (the two placements it picks between), and at the
  former no local tensor has the shape [global B, S, D];
  ``embed_input`` with a prefix (pixtral's smoke) and learned positions
  (granite's) equal to the plain one.
- Qwen's smoke decode on (1, 4) from a cache placed by
  ``launch.specs.cache_shardings`` (seq over the model axis): greedy
  tokens identical to the plain port's, no ``einsum`` gather, no local
  tensor larger than a position vector with the cache's global seq
  extent; the mesh prefill's new K/V leave placed as the cache.
- The dry run on a fake 512-rank group (one subprocess): pixtral-12b
  and whisper-large-v3 at ``prefill_32k``, mamba2-130m at
  ``prefill_32k`` and qwen1.5-0.5b at ``decode_32k``, full widths, depth
  cut to 2: no ``reshape`` or ``einsum`` in ``replicated_fallback.
  gathers``, argument bytes those of the record before the repair
  (``DRY_RECORD``), a prefill's caches placed as ``cache_shardings``
  places them, and the decode's output bytes the record's.
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

#: (arch, overrides of its smoke config): the heads each way the model
#: axis of 4 splits them
CONFIGS = {
    "qwen1_5_110b": {},
    "whisper_large_v3": {"n_heads": 6, "n_kv_heads": 6},
    "mamba2_130m": {"ssm_heads": 6, "ssm_expand": 3},
    "hymba_1_5b": {"n_heads": 6, "n_kv_heads": 3, "ssm_heads": 6,
                   "ssm_expand": 3},
}
MODEL = 4
B, S = 4, 8
N_DECODE = 4
#: a moment's relative norm against the plain step's, a leaf: the dense
#: four-rank tolerance (``test_torch_model_mesh_ranks``), and for the SSM
#: families 0.1: the SSD's step bias and decay sum their gradients over
#: every position with cancellation, so the projections' bfloat16
#: rounding moves them most.  Readings on four gloo ranks, the largest
#: leaf: 0.0569 (mamba2-130m's v dt_bias) and 0.0372 (hymba-1.5b's v
#: a_log); with the gated norm's all-reduce given no backward sum,
#: 0.487 and 0.404; with its mean taken over a rank's channels, 1.27 and
#: 0.917
MOMENT_TOL = {"qwen1_5_110b": MOMENT_RTOL["qwen1_5_0_5b"],
              "whisper_large_v3": MOMENT_RTOL["qwen1_5_0_5b"],
              "mamba2_130m": 0.1, "hymba_1_5b": 0.1}
#: the same in float32 on both sides, every config: readings at most
#: 1.74e-6 a leaf, against 0.16 and above with either fault above
F32_MOMENT_RTOL = 1e-4
#: leaves whose gradient is zero in exact arithmetic: softmax does not
#: change when one bias shifts every key's score alike, so their moments
#: are rounding noise on both sides; outside the tolerance they are held
#: to a norm below ``NOISE_FRACTION`` of the largest moment of their
#: kind instead
ZERO_GRAD = ("attn/bk", "cross/bk")
NOISE_FRACTION = 1e-3
#: the same train step in float32 on both sides: loss and grad norm
F32_RTOL = 1e-5
#: the embedding case: tokens [EB, ES] into a table [V, ED] (more tokens
#: than a rank's table rows: the batch-shard lookup), and a decode-sized
#: batch [EB, 1] (the lookup on the table as placed)
EB, ES, ED = 4, 48, 16
EMBED_VOCABS = [64, 63]
#: the dry run's record before the repair (full widths, depth 2, 16 x
#: 16): argument and output bytes a device
DRY_RECORD = {
    ("pixtral_12b", "prefill_32k"): (35_096_576, 537_395_200),
    ("whisper_large_v3", "prefill_32k"): (25_359_104, 702_016_512),
    ("mamba2_130m", "prefill_32k"): (2_283_584, 3_389_952),
    ("qwen1_5_0_5b", "decode_32k"): (137_095_200, 136_648_704),
}


def smoke(arch: str, package: str = "repro_torch"):
    import dataclasses
    import importlib
    cfg = importlib.import_module(f"{package}.configs").get_smoke_config(arch)
    return dataclasses.replace(cfg, **CONFIGS.get(arch, {}))


def inputs(cfg) -> dict:
    """Seeded tokens (and enc-dec frames) as numpy."""
    rng = np.random.default_rng(4)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if cfg.is_encdec:
        out["enc_frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# the worker (this file run as a script, in its own process)
# ---------------------------------------------------------------------------

def _shapes_seen(min_dims: int = 1):
    """A dispatch mode recording the shape of every local tensor an op
    returns (DTensor ops are passed on to DTensor, which runs them as
    local ops seen here; the fake tensors of its shape propagation are
    not recorded)."""
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
                tuple(t.shape) for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.ndim >= min_dims
                and not isinstance(t, fake))
            return out
    return Seen()


def _load(cfg, npz: str, dev) -> dict:
    import torch
    from repro_torch.models.params import param_table
    with np.load(npz) as z:
        out = {}
        for path, info in param_table(cfg).items():
            t = torch.from_numpy(z[path].copy())
            out[path] = (t.view(torch.bfloat16) if info.dtype == "bfloat16"
                         else t).to(dev)
    return out


def _heads_case(arch: str, mesh, dev, npz: str) -> dict:
    """One config on the (1, 4) mesh beside the plain port: logits,
    train step figures, fallbacks and the 5-dim local shapes the mesh
    runs made."""
    import dataclasses

    import torch
    from repro_torch import sharding as SH
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import init_train_state, make_train_step
    from test_torch_model_mesh_ranks import (LR, WD, _gap, _moment_rel, _opt,
                                             _value)

    cfg = smoke(arch)
    rules = SH.DEFAULT_RULES
    params = _load(cfg, npz, dev)
    dparams = specs.place(params, specs.params_shardings(mesh, rules, cfg))
    data = inputs(cfg)
    tokens = torch.from_numpy(data["tokens"]).to(dev)
    kw = {}
    if cfg.is_encdec:
        kw["enc_frames"] = torch.from_numpy(data["enc_frames"]).to(
            dev, cfg.compute_dtype)
    seen = _shapes_seen(5)
    SH.FALLBACKS.clear()
    with torch.no_grad():
        plain, _ = T.forward_train(params, cfg, tokens, **kw)
        with SH.use_mesh_rules(mesh), seen:
            lg, _ = T.forward_train(dparams, cfg, tokens, **kw)
    out = {"logits": SH.to_local(lg).float().cpu().numpy().tolist(),
           "plain_logits": plain.float().cpu().numpy().tolist()}
    opt, clk = _opt(cfg), ClockConfig()
    st = init_train_state(torch.Generator().manual_seed(2), cfg, opt, clk,
                          dev)
    sh = specs.state_shardings(mesh, rules, cfg,
                               specs.abstract_state(cfg, opt, clk))
    dst = specs.place(st, sh)
    step = make_train_step(cfg, opt, clk)
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1), "ev_hi": 7,
             "ev_lo": 9, **kw}
    s1, m1 = step(st, batch)
    with SH.use_mesh_rules(mesh), seen:
        s2, m2 = step(dst, batch)
    out["fallbacks"] = dict(SH.FALLBACKS)
    out.update(_prefill_decode(cfg, params, dparams, mesh, tokens, kw))
    out["metrics"] = {k: [float(m2[k]), float(m1[k])]
                      for k in ("loss", "grad_norm", "clock_sum")}
    out["param_gap"] = max(_gap(s2.params[k], s1.params[k])
                           for k in s1.params)
    out["param_bound"] = max(
        2 * LR * (1 + WD * float(st.params[k].float().abs().max()))
        for k in st.params)
    out["moment_rel"] = _moment_rel(s2.opt, s1.opt)
    out["moment_norm"] = {
        f"{mom} {k}": [float(_value(s2.opt[mom][k]).norm()),
                       float(_value(s1.opt[mom][k]).norm())]
        for mom in ("m", "v") for k in s1.opt[mom]}
    out["shapes"] = [list(s) for s in seen.shapes]
    # the same step in float32: the two paths' arithmetic alike
    f32 = dataclasses.replace(cfg, dtype="float32")
    st = init_train_state(torch.Generator().manual_seed(2), f32, opt, clk,
                          dev)
    dst = specs.place(st, sh)
    if "enc_frames" in kw:
        batch["enc_frames"] = kw["enc_frames"].float()
    step = make_train_step(f32, opt, clk)
    s1, m1 = step(st, batch)
    with SH.use_mesh_rules(mesh):
        s2, m2 = step(dst, batch)
    out["f32"] = {k: [float(m2[k]), float(m1[k])]
                  for k in ("loss", "grad_norm")}
    out["f32_moment_rel"] = _moment_rel(s2.opt, s1.opt)
    out["f32_moment_norm"] = {
        f"{mom} {k}": [float(_value(s2.opt[mom][k]).norm()),
                       float(_value(s1.opt[mom][k]).norm())]
        for mom in ("m", "v") for k in s1.opt[mom]}
    return out


def _cache_leaves(caches: dict) -> dict:
    """{"attn/k": whole float32 numpy, ...} of every tensor leaf of a
    stacked prefill cache (attention's K/V, the SSM conv tail and state,
    the cross K/V), DTensors gathered."""
    import torch
    out = {}
    for k, c in caches.items():
        for f, t in vars(c).items():
            if isinstance(t, torch.Tensor):
                t = t.full_tensor() if hasattr(t, "full_tensor") else t
                out[f"{k}/{f}"] = t.float().cpu().numpy()
    return out


def _prefill_decode(cfg, params, dparams, mesh, tokens, kw) -> dict:
    """The prefill plain and on ``mesh`` and ``N_DECODE`` decode steps
    from each side's own cache: every cache leaf whole, both sides; each
    step's logits with both sides fed the plain port's greedy tokens;
    and, in float32 (where no near tie of the random weights' logits
    flips under bfloat16 rounding), each side's own greedy tokens; the
    ``FALLBACKS`` of the bfloat16 mesh prefill."""
    import dataclasses

    import torch
    from repro_torch import sharding as SH
    from repro_torch.models import transformer as T

    buf = S + N_DECODE
    out = {"cache": {}, "steps": {}, "greedy": {}}
    f32 = dataclasses.replace(cfg, dtype="float32")
    kw32 = {k: v.float() for k, v in kw.items()}
    with torch.no_grad():
        for c_, kw_ in ((cfg, kw), (f32, kw32)):
            fed = None
            for side, p, m in (("plain", params, None),
                               ("mesh", dparams, mesh)):
                with SH.use_mesh_rules(m):
                    SH.FALLBACKS.clear()
                    lg, c = T.prefill(p, c_, tokens, buf_len=buf, **kw_)
                    if c_ is cfg and m is not None:
                        out["prefill_fallbacks"] = dict(SH.FALLBACKS)
                    if c_ is cfg:
                        for name, a in _cache_leaves(c).items():
                            out["cache"].setdefault(name, {})[side] = \
                                a.tolist()
                    model = T.build(p, c_)
                    lgs, toks = [SH.to_local(lg).float()], []
                    for i in range(N_DECODE):
                        tok = lgs[-1].argmax(-1).to(torch.int32)
                        toks.append(tok.tolist())
                        if c_ is cfg and fed is not None:
                            tok = fed[i]
                        lg, c = T.decode_step(model, c_, c, tok, S + i)
                        lgs.append(SH.to_local(lg).float())
                    if c_ is cfg:
                        out["steps"][side] = [
                            x.cpu().numpy().tolist() for x in lgs]
                        fed = fed or [torch.tensor(t, dtype=torch.int32,
                                                   device=tokens.device)
                                      for t in toks]
                    else:
                        out["greedy"][side] = toks
    return out


def _embed_case(mesh, dev) -> dict:
    """``embed_lookup`` plain and on ``mesh`` (output, the table's
    gradient, the local shapes), and ``embed_input`` of two smoke
    configs."""
    import torch
    from repro_torch import sharding as SH
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    rules = SH.DEFAULT_RULES
    res = {}
    for V in EMBED_VOCABS:
        rng = np.random.default_rng(V)
        table = torch.from_numpy(
            rng.standard_normal((V, ED)).astype(np.float32)).to(
                dev, torch.bfloat16)
        spec = SH.logical_to_pspec(mesh, rules, ("vocab", "embed"), (V, ED))
        dtab = specs.place(table, SH.NamedSharding(mesh, spec))
        res[str(V)] = {"split": dtab.placements[1].is_shard()}
        for what, seq in (("batch", ES), ("decode", 1)):
            ids = torch.from_numpy(rng.integers(0, V, (EB, seq))).to(dev)
            # small integers: the table's gradient sums them exactly in
            # any order, so the shards' partial sums equal the plain one
            w = torch.from_numpy(rng.integers(-4, 5, (EB, seq, ED)).astype(
                np.float32)).to(dev, torch.bfloat16)
            seen = _shapes_seen()
            # the output's gradient, placed as the output (batch
            # shards), made before the mode looks
            gd = SH.redistribute(SH.replicated(w, dtab), SH.placements(
                mesh, SH.P("data", None, None)))
            for side, t, g in (("plain", table, w), ("mesh", dtab, gd)):
                t = t.detach().requires_grad_(True)
                with SH.use_mesh_rules(mesh if side == "mesh" else None), \
                        (seen if side == "mesh" else _shapes_seen()):
                    x = T.embed_lookup(t, ids)
                    x.backward(g)
                res[str(V)][f"{what} {side}"] = [
                    SH.to_local(x.detach()).float().cpu().numpy().tolist(),
                    SH.to_local(t.grad).float().cpu().numpy().tolist()]
            res[str(V)][f"{what} whole_seen"] = [EB, seq, ED] in [
                list(s) for s in seen.shapes]
    for arch in EMBED_ARCHS:
        cfg = get_smoke_config(arch)
        params = init_params(torch.Generator().manual_seed(0), cfg, dev)
        dparams = specs.place(params, specs.params_shardings(mesh, rules, cfg))
        toks = torch.randint(0, cfg.vocab, (EB, ES),
                             generator=torch.Generator().manual_seed(1))
        pfx = (torch.randn((EB, cfg.n_prefix, cfg.d_model),
                           generator=torch.Generator().manual_seed(2)).to(
                               dev, cfg.compute_dtype)
               if cfg.n_prefix else None)
        with torch.no_grad():
            a = T.build(params, cfg).embed_input(toks.to(dev), pfx)
            with SH.use_mesh_rules(mesh):
                b = T.build(dparams, cfg).embed_input(toks.to(dev), pfx)
        res[arch] = float((SH.to_local(b).float() - a.float()).abs().max())
    return res


def _decode_case(mesh, dev) -> dict:
    """Qwen's smoke prefill (plain), then greedy decode steps plain and
    from the cache placed by ``cache_shardings`` on ``mesh``; the mesh
    prefill's cache placements against the cache's."""
    import copy

    import torch
    from repro_torch import sharding as SH
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = get_smoke_config("qwen1_5_0_5b")
    rules = SH.DEFAULT_RULES
    params = init_params(torch.Generator().manual_seed(0), cfg, dev)
    dparams = specs.place(params, specs.params_shardings(mesh, rules, cfg))
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    buf = S + N_DECODE
    res = {}
    with torch.no_grad():
        lg, caches = T.prefill(params, cfg, tokens, buf_len=buf)
        sh = specs.cache_shardings(mesh, rules, caches)
        dcaches = specs.place(copy.deepcopy(caches), sh)
        res["cache_seq_sharded"] = [
            str(p) for p in dcaches["attn"].k.placements]
        toks = {}
        seen = _shapes_seen()
        SH.FALLBACKS.clear()
        for side, p, c, m in (("plain", params, caches, None),
                              ("mesh", dparams, dcaches, mesh)):
            tok = lg.argmax(-1).to(torch.int32)
            out = [tok.tolist()]
            with SH.use_mesh_rules(m), (seen if m is not None
                                        else _shapes_seen()):
                model = T.build(p, cfg)
                for i in range(N_DECODE):
                    lgi, c = T.decode_step(model, cfg, c, tok, S + i)
                    tok = SH.to_local(lgi).argmax(-1).to(torch.int32)
                    out.append(tok.tolist())
            toks[side] = out
        res["fallbacks"] = dict(SH.FALLBACKS)
        res["tokens"] = toks
        res["whole_seq"] = [list(s) for s in seen.shapes
                            if buf in s and math.prod(s) > buf]
        # the mesh prefill (no padding past the prompt): its new K/V
        # placed as the cache
        with SH.use_mesh_rules(mesh):
            _, mc = T.prefill(dparams, cfg, tokens, buf_len=S)
        want = specs.cache_shardings(mesh, rules, mc)
        res["prefill_placed"] = [
            [str(p) for p in getattr(mc["attn"], f).placements]
            == [str(p) for p in getattr(want["attn"], f).placements]
            for f in ("k", "v")]
    return res


def _worker(argv: list) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from test_torch_model_mesh_ranks import _setup

    args = json.loads(argv[0])
    dev = _setup(args.get("backend", "gloo"), args["rank"], args["world"],
                 args["port"])
    mesh = make_local_mesh(*args["mesh"])
    mode = args["mode"]
    if mode == "heads":
        res = {a: _heads_case(a, mesh, dev, args["npz"][a])
               for a in args["archs"]}
    elif mode == "embed":
        res = _embed_case(mesh, dev)
    else:
        res = _decode_case(mesh, dev)
    if args["rank"] == 0:
        with open(args["out"], "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def ranks(out: str, world: int, mesh: list, **args) -> list:
    """This file's worker in ``world`` processes (rank 0 writes
    ``out``), started at once."""
    from test_torch_model_mesh_ranks import free_port

    port = free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, __file__, json.dumps(dict(
            args, rank=r, world=world, port=port, out=out, mesh=mesh))],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]


def result(procs: list, out: str) -> dict:
    """Rank 0's output once every process of ``procs`` has exited 0."""
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    with open(out) as f:
        return json.load(f)


def jax_weights(arch: str, path: str) -> np.ndarray:
    """The JAX package's weights of ``smoke(arch)`` in ``path`` (bfloat16
    leaves as their 16 bits), and the JAX forward's logits of
    ``inputs``."""
    import jax
    import jax.numpy as jnp
    from repro.models import params as JP
    from repro.models import transformer as JT

    cfg = smoke(arch, "repro")
    params = JP.init_params(jax.random.PRNGKey(3), cfg)
    arrs = {}
    for k, v in params.items():
        a = np.asarray(v)
        arrs[k] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    np.savez(path, **arrs)
    data = inputs(cfg)
    kw = {}
    if cfg.is_encdec:
        kw["enc_frames"] = jnp.asarray(data["enc_frames"]).astype(
            cfg.compute_dtype)
    logits, _ = JT.forward_train(params, cfg, jnp.asarray(data["tokens"]),
                                 **kw)
    return np.asarray(logits, np.float32)


_DRY = """
    import dataclasses, json
    from repro_torch import sharding as SH
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, specs

    dryrun.init_fake_group(512)
    seen = []
    local_bytes = dryrun._local_bytes

    def keep(tree):
        seen.append(tree)
        return local_bytes(tree)

    dryrun._local_bytes = keep
    out = {{}}
    for arch, shape in {cells!r}:
        cfg = get_config(arch)
        cut = {{"n_layers": 2}}
        if cfg.is_encdec:
            cut["n_enc_layers"] = 2
        seen.clear()
        rec = dryrun.run_cell(arch, shape, quiet=True,
                              cfg_override=dataclasses.replace(cfg, **cut))
        placed = None
        if rec["kind"] == "prefill":
            caches = seen[-1][1]
            mesh = next(v for c in caches.values() for v in vars(c).values()
                        if hasattr(v, "device_mesh")).device_mesh
            want = specs.cache_shardings(mesh, SH.DEFAULT_RULES, caches)
            placed = {{f"{{k}}/{{f}}": [str(p) for p in getattr(c, f).placements]
                       == [str(p) for p in getattr(want[k], f).placements]
                       for k, c in caches.items()
                       for f in vars(c) if hasattr(getattr(c, f), "placements")}}
        out[f"{{arch}}:{{shape}}"] = {{
            "status": rec["status"],
            "argument": rec["bytes_per_device"]["argument"],
            "output": rec["bytes_per_device"]["output"],
            "gathers": rec["replicated_fallback"]["gathers"],
            "placed": placed}}
    print(json.dumps(out), flush=True)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four-rank heads job, the embedding and decode jobs and the
    dry run, side by side; the JAX forwards in this process
    meanwhile."""
    d = tmp_path_factory.mktemp("head_views")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    dry = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_DRY.format(
            cells=list(DRY_RECORD)))],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    procs = {"embed": ranks(str(d / "embed.json"), 4, [2, 2], mode="embed"),
             "decode": ranks(str(d / "decode.json"), 4, [1, MODEL],
                             mode="decode")}
    npz, ref = {}, {}
    for arch in CONFIGS:
        npz[arch] = str(d / f"{arch}.npz")
        ref[arch] = jax_weights(arch, npz[arch])
    procs["heads"] = ranks(str(d / "heads.json"), 4, [1, MODEL],
                           mode="heads", archs=list(CONFIGS), npz=npz)
    out = {"ref": ref}
    for side, ps in procs.items():
        out[side] = result(ps, str(d / f"{side}.json"))
    stdout, stderr = dry.communicate(timeout=600)
    assert dry.returncode == 0, stderr[-4000:]
    out["dry"] = json.loads(stdout.strip().splitlines()[-1])
    return out


def check_forward(res: dict) -> None:
    np.testing.assert_allclose(np.asarray(res["logits"]),
                               np.asarray(res["plain_logits"]), **BF16_TOL)


def check_moments(rels: dict, norms: dict, tol: float) -> None:
    """Each moment leaf's relative norm within ``tol``, or, for a
    zero-gradient leaf, a norm below ``NOISE_FRACTION`` of its kind's
    largest."""
    for k, rel in rels.items():
        top = max(max(v) for n, v in norms.items() if n[0] == k[0])
        noise = (k.endswith(ZERO_GRAD)
                 and max(norms[k]) <= NOISE_FRACTION * top)
        assert rel <= tol or noise, (k, rel, norms[k], top)


def check_train(arch: str, res: dict) -> None:
    """The train step on the mesh against the plain one: the four-rank
    tolerances, the zero-gradient leaves held as noise, and the float32
    step's loss and grad norm within ``F32_RTOL``, its moments within
    ``F32_MOMENT_RTOL``."""
    for k, (mesh, plain) in res["metrics"].items():
        assert abs(mesh - plain) <= LOSS_RTOL * abs(plain), (k, mesh, plain)
    assert res["param_gap"] <= res["param_bound"], res["param_gap"]
    check_moments(res["moment_rel"], res["moment_norm"], MOMENT_TOL[arch])
    for k, (mesh, plain) in res["f32"].items():
        assert abs(mesh - plain) <= F32_RTOL * abs(plain), (k, mesh, plain)
    check_moments(res["f32_moment_rel"], res["f32_moment_norm"],
                  F32_MOMENT_RTOL)


def check_prefill_cache(arch: str, res: dict) -> None:
    """Every leaf of the mesh prefill's cache within ``BF16_TOL`` of the
    plain prefill's: attention's K/V, the SSM conv tail and state, the
    cross K/V, each that the config has."""
    cfg = smoke(arch)
    want = set()
    if cfg.attends:
        want |= {"attn/k", "attn/v"}
    if cfg.ssm_heads:
        want |= {"ssm/conv", "ssm/state"}
    if cfg.is_encdec:
        want |= {"cross/k", "cross/v"}
    assert set(res["cache"]) == want, sorted(res["cache"])
    for name, sides in res["cache"].items():
        np.testing.assert_allclose(np.asarray(sides["mesh"]),
                                   np.asarray(sides["plain"]), **BF16_TOL,
                                   err_msg=name)


def check_decode_from_prefill(res: dict) -> None:
    """Decode from the mesh prefill's cache: each step's logits within
    ``BF16_TOL`` of the plain port's on the same tokens, and the float32
    greedy tokens identical."""
    for i, (mesh, plain) in enumerate(zip(res["steps"]["mesh"],
                                          res["steps"]["plain"])):
        np.testing.assert_allclose(np.asarray(mesh), np.asarray(plain),
                                   **BF16_TOL, err_msg=f"step {i}")
    assert len(res["steps"]["mesh"]) == N_DECODE + 1
    assert res["greedy"]["mesh"] == res["greedy"]["plain"]


def check_heads(arch: str, res: dict) -> None:
    """No ``reshape`` gather (the forward, the train step, the
    prefill), and no local attention score chunk [B, Sq,
    KV, G, chunk] (or SSD chunk state [B, nc, H, P, N]) with more than
    ceil(H / 4) heads; the split's largest is there."""
    assert "reshape" not in res["fallbacks"], res["fallbacks"]
    assert "reshape" not in res["prefill_fallbacks"], \
        res["prefill_fallbacks"]
    cfg = smoke(arch)
    shapes = [tuple(s) for s in res["shapes"]]
    if cfg.attends:
        chunk = min(cfg.attn_chunk, S)
        heads = [s[2] * s[3] for s in shapes if s[1] == S and s[4] == chunk]
        assert heads and max(heads) == -(-cfg.n_heads // MODEL), heads
    if cfg.ssm_heads:
        heads = [s[2] for s in shapes
                 if s[3:] == (cfg.ssm_head_dim, cfg.ssm_state)]
        assert heads and max(heads) == -(-cfg.ssm_heads // MODEL), heads


EMBED_ARCHS = ["pixtral_12b", "granite_20b"]


def check_lookup(res: dict, V: int) -> None:
    """The lookup and the table's gradient bit for bit at both batch
    sizes, no whole [B, S, D] on a rank at the batch's; the vocab split
    where the model axis divides it."""
    r = res[str(V)]
    assert r["split"] == (V % 2 == 0), V
    for what in ("batch", "decode"):
        for i in range(2):              # output, the table's gradient
            np.testing.assert_array_equal(np.asarray(r[f"{what} mesh"][i]),
                                          np.asarray(r[f"{what} plain"][i]))
    assert not r["batch whole_seen"], V


def check_decode(res: dict) -> None:
    # [L, B, S_buf, KV, Dh]: the seq over the model axis
    assert res["cache_seq_sharded"] == ["R", "S(2)"]
    assert res["tokens"]["mesh"] == res["tokens"]["plain"]
    assert "einsum" not in res["fallbacks"], res["fallbacks"]
    assert res["whole_seq"] == [], res["whole_seq"][:5]


def port_weights(arch: str, path: str) -> None:
    """The port's own weights of ``smoke(arch)`` (a seeded generator) in
    ``path``, as ``_load`` reads them: the inputs where JAX is not
    installed."""
    import torch
    from repro_torch.models.params import init_params

    params = init_params(torch.Generator().manual_seed(3), smoke(arch), "cpu")
    np.savez(path, **{k: (v.view(torch.int16).numpy().view(np.uint16)
                          if v.dtype == torch.bfloat16 else v.numpy())
                      for k, v in params.items()})


def card_cases(tmp, backend: str) -> dict:
    """The heads, embedding and decode jobs on ``backend`` from the
    port's weights (the four-card ``gpu`` case): rank 0's results."""
    npz = {a: str(tmp / f"{a}.npz") for a in CONFIGS}
    for a, p in npz.items():
        port_weights(a, p)
    jobs = {"heads": ranks(str(tmp / "heads.json"), 4, [1, MODEL],
                           backend=backend, mode="heads",
                           archs=list(CONFIGS), npz=npz),
            "embed": ranks(str(tmp / "embed.json"), 4, [2, 2],
                           backend=backend, mode="embed"),
            "decode": ranks(str(tmp / "decode.json"), 4, [1, MODEL],
                            backend=backend, mode="decode")}
    return {k: result(p, str(tmp / f"{k}.json")) for k, p in jobs.items()}


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_four_rank_head_views_forward_matches_plain_and_jax(runs, arch):
    res = runs["heads"][arch]
    check_forward(res)
    np.testing.assert_allclose(np.asarray(res["logits"]), runs["ref"][arch],
                               **BF16_TOL)


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_four_rank_head_views_train_step_within_tolerance(runs, arch):
    check_train(arch, runs["heads"][arch])


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_four_rank_mesh_prefill_caches_match_plain(runs, arch):
    check_prefill_cache(arch, runs["heads"][arch])


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_four_rank_decode_from_mesh_prefill_matches_plain(runs, arch):
    check_decode_from_prefill(runs["heads"][arch])


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_four_rank_head_views_gather_no_heads(runs, arch):
    check_heads(arch, runs["heads"][arch])


@pytest.mark.parametrize("V", EMBED_VOCABS)
def test_embed_lookup_on_batch_shards_equals_plain(runs, V):
    check_lookup(runs["embed"], V)


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_embed_input_prefix_and_positions_on_the_mesh(runs, arch):
    assert runs["embed"][arch] == 0.0


def test_decode_contracts_over_the_sharded_cache(runs):
    check_decode(runs["decode"])


def test_prefill_kv_leave_placed_as_the_cache(runs):
    assert runs["decode"]["prefill_placed"] == [True, True]


@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s in DRY_RECORD])
def test_dryrun_head_views_gather_nothing(runs, cell):
    rec = runs["dry"][cell]
    assert rec["status"] == "ok"
    assert not {"reshape", "einsum"} & set(rec["gathers"]), rec["gathers"]
    argument, output = DRY_RECORD[tuple(cell.split(":"))]
    assert rec["argument"] == argument
    if rec["placed"] is None:                  # decode: the cache as given
        assert rec["output"] == output
    else:
        assert rec["placed"] and all(rec["placed"].values()), rec["placed"]
        assert rec["output"] <= output


if __name__ == "__main__":
    _worker(sys.argv[1:])
