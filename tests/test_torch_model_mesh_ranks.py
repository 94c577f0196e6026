"""The model mesh on real ranks, on the CPU: DTensor parameters on gloo
process groups against the plain port (and, on four ranks, the JAX
forward).

- One rank, a (1, 1) mesh, the ten smoke configs: prefill logits, four
  greedy decode steps and one train step (loss, grad norm, clock cells,
  every param and moment) bit-identical to the plain port, greedy
  tokens identical.  ``REWRITTEN`` names the ops DTensor rewrites so
  that their values differ; it is empty: on one rank every DTensor op
  runs the plain op on the whole tensor.
- Four ranks, a 2x2 (data, model) mesh, one dense and one MoE smoke
  config, in spawned processes: the forward's logits within the port's
  bfloat16 tolerance (``BF16_TOL``, ``tests/test_torch_models.py``) of
  the plain port and of the JAX forward on the same weights; one train
  step's loss and grad norm within 2e-2 relative, its params within the
  most two AdamW steps can part (2 lr (1 + wd |p|)), and its moments
  (dequantized) within ``MOMENT_RTOL`` a leaf as a relative norm: the
  shards sum their products in other orders.  ``adamw_update`` alone,
  two steps on the same seeded gradients with float32 and with int8
  moments whose leaves, codes and scales are sharded: every param's
  change and every moment within ``ADAMW_RTOL`` of the plain update's
  (only the global norm's sum order differs).  The dense run also
  restores a saved state onto the mesh (``restore(shardings=)``), saves
  the DTensor state and restores it plain: the round trip gives back
  the state.

Every group is set up in a subprocess (this file run as a script), so
that no two cases share a default group; the subprocesses start side by
side when the file's first case asks for them.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src")
ARCHS = ["stablelm_1_6b", "qwen1_5_0_5b", "qwen1_5_110b", "granite_20b",
         "whisper_large_v3", "mamba2_130m", "deepseek_v2_236b",
         "grok_1_314b", "pixtral_12b", "hymba_1_5b"]
#: the one-rank runs, a subprocess a group of configs
ONE_RANK_GROUPS = [ARCHS[:4], ARCHS[4:7], ARCHS[7:]]
FOUR_RANK_ARCHS = ["qwen1_5_0_5b", "grok_1_314b"]
#: ops that DTensor rewrites on one rank so that values differ (none)
REWRITTEN: dict = {}
BF16_TOL = dict(rtol=2e-2, atol=6.25e-2)
LOSS_RTOL = 2e-2
#: a moment's relative norm against the plain step's, a leaf: from zero,
#: m = 0.1 g and v = 0.05 g^2, so m's gap is the gradient's and v's about
#: twice it (the dense config: twice the bfloat16 rtol; the MoE config:
#: tokens at near-tie routes take other experts)
MOMENT_RTOL = {"qwen1_5_0_5b": 2 * BF16_TOL["rtol"], "grok_1_314b": 0.2}
#: ``adamw_update`` on the mesh against the plain one on the same
#: gradients, a relative norm a leaf (params' change, moments)
ADAMW_RTOL = 1e-3
B, S, N_DECODE = 2, 8, 4
LR, WD = 3e-4, 0.1


# ---------------------------------------------------------------------------
# the worker (this file run as a script, in its own process)
# ---------------------------------------------------------------------------

def _setup(backend: str, rank: int, world: int, port: int):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if world == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, rank=rank, world_size=world,
                                init_method=f"tcp://localhost:{port}")
    if backend == "nccl":
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    return torch.device("cpu")


def _inputs(cfg, dev):
    import torch
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g)
    kw = {}
    if cfg.n_prefix:
        kw["prefix_embeds"] = torch.randn(
            (B, cfg.n_prefix, cfg.d_model), generator=g).to(
                dev, cfg.compute_dtype)
    if cfg.is_encdec:
        kw["enc_frames"] = torch.randn(
            (B, cfg.enc_seq, cfg.d_model), generator=g).to(
                dev, cfg.compute_dtype)
    return tokens.to(dev), tokens.roll(1, 1).to(dev), kw


def _opt(cfg):
    from repro_torch.optim.adamw import OptConfig
    return OptConfig(lr=LR, weight_decay=WD, warmup_steps=1,
                     state_dtype="int8" if cfg.param_dtype == "bfloat16"
                     else "float32")


def _gap(a, b) -> float:
    from repro_torch import sharding as SH
    a, b = SH.to_local(a).float().cpu(), SH.to_local(b).float().cpu()
    return float((a - b).abs().max()) if a.numel() else 0.0


def _value(x):
    """A moment's full float32 value on this rank (int8 dequantized)."""
    from repro_torch import sharding as SH
    from repro_torch.optim.adamw import Moment
    return SH.to_local(x.value() if isinstance(x, Moment) else x).float()


def _rel(a, b) -> float:
    """||a - b|| / ||b||; 0.0 where both are zero, inf where only ``b``
    is."""
    num = float((a - b).norm())
    den = float(b.norm())
    return num / den if den else (0.0 if num == 0.0 else float("inf"))


def _one_rank(arch: str, mesh, dev) -> dict:
    """Plain and DTensor runs of one smoke config on a one-rank mesh:
    {what: gap} of everything compared (0.0 where bit-identical)."""
    import torch
    from repro_torch import sharding as SH
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import Moment
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import init_train_state, make_train_step

    cfg = get_smoke_config(arch)
    rules = SH.DEFAULT_RULES
    params = init_params(torch.Generator().manual_seed(0), cfg, dev)
    dparams = specs.place(params, specs.params_shardings(mesh, rules, cfg))
    tokens, labels, kw = _inputs(cfg, dev)
    gaps, toks = {}, {}
    buf = S + N_DECODE + (cfg.n_prefix or 0)
    with torch.no_grad():
        for side, p, m in (("plain", params, None), ("mesh", dparams, mesh)):
            with SH.use_mesh_rules(m):
                model = T.build(p, cfg)
                lg, caches = T.prefill(model, cfg, tokens, buf_len=buf, **kw)
                out = [SH.to_local(lg)]
                for i in range(N_DECODE):
                    tok = out[-1].argmax(-1).to(torch.int32)
                    lg, caches = T.decode_step(model, cfg, caches, tok,
                                               S + (cfg.n_prefix or 0) + i)
                    out.append(SH.to_local(lg))
            toks[side] = out
    for i, (a, b) in enumerate(zip(toks["mesh"], toks["plain"])):
        gaps[f"logits {i}"] = _gap(a, b)
        gaps[f"tokens {i}"] = float(not torch.equal(a.argmax(-1),
                                                    b.argmax(-1)))
    opt, clk = _opt(cfg), ClockConfig()
    st = init_train_state(torch.Generator().manual_seed(2), cfg, opt, clk,
                          dev)
    dst = specs.place(st, specs.state_shardings(
        mesh, rules, cfg, specs.abstract_state(cfg, opt, clk)))
    step = make_train_step(cfg, opt, clk)
    batch = {"tokens": tokens, "labels": labels, "ev_hi": 7, "ev_lo": 9,
             **kw}
    s1, m1 = step(st, batch)
    with SH.use_mesh_rules(mesh):
        s2, m2 = step(dst, batch)
    for k in ("loss", "grad_norm", "aux", "clock_sum"):
        gaps[k] = _gap(m2[k], m1[k])
    gaps["clock cells"] = _gap(s2.clock_cells, s1.clock_cells)
    for k in s1.params:
        gaps[f"param {k}"] = _gap(s2.params[k], s1.params[k])
        for mom in ("m", "v"):
            a, b = s2.opt[mom][k], s1.opt[mom][k]
            if isinstance(b, Moment):
                gaps[f"{mom} {k} codes"] = _gap(a.codes, b.codes)
                gaps[f"{mom} {k} scale"] = _gap(a.scale, b.scale)
            else:
                gaps[f"{mom} {k}"] = _gap(a, b)
    return gaps


def _moment_rel(got: dict, want: dict) -> dict:
    """{"m leaf": rel} of every moment (dequantized) against ``want``'s."""
    return {f"{mom} {k}": _rel(_value(got[mom][k]), _value(want[mom][k]))
            for mom in ("m", "v") for k in want[mom]}


def _adamw_on_mesh(cfg, mesh, params: dict, dparams: dict, opt) -> dict:
    """Two ``adamw_update`` steps on the plain ``params`` and on their
    placed copies ``dparams``, fed the same seeded gradients (placed as
    the params), with float32 and with int8 moments (placed by
    ``state_shardings``): {state dtype: {what: ...}} with the largest
    relative norm a leaf of the params' change and of each moment
    (dequantized), mesh against plain, the number of leaves (params,
    moments, int8 codes and scales) sharded over more than one rank,
    and the number of int8 moments."""
    import dataclasses
    import torch
    from repro_torch import sharding as SH
    from repro_torch.launch import specs
    from repro_torch.optim.adamw import Moment, adamw_update, init_opt_state
    from repro_torch.runtime.clock_runtime import ClockConfig

    def sharded(t):
        return any(not q.is_replicate() and n > 1
                   for q, n in zip(t.placements, mesh.shape))

    p0 = {k: v.float() for k, v in params.items()}
    res = {}
    for dtype in ("float32", "int8"):
        o = dataclasses.replace(opt, state_dtype=dtype)
        sh = specs.state_shardings(mesh, SH.DEFAULT_RULES, cfg,
                                   specs.abstract_state(cfg, o, ClockConfig()))
        pp, po = params, init_opt_state(params, o)
        mp, mo = dparams, specs.place(po, sh.opt)
        g = torch.Generator().manual_seed(5)
        for _ in range(2):
            grads = {k: torch.randn(v.shape, generator=g).to(v.device, v.dtype)
                     for k, v in params.items()}
            dgrads = {k: SH.placed_as(SH.replicated(v, mp[k]), mp[k])
                      for k, v in grads.items()}
            pp, po, _ = adamw_update(pp, grads, po, o)
            mp, mo, _ = adamw_update(mp, dgrads, mo, o)
        rel = [_rel(SH.to_local(mp[k]).float() - p0[k], pp[k].float() - p0[k])
               for k in p0]
        moms = [*mo["m"].values(), *mo["v"].values()]
        leaves = list(mp.values()) + [
            t for x in moms
            for t in ((x.codes, x.scale) if isinstance(x, Moment) else (x,))]
        res[dtype] = {
            "param_rel": max(rel),
            "moment_rel": max(_moment_rel(mo, po).values()),
            "sharded_leaves": sum(map(sharded, leaves)),
            "int8_moments": sum(isinstance(x, Moment) for x in moms)}
    return res


def _four_rank(arch: str, mesh, dev, rank: int, npz: str, ckpt: str) -> dict:
    """The forward and one train step on the 2x2 mesh beside the plain
    port on every rank (rank 0's figures returned), from the JAX
    package's weights in ``npz``; the dense config's checkpoint round
    trip."""
    import torch
    from repro_torch import sharding as SH
    from repro_torch.checkpoint.manager import CheckpointManager, _leaves
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_table
    from repro_torch.runtime.clock_runtime import ClockConfig, ClockRuntime
    from repro_torch.runtime.training import init_train_state, make_train_step

    cfg = get_smoke_config(arch)
    rules = SH.DEFAULT_RULES
    with np.load(npz) as z:
        params = {}
        for path, info in param_table(cfg).items():
            t = torch.from_numpy(z[path].copy())
            params[path] = (t.view(torch.bfloat16) if info.dtype == "bfloat16"
                            else t).to(dev)
        tokens = torch.from_numpy(z["__tokens"]).to(dev)
    dparams = specs.place(params, specs.params_shardings(mesh, rules, cfg))
    out = {}
    with torch.no_grad():
        plain, _ = T.forward_train(params, cfg, tokens)
        with SH.use_mesh_rules(mesh):
            lg, _ = T.forward_train(dparams, cfg, tokens)
        lg = SH.to_local(lg)
    out["logits"] = lg.float().cpu().numpy().tolist()
    out["plain_logits"] = plain.float().cpu().numpy().tolist()
    opt, clk = _opt(cfg), ClockConfig()
    st = init_train_state(torch.Generator().manual_seed(2), cfg, opt, clk,
                          dev)
    sh = specs.state_shardings(mesh, rules, cfg, specs.abstract_state(cfg, opt, clk))
    dst = specs.place(st, sh)
    step = make_train_step(cfg, opt, clk)
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1), "ev_hi": 7,
             "ev_lo": 9}
    s1, m1 = step(st, batch)
    with SH.use_mesh_rules(mesh):
        s2, m2 = step(dst, batch)
    out["metrics"] = {k: [float(m2[k]), float(m1[k])]
                      for k in ("loss", "grad_norm", "clock_sum")}
    out["param_gap"] = max(_gap(s2.params[k], s1.params[k])
                           for k in s1.params)
    out["param_bound"] = max(
        2 * LR * (1 + WD * float(st.params[k].float().abs().max()))
        for k in st.params)
    out["clock_equal"] = bool(torch.equal(SH.to_local(s2.clock_cells),
                                          s1.clock_cells))
    out["moment_rel"] = _moment_rel(s2.opt, s1.opt)
    out["adamw"] = _adamw_on_mesh(cfg, mesh, st.params, dst.params, opt)
    if ckpt:
        # restore onto the mesh, save the DTensor state (every rank,
        # each its own directory), restore that plain
        snap = ClockRuntime(clk, device=dev).snapshot()
        if rank == 0:
            CheckpointManager(ckpt).save(1, s1, snap, block=True)
        torch.distributed.barrier()
        got, _ = CheckpointManager(ckpt).restore(target_structure=s1,
                                                 shardings=sh)
        placed = all(tuple(leaf.placements) == s.placements
                     for (_, leaf), (_, s) in zip(_leaves(got), _leaves(sh)))
        mine = os.path.join(ckpt, f"rank{rank}")
        CheckpointManager(mine).save(2, got, snap, block=True)
        back, _ = CheckpointManager(mine).restore(target_structure=s1,
                                                  device=dev)
        same = all(torch.equal(a, b) for (_, a), (_, b)
                   in zip(_leaves(back), _leaves(s1)))
        out["round_trip"] = [placed, same]
    return out


def _worker(argv: list) -> None:
    args = json.loads(argv[0])
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh

    dev = _setup(args["backend"], args["rank"], args["world"], args["port"])
    mesh = make_local_mesh(*args["mesh"])
    if args["mode"] == "one":
        res = {a: _one_rank(a, mesh, dev) for a in args["archs"]}
    else:
        res = _four_rank(args["archs"][0], mesh, dev, args["rank"],
                         args["npz"], args.get("ckpt", ""))
    if args["rank"] == 0:
        with open(args["out"], "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Job:
    """Worker processes of one group, started at once; ``result()``
    waits for them and reads rank 0's output."""

    def __init__(self, out: str, world: int, **args):
        port = free_port() if world > 1 else 0
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        self.out = out
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, json.dumps(dict(
                args, rank=r, world=world, port=port, out=out))],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
        self._res = None

    def result(self) -> dict:
        if self._res is None:
            for p in self.procs:
                _, err = p.communicate(timeout=600)
                assert p.returncode == 0, err[-4000:]
            with open(self.out) as f:
                self._res = json.load(f)
        return self._res


def _save_inputs(path: str, params: dict, tokens: np.ndarray) -> None:
    """Weights (bfloat16 leaves as their 16 bits) and tokens in ``path``,
    as ``_four_rank`` reads them."""
    arrs = {}
    for k, v in params.items():
        a = np.asarray(v)
        arrs[k] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    np.savez(path, __tokens=tokens, **arrs)


def port_inputs(arch: str, path: str) -> None:
    """The port's own smoke weights (from a seeded generator) and tokens
    in ``path``: the four-rank inputs where JAX is not installed."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params

    cfg = get_smoke_config(arch)
    params = init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (4, 16),
                                               dtype=np.int32)
    _save_inputs(path, {k: (v.view(torch.int16).numpy().view(np.uint16)
                            if v.dtype == torch.bfloat16 else v.numpy())
                        for k, v in params.items()}, tokens)


def jax_inputs(arch: str, path: str):
    """The JAX package's smoke weights (bfloat16 leaves as their 16
    bits) and tokens in ``path``; the JAX forward's logits."""
    import jax
    from repro.configs import get_smoke_config
    from repro.models import params as JP
    from repro.models import transformer as JT

    cfg = get_smoke_config(arch)
    params = JP.init_params(jax.random.PRNGKey(3), cfg)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (4, 16),
                                               dtype=np.int32)
    _save_inputs(path, params, tokens)
    logits, _ = JT.forward_train(params, cfg, tokens)
    return np.asarray(logits, np.float32)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every worker of this file, started side by side."""
    d = tmp_path_factory.mktemp("mesh_ranks")
    out = {}
    for i, group in enumerate(ONE_RANK_GROUPS):
        job = Job(str(d / f"one{i}.json"), 1, mode="one", backend="gloo",
                  mesh=[1, 1], archs=group)
        out.update({a: job for a in group})
    for a in FOUR_RANK_ARCHS:
        npz = str(d / f"{a}.npz")
        ref = jax_inputs(a, npz)
        ckpt = str(d / f"ckpt_{a}") if a == FOUR_RANK_ARCHS[0] else ""
        out[("four", a)] = (Job(str(d / f"four_{a}.json"), 4, mode="four",
                                backend="gloo", mesh=[2, 2], archs=[a],
                                npz=npz, ckpt=ckpt), ref)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_gloo_mesh_matches_plain(jobs, arch):
    gaps = jobs[arch].result()[arch]
    assert any(k.startswith("param ") for k in gaps)
    differ = {k: v for k, v in gaps.items() if v != 0.0}
    assert differ == REWRITTEN.get(arch, {}), differ


def check_four_rank(arch: str, res: dict) -> None:
    """``_four_rank``'s figures against the plain port's (the tolerances
    above)."""
    np.testing.assert_allclose(np.asarray(res["logits"]),
                               np.asarray(res["plain_logits"]), **BF16_TOL)
    for k, (mesh, plain) in res["metrics"].items():
        assert abs(mesh - plain) <= LOSS_RTOL * abs(plain), (k, mesh, plain)
    assert res["param_gap"] <= res["param_bound"], res["param_gap"]
    for k, rel in res["moment_rel"].items():
        assert rel <= MOMENT_RTOL[arch], (k, rel)
    assert res["clock_equal"]
    for dtype, r in res["adamw"].items():
        assert r["sharded_leaves"] > 0, (dtype, r)
        assert r["param_rel"] <= ADAMW_RTOL, (dtype, r)
        assert r["moment_rel"] <= ADAMW_RTOL, (dtype, r)
    assert res["adamw"]["int8"]["int8_moments"] > 0


@pytest.mark.parametrize("arch", FOUR_RANK_ARCHS)
def test_four_rank_gloo_mesh_within_tolerance(jobs, arch):
    job, jax_logits = jobs[("four", arch)]
    res = job.result()
    check_four_rank(arch, res)
    np.testing.assert_allclose(np.asarray(res["logits"]), jax_logits,
                               **BF16_TOL)


def test_restore_shardings_round_trip_on_four_ranks(jobs):
    """Restored onto the 2x2 mesh with the placements of
    ``state_shardings``; saved from the DTensors and restored plain,
    the state comes back bit for bit."""
    job, _ = jobs[("four", FOUR_RANK_ARCHS[0])]
    assert job.result()["round_trip"] == [True, True]


if __name__ == "__main__":
    _worker(sys.argv[1:])
