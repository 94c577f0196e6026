"""The vocab-parallel cross-entropy and the shard-local attention stats,
on the CPU.

- Seeded numpy logits [B, S, V] (V = 64, which the model axis of 2
  divides, and V = 63, which it does not: the rules replicate the vocab
  and each rank takes the plain formula), labels with -1 and >= V among
  them, z-loss 1e-4 and 0, through the reference's
  ``repro.runtime.training.cross_entropy`` and ``jax.grad`` of it (JAX on
  the CPU), the port's plain ``cross_entropy``, and the port's sharded
  path (``vocab_parallel_ce``, a ``local_map``) on gloo groups in
  subprocesses (this file run as a script): monolithic
  (``cross_entropy`` on DTensor logits) and seq-chunked
  (``chunked_cross_entropy``, the unembedding the identity so that its
  chunks are slices of the same logits; its z-loss is the reference
  loop's fixed 1e-4).  Four ranks on a 2 x 2 (data, model) mesh: the
  loss within rtol ``LOSS_RTOL`` and the logits' gradient within atol
  ``GRAD_ATOL`` of the reference's; a ``TorchDispatchMode`` over the
  sharded loss and its backward (V = 64) sees no local tensor with the
  global vocab extent, and ``sharding.FALLBACKS`` records no gather.
  One rank, a (1, 1) mesh: loss and gradient bit-identical to the plain
  path.  Both meshes also take a smoke train step of Qwen with
  ``ce_chunk`` against the plain step (one rank: equal; four ranks:
  within the bfloat16 loss tolerance of ``test_torch_model_mesh_ranks``).
- The dry run on a fake 512-rank group (a subprocess): Qwen1.5-0.5B's
  full config at ``train_4k`` on 16 x 16, its per-device ``temp`` within
  1.5x the reference's (14.40 GB, the reference's ``run_cell`` on an
  Auto mesh: ``scripts/reference_dryrun.py``), its argument and output
  bytes those of the record before the repair (``PERF.md`` §6), no
  ``op`` gather, and its all-gather bytes at least one rank's
  full-vocab float32 logits below that record's; and the prefill of two
  smoke configs (dense, and MLA, whose value head differs from its
  query head) creates no local tensor of the global running-stat shapes
  (B, Sq, KV, G[, Dv]) and does create their local shards (a GQA rank
  holds its heads of the model axis's split, MLA all of them).
"""
import contextlib
import json
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

B, S = 4, 12
VOCABS = [64, 63]
Z_LOSSES = [1e-4, 0.0]
#: seq chunk of the chunked path (12 = 3 x 4: no padded chunk)
CHUNK = 4
LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-6
#: a smoke train step on the 2 x 2 mesh against the plain one
STEP_LOSS_RTOL = 2e-2
#: the dry run's record of qwen1.5-0.5b train_4k on 16 x 16 before the
#: vocab-parallel loss (``PERF.md`` §6), bytes a device
QWEN_TRAIN_RECORD = {"argument": 23_758_864, "output": 23_234_588,
                     "all-gather": 44_451_725_312}
#: the reference's temp for that cell (``scripts/reference_dryrun.py``)
QWEN_TRAIN_REF_TEMP = 14.40e9
#: the card's memory case (``tests/test_torch_gpu.py``): Qwen's smoke
#: widths at Qwen1.5-0.5B's vocab, whose logits outweigh the rest
MEM_VOCAB = 151_936
MEM_B, MEM_S = 4, 256


def logits_and_labels(V: int):
    """Seeded float32 logits [B, S, V] and int32 labels with -1 and
    labels >= V among them."""
    rng = np.random.default_rng(V)
    logits = (2.0 * rng.standard_normal((B, S, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 2] = V
    labels[2, 5] = V + 7
    return logits, labels


# ---------------------------------------------------------------------------
# the worker (this file run as a script, in its own process)
# ---------------------------------------------------------------------------

def _global_vocab_seen(V: int):
    """A dispatch mode recording every local tensor an op returns whose
    last dim is ``V`` (DTensor ops are passed on to DTensor, which runs
    them as local ops seen here; fake tensors are not recorded)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    fake = torch._subclasses.FakeTensor

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                # DTensor's shape propagation makes fake tensors of the
                # global shape: no storage
                if (isinstance(t, torch.Tensor) and t.ndim
                        and t.shape[-1] == V and not isinstance(t, fake)):
                    self.shapes.append([str(func), list(t.shape)])
            return out
    return Seen()


def _loss_and_grad(fn, x, mode):
    """(loss, the gradient of ``x``) of ``fn(x)`` run under ``mode``, as
    a float and float64 numpy, the full values."""
    import torch
    from torch.distributed.tensor import DTensor

    x = x.detach().requires_grad_(True)
    with mode:
        loss = fn(x)
        (g,) = torch.autograd.grad(loss, [x])
    loss, g = (t.full_tensor() if isinstance(t, DTensor) else t
               for t in (loss, g))
    return float(loss), g.double().numpy()


def _smoke_step(mesh) -> list:
    """Qwen's smoke config with ``ce_chunk`` 4: one train step's loss,
    plain and on ``mesh``."""
    import dataclasses
    import torch
    from repro_torch import sharding as SH
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import init_train_state, make_train_step

    cfg = dataclasses.replace(get_smoke_config("qwen1_5_0_5b"), ce_chunk=4)
    opt, clk = OptConfig(lr=3e-4, warmup_steps=1), ClockConfig()
    st = init_train_state(torch.Generator().manual_seed(2), cfg, opt, clk,
                          "cpu")
    dst = specs.place(st, specs.state_shardings(
        mesh, SH.DEFAULT_RULES, cfg, specs.abstract_state(cfg, opt, clk)))
    tokens = torch.randint(0, cfg.vocab, (4, 10),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1), "ev_hi": 7,
             "ev_lo": 9}
    step = make_train_step(cfg, opt, clk)
    _, m1 = step(st, batch)
    with SH.use_mesh_rules(mesh):
        _, m2 = step(dst, batch)
    return [float(m2["loss"]), float(m1["loss"])]


def _memory_step(mesh, dev) -> dict:
    """Qwen's smoke widths at Qwen1.5-0.5B's vocab (``MEM_VOCAB``), batch
    ``MEM_B`` x ``MEM_S``: one plain train step on this rank's card, then
    one on ``mesh`` from the same state: both losses, the card's
    ``max_memory_allocated`` above the mesh step's start, and the
    float32 bytes of this rank's batch rows at the full vocab."""
    import dataclasses
    import torch
    from repro_torch import sharding as SH
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import init_train_state, make_train_step

    cfg = dataclasses.replace(get_smoke_config("qwen1_5_0_5b"),
                              vocab=MEM_VOCAB)
    opt, clk = OptConfig(lr=3e-4, warmup_steps=1), ClockConfig()
    st = init_train_state(torch.Generator().manual_seed(2), cfg, opt, clk, dev)
    dst = specs.place(st, specs.state_shardings(
        mesh, SH.DEFAULT_RULES, cfg, specs.abstract_state(cfg, opt, clk)))
    tokens = torch.randint(0, cfg.vocab, (MEM_B, MEM_S),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1), "ev_hi": 7,
             "ev_lo": 9}
    step = make_train_step(cfg, opt, clk)
    _, plain = step(st, batch)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    with SH.use_mesh_rules(mesh):
        _, got = step(dst, batch)
    torch.cuda.synchronize(dev)
    rows = MEM_B // SH.axis_sizes(mesh)["data"]
    return {"loss": [float(got["loss"]), float(plain["loss"])],
            "transient": torch.cuda.max_memory_allocated(dev) - start,
            "full_vocab_logits": rows * MEM_S * cfg.vocab * 4}


def _loss_cases(mesh) -> dict:
    """Every loss of ``logits_and_labels`` plain and on ``mesh``, with
    the logits' gradient; the sharded runs' fallbacks and local tensors
    of the global vocab extent; ``_smoke_step``."""
    import torch
    from repro_torch import sharding as SH
    from repro_torch.runtime.training import (chunked_cross_entropy,
                                              cross_entropy)

    res = {"cases": {}, "fallbacks": {}, "vocab_seen": {}}
    for V in VOCABS:
        logits, labels = logits_and_labels(V)
        x, lab = torch.from_numpy(logits), torch.from_numpy(labels)
        with SH.use_mesh_rules(mesh):
            dx = SH.shard(x, ("act_batch", "act_seq", "act_vocab"))
        runs = {}
        for z in Z_LOSSES:
            for side, t in (("plain", x), ("mesh", dx)):
                runs[f"{side} z={z}"] = (
                    lambda t, z=z: cross_entropy(t, lab, V, z), t)
        for side, t in (("plain", x), ("mesh", dx)):
            runs[f"{side} chunked"] = (lambda t: chunked_cross_entropy(
                lambda h: h, t, lab, V, CHUNK), t)
        SH.FALLBACKS.clear()
        seen = _global_vocab_seen(V)
        for what, (fn, t) in runs.items():
            if what.startswith("mesh"):
                with SH.use_mesh_rules(mesh):
                    out = _loss_and_grad(fn, t, seen)
            else:
                out = _loss_and_grad(fn, t, contextlib.nullcontext())
            res["cases"][f"V={V} {what}"] = [out[0], out[1].tolist()]
        res["fallbacks"][str(V)] = dict(SH.FALLBACKS)
        res["vocab_seen"][str(V)] = seen.shapes
    res["step"] = _smoke_step(mesh)
    return res


def _worker(argv: list) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from test_torch_model_mesh_ranks import _setup

    args = json.loads(argv[0])
    dev = _setup(args.get("backend", "gloo"), args["rank"], args["world"],
                 args["port"])
    mesh = make_local_mesh(*args["mesh"])
    res = (_memory_step(mesh, dev) if args.get("mode") == "memory"
           else _loss_cases(mesh))
    if args["rank"] == 0:
        with open(args["out"], "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def ranks(out: str, world: int, mesh: list, **args) -> list:
    """This file's worker in ``world`` processes (rank 0 writes ``out``),
    started at once."""
    from test_torch_model_mesh_ranks import free_port

    port = free_port() if world > 1 else 0
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


_DRY = """
    import dataclasses, json
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.shapes import SHAPES

    dryrun.init_fake_group(512)
    rec = dryrun.run_cell("qwen1_5_0_5b", "train_4k", quiet=True)
    out = {{"train": {{**rec["bytes_per_device"],
                       **rec["collectives"],
                       "gathers": rec["replicated_fallback"]["gathers"]}}}}

    class Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            res = func(*args, **(kwargs or {{}}))
            # not the fake tensors of DTensor's shape propagation
            self.seen.update(tuple(t.shape) for t in tree_leaves(res)
                             if isinstance(t, torch.Tensor) and not
                             isinstance(t, torch._subclasses.FakeTensor))
            return res

    for arch in {archs!r}:
        cfg = dataclasses.replace(get_smoke_config(arch), attn_chunk=2048)
        with Shapes() as mode:
            rec = dryrun.run_cell(arch, "prefill_32k", cfg_override=cfg,
                                  quiet=True)
        shape = SHAPES["prefill_32k"]
        G = cfg.n_heads // cfg.n_kv_heads
        Dv = cfg.v_head_dim if cfg.use_mla else cfg.d_head
        lead = (shape.seq_len + (cfg.n_prefix or 0), cfg.n_kv_heads, G)
        # GQA keeps a rank's heads (attention.attn_heads): rank 0 holds
        # ceil(H / 16) of them and the KV heads they read
        h = -(-cfg.n_heads // 16)
        kv = -(-h // G)
        mine = lead if cfg.use_mla else (lead[0], kv, h // kv)
        out[arch] = {{"status": rec["status"],
                      "global": [list((shape.global_batch,) + lead + last)
                                 for last in ((Dv,), ())],
                      "local": [list((shape.global_batch // 16,) + mine + last)
                                for last in ((Dv,), ())],
                      "seen": [list(s) for s in mode.seen if len(s) in (4, 5)]}}
    print(json.dumps(out), flush=True)
"""

#: the smoke configs of the running-stat case: dense, and MLA (Dv != Dh)
STAT_ARCHS = ["qwen1_5_0_5b", "deepseek_v2_236b"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four-rank and one-rank groups and the dry run, side by side;
    the reference's losses and gradients in this process meanwhile."""
    d = tmp_path_factory.mktemp("loss_parallel")
    procs = {side: ranks(str(d / f"{side}.json"), n, mesh)
             for side, n, mesh in (("four", 4, [2, 2]), ("one", 1, [1, 1]))}
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    dry = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_DRY.format(archs=STAT_ARCHS))],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ref = reference()
    out = {"ref": ref}
    for side, ps in procs.items():
        out[side] = result(ps, str(d / f"{side}.json"))
    stdout, stderr = dry.communicate(timeout=600)
    assert dry.returncode == 0, stderr[-4000:]
    out["dry"] = json.loads(stdout.strip().splitlines()[-1])
    return out


def reference() -> dict:
    """{"V=.. z=..": (loss, gradient)} of the reference's
    ``cross_entropy`` and ``jax.grad`` of it."""
    import jax
    import jax.numpy as jnp
    from repro.runtime.training import cross_entropy

    out = {}
    for V in VOCABS:
        logits, labels = logits_and_labels(V)
        for z in Z_LOSSES:
            fn = lambda x, z=z: cross_entropy(x, jnp.asarray(labels), V, z)
            loss, g = jax.value_and_grad(fn)(jnp.asarray(logits))
            out[f"V={V} z={z}"] = (float(loss), np.asarray(g, np.float64))
    return out


CASES = [(V, what) for V in VOCABS
         for what in [f"z={z}" for z in Z_LOSSES] + ["chunked"]]


def _ref_key(V: int, what: str) -> str:
    # the chunked loop's z-loss is the reference loop's fixed 1e-4
    return f"V={V} {'z=0.0001' if what == 'chunked' else what}"


@pytest.mark.parametrize("V,what", CASES)
def test_four_rank_loss_and_grad_match_reference(runs, V, what):
    want_loss, want_grad = runs["ref"][_ref_key(V, what)]
    for side in ("mesh", "plain"):
        loss, grad = runs["four"]["cases"][f"V={V} {side} {what}"]
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL,
                                   err_msg=side)
        np.testing.assert_allclose(np.asarray(grad), want_grad, rtol=0,
                                   atol=GRAD_ATOL, err_msg=side)


@pytest.mark.parametrize("V,what", CASES)
def test_one_rank_mesh_bit_identical_to_plain(runs, V, what):
    mesh = runs["one"]["cases"][f"V={V} mesh {what}"]
    plain = runs["one"]["cases"][f"V={V} plain {what}"]
    assert mesh[0] == plain[0]
    np.testing.assert_array_equal(np.asarray(mesh[1]), np.asarray(plain[1]))


@pytest.mark.parametrize("V", VOCABS)
def test_four_rank_sharded_loss_gathers_nothing(runs, V):
    """No gather through ``sharding``'s fallbacks; with the vocab split
    over the model axis no local tensor has the global vocab extent
    (with V odd the rules replicate it, as the reference's do)."""
    assert runs["four"]["fallbacks"][str(V)] == {}
    seen = runs["four"]["vocab_seen"][str(V)]
    if V % 2 == 0:
        assert seen == [], seen[:5]
    else:
        assert seen


def test_smoke_train_step_with_ce_chunk_on_the_mesh(runs):
    mesh, plain = runs["one"]["step"]
    assert mesh == plain
    mesh, plain = runs["four"]["step"]
    assert abs(mesh - plain) <= STEP_LOSS_RTOL * abs(plain), (mesh, plain)


def test_dryrun_qwen_train_within_reference_temp(runs):
    rec = runs["dry"]["train"]
    assert rec["argument"] == QWEN_TRAIN_RECORD["argument"]
    assert rec["output"] == QWEN_TRAIN_RECORD["output"]
    assert 0 <= rec["temp"] <= 1.5 * QWEN_TRAIN_REF_TEMP, rec["temp"]
    assert "op" not in rec["gathers"], rec["gathers"]
    # the vocab-gathered logits of one rank's rows: [16, 4,096, V] float32
    assert rec["all-gather"] <= (QWEN_TRAIN_RECORD["all-gather"]
                                 - 16 * 4096 * 151_936 * 4), rec["all-gather"]


@pytest.mark.parametrize("arch", STAT_ARCHS)
def test_prefill_running_stats_stay_on_their_shards(runs, arch):
    rec = runs["dry"][arch]
    assert rec["status"] == "ok"
    seen = {tuple(s) for s in rec["seen"]}
    for g in rec["global"]:
        assert tuple(g) not in seen, g
    for s in rec["local"]:
        assert tuple(s) in seen, s


if __name__ == "__main__":
    _worker(sys.argv[1:])
