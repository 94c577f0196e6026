"""The dry run's memory and byte counts (``launch.dryrun._traced`` and
its ``_LocalCounter``) on the CPU.

Hand programs whose ``peak``, ``temp`` and ``bytes_accessed`` are
worked out here, each on ``meta`` and on real CPU tensors; one train
and one decode step of Qwen1.5-0.5B's and mamba2-130m's smoke configs
counted on ``meta`` and on the CPU; one DTensor op on a 4-rank fake
group (in a subprocess of its own).

Tolerance: none.  Every count is exact.  N is the element count of the
float32 argument ``x``, so one [N] float32 tensor is 4N bytes, and a
0-d float32 tensor 4 bytes.
"""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro_torch.checkpoint.manager import _rebuild  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.runtime.clock_runtime import ClockConfig  # noqa: E402
from repro_torch.runtime.training import (init_train_state,  # noqa: E402
                                          make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1024
DEVICES = ("meta", "cpu")


# ---------------------------------------------------------------------------
# hand programs
# ---------------------------------------------------------------------------

def chain(x):
    """Allocate and free: A, B live together; A dies before C."""
    a = x * 2          # A 4N: live 4N; reads 4N, writes 4N
    b = a + 1          # B 4N: live 8N (the high)
    del a              # live 4N
    return b.exp()     # C 4N: live 8N; B dies on return: C alone


def views_in_place(x, buf):
    """Views, an in-place op and an ``out=`` op create nothing."""
    v = x.view(2, -1)                  # a view: no bytes
    torch.ops.aten._unsafe_view(x, [N])   # a view by another name
    v.mul_(3)                          # in place: reads 4N, writes 4N
    torch.add(x, 1, out=buf)           # out=: reads x and buf, writes buf
    return v[0].add_(1)                # a view, then 2N read, 2N written


def saved(x):
    """Forward and backward: exp saves its result, so E1, E2, E3 stay
    live until the backward.  Forward: 12N + 4 (the loss).  Backward:
    ones (4), then Exp3Backward's grad x E3 (G3) with E1, E2, E3 live:
    16N + 8, the high; each result dies after its node runs."""
    loss = x.exp().exp().exp().sum()
    (g,) = torch.autograd.grad(loss, [x])
    return g


def remat(x):
    """The same block remat'd: the forward holds at most two results
    (8N); the backward recomputes E1', E2', E3' (24N more bytes) and
    peaks as ``saved`` does, at 16N + 8."""
    loss = checkpoint(lambda h: h.exp().exp().exp(), x,
                      use_reentrant=False).sum()
    (g,) = torch.autograd.grad(loss, [x])
    return g


#: name -> (program, x requires grad, the high (the most bytes of the
#: step's own storages live at once), the output's created bytes, bytes
#: accessed)
PROGRAMS = {
    # exp/mul/add: 8N each
    "chain": (chain, False, 8 * N, 4 * N, 24 * N),
    # mul_ 8N, add.out x + buf in, buf out 12N, add_ of a row 4N
    "views_in_place": (views_in_place, False, 0, 0, 24 * N),
    # 3 exp (24N), sum (4N + 4), ones_like (4 + 4), 3 mul (36N)
    "saved": (saved, True, 16 * N + 8, 4 * N, 64 * N + 12),
    # as "saved", plus the recompute's 3 exp
    "remat": (remat, True, 16 * N + 8, 4 * N, 88 * N + 12),
}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_hand_program_counts(name, device):
    prog, grad, high, out_bytes, accessed = PROGRAMS[name]
    x = torch.ones(N, device=device).requires_grad_(grad)
    args = (x,) if prog is not views_in_place else (
        x, torch.empty(N, device=device))
    argument = D._local_bytes(args)
    out, count, mem = D._traced(prog, args, argument, device=device,
                                grad=grad)
    assert count.high == high
    assert mem == {"peak": argument + high,
                   "temp": high - out_bytes}
    assert count.bytes_accessed == accessed
    assert count.flops == 0
    assert count.live >= out_bytes    # the output's storages stay live


def test_matmul_flops_and_bytes():
    """A matmul's FLOPs and bytes: [8, 4] @ [4, 16] reads 128 + 256
    bytes, writes 512, and does 2 x 8 x 4 x 16 FLOPs."""
    a, b = torch.ones(8, 4), torch.ones(4, 16)
    out, count, mem = D._traced(torch.mm, (a, b), 384, device="cpu")
    assert (count.flops, count.bytes_accessed) == (1024, 896)
    assert mem == {"peak": 384 + 512, "temp": 0}


def test_other_devices_are_not_counted():
    """Only storages on the traced device count: a CPU tensor made
    while tracing ``meta`` adds nothing."""
    def step(x):
        host = torch.ones(N)
        return x + 1, host * 2

    x = torch.empty(N, device="meta")
    out, count, mem = D._traced(step, (x,), 4 * N)
    assert (count.high, count.bytes_accessed, mem["temp"]) == (4 * N, 8 * N, 0)


# ---------------------------------------------------------------------------
# the smoke configs: meta against real CPU tensors
# ---------------------------------------------------------------------------

B, S, BUF = 2, 32, 40


def meta_copy(t):
    return torch.empty_like(t, device="meta")


def smoke_inputs(arch: str, kind: str, device: str):
    """(step, args, grad) of one train or decode step of ``arch``'s smoke
    config, drawn on the CPU from seeds and copied to ``meta`` as
    ``meta_copy`` for ``device == "meta"``."""
    cfg = get_smoke_config(arch)
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (B, S), generator=g, dtype=torch.int32)
    move = meta_copy if device == "meta" else (lambda t: t)
    if kind == "train":
        opt_cfg, clock_cfg = OptConfig(), ClockConfig()
        state = init_train_state(torch.Generator().manual_seed(0), cfg,
                                 opt_cfg, clock_cfg, device="cpu")
        state = _rebuild(state, lambda _k, t: move(t))
        batch = {"tokens": move(tok), "labels": move(tok.roll(-1, 1)),
                 "ev_hi": 1, "ev_lo": 2}
        return make_train_step(cfg, opt_cfg, clock_cfg), (state, batch), True
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    model = T.build({k: move(v) for k, v in params.items()}, cfg, device)
    caches = T.init_decode_caches(cfg, B, BUF, device=device)
    return (lambda m, c, t: T.decode_step(m, cfg, c, t, S),
            (model, caches, move(tok[:, 0])), False)


@pytest.mark.parametrize("kind", ("train", "decode"))
@pytest.mark.parametrize("arch", ("qwen1_5_0_5b", "mamba2_130m"))
def test_smoke_steps_count_alike_on_meta_and_cpu(arch, kind):
    got = {}
    for device in DEVICES:
        step, args, grad = smoke_inputs(arch, kind, device)
        reads = (args if kind == "train"
                 else (dict(args[0].named_buffers()),) + args[1:])
        argument = D._local_bytes(reads)
        out, count, mem = D._traced(step, args, argument, device=device,
                                    grad=grad)
        got[device] = dict(mem, bytes_accessed=count.bytes_accessed,
                           flops=count.flops, argument=argument)
    assert got["meta"] == got["cpu"]
    m = got["meta"]
    assert m["peak"] >= m["argument"] + m["temp"] and m["temp"] > 0
    assert m["bytes_accessed"] >= m["argument"] and m["flops"] > 0
    if kind == "train":
        # the functional step holds a second copy of the state: its new
        # params and moments are created while the old ones are held
        assert m["peak"] - m["argument"] >= D._local_bytes(args[0]) - 8


# ---------------------------------------------------------------------------
# DTensor: the local shard, not the global tensor
# ---------------------------------------------------------------------------

_SHARD = """
    import sys
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_local_mesh
    D.init_fake_group(4)
    mesh = make_local_mesh(data=4)
    x = distribute_tensor(torch.empty(64, 16, device="meta"), mesh,
                          [Shard(0), Shard(0)], src_data_rank=None)
    if sys.argv[1] == "gather":     # the local shard's all-gather
        x = x.to_local()
        step = lambda t: fc.all_gather_tensor(t, 0, dist.group.WORLD)
    else:
        step = lambda t: t * 2
    arg = D._local_bytes(x)
    out, count, mem = D._traced(step, (x,), arg, grad=False)
    print(arg, count.high, count.bytes_accessed, mem["peak"], mem["temp"],
          D._local_bytes(out))
"""


@pytest.mark.parametrize("op,want", [
    # rank 0 holds [16, 16] (1,024 bytes); x * 2 creates, reads and
    # writes 1,024 bytes each, not the global 4,096
    ("mul", [1024, 1024, 2048, 2048, 0, 1024]),
    # the all-gather reads 1,024 and creates 4,096 once: its wrapper
    # (a new tensor on meta, the input itself on the card) takes over
    # its bytes and moves none
    ("gather", [1024, 4096, 5120, 5120, 0, 4096]),
])
def test_dtensor_op_counts_the_local_shard(op, want):
    """A DTensor op's local shard on a 4-rank fake group, and a
    functional collective's output counted once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_SHARD), op],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert [int(v) for v in r.stdout.split()[-6:]] == want
