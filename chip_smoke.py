#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

On a host with several cards, ``python3 chip_smoke.py --shard-only``
builds the kernels and runs phase 4b alone (with the unsharded gossip
sim it is held to), its shards of s <= the card count on distinct cards.
``python3 chip_smoke.py --model-only`` builds them and runs phase 10
alone, ``--train-only`` phase 11 alone, ``--moe-only`` phase 12 alone,
``--ssm-only`` phase 13 alone, ``--encdec-only`` phase 14 alone,
``--mesh-only`` phase 15 alone.

Phases, each of which raises (and so exits non-zero) on any failure:

1. the card: ``nvidia-smi`` name and power limit, torch's device name
   and count;
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel);
3. each kernel against its plain PyTorch version on the card, at the
   paths' shapes and at ragged and near-wrap ones: integers, flags and
   violation counts identical, Eq. 3 fp within a relative 5e-2;
   merge_compare, one-vs-many and hybrid also at one row, at more rows
   than the grid has warps and on rows one element into their buffers,
   their flags ``torch.bool``;
4. the main path at full size: a ``ClockRuntime`` (m=1024, k=4) ticks,
   65,536 peers are admitted to a registry in batches of 4096,
   ``classify_fleet``, ``lineage``/``admit_merge`` and three loopback
   ``gossip`` rounds — once on the card with the launch counts reset
   just before and read just after, once on the CPU (plain versions);
   verdicts, clocks, registry rows and wire bytes must be identical,
   fp within tolerance; then ``run_gossip_sim`` on both devices must
   report fn == 0 and the same verdict counts;
4b. the mesh-sharded registry (``[shard]`` lines): the main path's
   65,536 peers over 1, 2, 4 and 8 row shards (``make_fleet_mesh``,
   on distinct cards where there are that many, else on the one card),
   each held bit for bit to the unsharded card registry (``classify_all``
   with its launches counted, one loopback gossip round), their times;
   one round over ``MeshCollectiveTransport`` at 4 shards, held to the
   same loopback round; ``fleet_health`` at 2,048 slots over 4 shards
   under the ring and the replicated strategy, and the CPU ring; the bare
   sharded all-pairs op at 16,384 x 1,024 over 1, 2, 4 and 8 shards
   under both strategies (the ring's launches, results identical to the
   unsharded tri, device ms); 4,096 peers over 4 shards on the card and
   on the CPU, which must agree; the gossip sim over 8 shards on the
   loopback and the mesh transport, fn == 0 with the unsharded run's
   counts;
4c. multi-host gossip (``[socket]`` lines), the README's socket
   deployment (m=1024, k=4): (a) 256 ``ClockPeerServer``s on 127.0.0.1
   (prefixes, forks, stragglers, descendants, 4 rows past the int32
   wrap) and a leader registry of capacity 256, three sessions over
   ``SocketTransport`` (round 0 pulls every frame, round 1 none, round
   2 the 64 peers that ticked, after 16 ticks of the leader's own) on
   the card with the launch counts reset just before and read just
   after (tick, packed one-vs-many and the i32 overlay must have run),
   then on the CPU: masks, statuses, merged cells, registry rows, bytes
   and ``have`` keys identical, fp within tolerance, each session's
   host-clock ms split by its ``gossip.*`` spans; (b) ``python -m
   repro_torch.launch.peers --smoke 8`` (the leader on the card, 7
   child processes on the CPU) must exit 0; (c) ``python -m
   repro_torch.fleet.chaos --smoke`` with the registry on the card must
   exit 0, and the chaos sim over 64 nodes (the smoke's fault mix, a
   corrupted row) on the card and the CPU must report fn == 0,
   convergence and a repair, with the same fault schedule and results;
5. the all-pairs path: ``fleet_health`` over a 16,384-slot registry
   (~1% evicted, 8 promoted rows) with the launch counts reset just
   before and read just after (tri and rect-i32 must have run), its
   time split into the all-pairs call, the transfer and host work, and
   once more under the profiler; then ``CausalEngine.pairs`` with the
   tri, full and mxu engines and the i32 kernel (``pack=False``) on a
   fully alive 16,384 slab of window span <= 64, which must give
   identical flags and row sums; then ``fleet_health`` at 2,048 slots
   on the card and on the CPU, which must agree;
6. the hybrid path: a ``HybridEngine`` (m=1024, k=4, fp budget 1e-4)
   admits 4,088 tiny head sessions and 65,540 tail sessions (4 of them
   wide), promotes the head with Zipf churn and head sweeps, classifies
   through the fused hybrid kernel, then folds once to m=512 under an
   ``AdaptivePolicy`` and replays the fold from its audit trail — once
   on the card with the launch counts reset just before and read just
   after, once on the CPU; fn == 0, measured hot fp == 0, tail rows
   bit-identical to a flat packed slab, and the two runs agree; then
   ``HybridEngine.pairs`` at 16,384 sessions on the card (exact hot-hot
   block) and at 2,048 on the card and the CPU, which must agree;
7. the autotuner (``repro_torch.kernels.autotune``): (a) for every
   kernel instance the occupancy formula of ``kernels.template`` equal
   to ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` and its shared
   memory copy equal to the libraries' exports; (b) the measured sweep
   at the paths' shapes (``autotune.DEFAULT_SIZES``) into a temporary
   table, one ``[autotune]`` line each (winner, its time, the default
   blocks' time, the model's rank of the winner, survivors of the
   grid); (c) at each winner's blocks the kernel against its plain
   version (flags identical, sums bit-identical, fp within tolerance)
   and against the default blocks (flags identical; sums and fp
   bit-identical at equal bm); (d) one ``[dispatch]`` line for the
   engine and blocks each path resolves from the committed table;
8. the serving path (``repro_torch.serve``) at ``ChurnConfig()``'s
   defaults (m = 256, k = 4; the churn cut to 125,000 sessions over 8
   steps, ``SERVE_CHURN``): the tick at the mint's B = 3,906 x 3
   events and the replica's B = 1 x 4, packed one-vs-many at N = 256,
   4,096, 16,384 and 65,536 and a batch with wide rows through the i32
   overlay, each against its plain version; the churn (125,000
   sessions over 8 steps through ``AdmissionPipeline`` into a
   ``TieredRegistry``) on the card with the launch counts reset just
   before and read just after (tick and packed one-vs-many must have
   run), fn == 0 and a non-empty cold tier, its latencies, qps, tier
   movement and span split (``[serve]`` lines); ``TieredRegistry
   .classify`` over the whole surviving population bit-identical to a
   flat card slab of the same clocks; the audited quick churn on the
   card and the CPU (deterministic fields and the stored clocks' CRC
   identical, audit replay clean on both); one churn step under the
   profiler (idle share); the tick and one-vs-many timed at the
   serving shapes (``[time] serve`` lines, after phase 9's);
9. times by one rule for kernels, plain versions and library calls:
   CUDA events around a loop of calls queued behind a sleep kernel (the
   card's time, no host gaps), with rotating input buffers larger than
   the L2 cache where the inputs are small; beside them the least time
   the card needs, from bytes and from instruction counts (the lower of
   each function's minimum and the built kernel's hot loop, read from
   ``cuobjdump -sass`` with the lanes each 32-bit word holds: 2 for
   the 16-bit lanes of tri, rect-u8 and mxu, 1 for rect-i32; the
   one-vs-many stage loop and merge_compare's vector loop are read as
   instructions per cell, ``[sass]`` lines).  The tick
   at the batched B=4096, P=64 (the record) and the main path's B=1,
   P=4, each against in-place ``scatter_add_`` and out-of-place
   ``torch.scatter_add``; merge_compare at B=4096 (the record) and the
   main path's B=1; mxu against the bf16 thermometer ``torch.mm`` and
   the int8 ``torch._int_mm``, and once more above ``MXU_T_MAX`` (its
   32-bit-lane kernel at N = M = 4096, T = 8192); a record's library
   time is the faster call; rect-i32 once more on slabs that fit in L2
   (time per pair and lane);
10. model serving (``[model]`` lines): (a) ``launch.serve``'s defaults
    (batch 4, prompt 32, 16 generated tokens, fp gate 1e-4) at
    Qwen1.5-0.5B's full config (24 layers, d 1,024, V 151,936, tied;
    463,987,712 float32 masters, bfloat16 compute), weights random from
    the seed: a ``ServingEngine`` admits the prompts and generates, and
    (c) a second engine that merged its clock adopts the session while a
    third with its own history refuses it, with the launch counts reset
    just before and read just after (tick, merge_compare and i32
    one-vs-many must have run); prefill ms, generate ms, tok/s, the bare
    model's decode step (host clock to a synchronise, median over steps
    2-16) beside its bound (the compute-dtype weights' bytes over the
    memory rate), one decode step under the profiler (idle share, device
    events), peak memory; ``python -m repro_torch.launch.serve`` in a
    child process must exit 0; (b) the full widths at 2 layers on the
    card and the CPU from the same weights and prompts: clocks,
    registry rows and ``adopt_many`` masks identical, logits within
    ``LOGIT_ATOL + LOGIT_RTOL |x|``, greedy tokens identical outside
    near ties, fp within 5e-2;
11. training (``[train]`` lines): (a) ``launch.train.train_loop`` at
    the launcher's defaults (batch 8, seq 128, lr 3e-3, float32 AdamW
    moments) at Qwen1.5-0.5B's full config, weights random from the
    seed: 12 steps, an asynchronous checkpoint every 4 into a temporary
    directory, a failure injected at step 8 and the restart (step 8
    restored as a descendant, admitted), then ``admit_restore_latest``
    over the directory (it must name step 12), with the launch counts
    reset just before and read just after (tick, merge_compare and i32
    one-vs-many must have run); losses finite and falling, ``clock_sum``
    k x the steps taken; the step (host clock to a synchronise, median
    of the timed steps after the first) beside its least times (6 N D
    FLOPs at the bfloat16 rate, AdamW's bytes at the memory rate),
    tokens/s, one step under the profiler, peak memory, one
    checkpoint's host snapshot and write; ``python -m
    repro_torch.launch.train --steps 2`` in a child process must exit 0
    having run its steps (``TRAIN_CHILD_ARGS``); (b) the full widths at 2
    layers, batch 2, seq 32, 2 steps on the card and the CPU from one
    state: clock cells identical, losses and grad norms within 2e-2,
    params within the most two AdamW runs can part, checkpoint keys,
    shapes and dtypes identical, the card's checkpoint restored into
    the CPU's state; (c) the async coordinator (4 pods, 2 local SGD
    steps, 2 rounds, pod 2 restored from its pre-commit clock) at the
    full config on the card (pods 0, 1, 3 merged, pod 2 forked; tick
    and packed one-vs-many launched; ``outer_step`` ms; its card-vs-CPU
    comparison is cut for the script's time limit: the ``gpu`` case
    ``test_cuda_async_coordinator_matches_cpu`` holds it at the smoke
    config);
12. the MoE family (``[moe]`` lines): (a) grok-1 and DeepSeek-V2 at
    their full widths, depth cut to ``MOE_SERVE_LAYERS`` = 4 (weights
    random from the seed, built unstacked), one after the other, each
    serving ``launch.serve``'s defaults as phase 10 (a) and (c) do
    (tick, merge_compare and i32 one-vs-many must have run): admit and
    generate ms, tok/s, the bare decode step beside its weight-read
    bound (every expert's weights, each expert holding one slot), one
    decode step under the profiler, peak memory, the share of slots
    capacity dropped; ``python -m repro_torch.launch.serve --arch <each>
    --smoke`` in a child process must exit 0; (b) ``make_train_step``
    at the full widths, depth 1, bfloat16 masters and int8 moments,
    ``launch.train``'s batch 8 and seq 128, 4 steps (grok with its
    expert width cut to 16,384: ``MOE_TRAIN_CUTS``): step ms, tokens/s,
    loss and aux a step, peak memory, one step under the profiler, one
    tick a step; (c) both configs at the full widths and depth 1 on the
    card and the CPU (``model_run`` with 4 tokens, routes logged by
    forward hooks): clocks, registry rows and masks identical, the share
    of tokens whose experts differ printed, logits and greedy tokens
    held on the rows whose routes agree so far (the DeepSeek-V2 train
    step card vs CPU is cut for the script's time limit; the ``gpu``
    tests hold the MoE train step card vs CPU at the smoke config);
13. the SSM and hybrid families (``[ssm]`` lines): (a) mamba2-130m and
    hymba-1.5b at their full configs, nothing cut (weights random from
    the seed), each serving ``launch.serve``'s defaults as phase 10 (a)
    and (c) do: admit and generate ms, tok/s, the bare decode step
    beside its bound (weights, the SSM caches read and written, the
    K/V), one decode step under the profiler, peak memory; ``python -m
    repro_torch.launch.serve --arch <each> --smoke`` in a child process
    must exit 0; (b) ``make_train_step`` at each full config,
    ``launch.train``'s batch 8, seq 128 (the configs' SSD chunk), lr
    3e-3, float32 AdamW, 4 steps: every loss and grad norm finite, step
    ms beside its FLOP and AdamW-byte least times, tokens/s, peak
    memory, one step under the profiler, one tick a step; (c) both at
    the full widths and depth 2 on the card and the CPU (``model_run``
    with 4 tokens): clocks, registry rows and masks identical, logits
    and the SSM caches within tolerance, greedy tokens identical outside
    near ties; one train step at batch 2, seq 128 held to the AdamW
    bound;
14. the enc-dec family (``[encdec]`` lines): (a) whisper-large-v3 at
    its full config, nothing cut (weights random from the seed), serving
    ``launch.serve``'s batch, prompt and tokens with frames [4, 1,500,
    1,280] from a seeded CPU generator, through the functional entry
    points (the engine passes no frames, as the reference's does not):
    encode ms, prefill ms, the bare decode step beside its bound (the
    decoder's weights but the cross K/V projections, the cross K/V, the
    self K/V), tok/s, one decode step under the profiler, peak memory;
    (b) ``make_train_step`` at the full config, seq 128, lr 3e-3,
    float32 AdamW, 4 steps, at the largest batch of 8, 4, 2, 1 whose
    first step stays under 76 GB (the encoder keeps its activations, as
    the reference's does): every loss and grad norm finite, one tick a
    step with the launch counts reset just before and read just after,
    step ms beside its FLOP and AdamW-byte least times, tokens/s, peak
    memory, one step under the profiler; (c) the full widths at depth 1
    (decoder and encoder), full-length frames, on the card and the CPU:
    prefill and 4 decode steps (logits and the cross and self K/V within
    tolerance, greedy tokens identical outside near ties), one train
    step held to the AdamW bound;
15. the model mesh (``[mesh]`` lines): a one-rank NCCL process group
    in the script's own process (an in-memory store, no network) and
    the (1, 1) ``make_local_mesh``; Qwen1.5-0.5B's full config with
    DTensor parameters placed by ``param_pspecs`` serves ``launch.serve``'s
    prompts (prefill and 16 greedy decode steps) and takes 2 train steps
    at ``launch.train``'s defaults from a state placed by
    ``state_shardings``, each against the plain path on the same card
    from the same weights: greedy tokens identical, logits, losses,
    grad norms, clock cells, params and moments bit-identical (an op
    that DTensor rewrites is named and held to the bfloat16 tolerance),
    one tick a train step with the launch counts reset just before and
    read just after; the DTensor decode and train steps beside the
    plain ones, one DTensor decode step under the profiler; the group is
    torn down after;
16. one JSON line of kernel records (the three serving kernels also
    carry their launches on the serving path, the four training
    kernels theirs on the training path, tick, merge_compare and i32
    one-vs-many theirs on the MoE and the SSM phases, tick its ticks on
    the enc-dec path and on the mesh path), the card line, then the
    verdict line.

In the full run the launchers' child processes of 4c (c), 10, 11, 12
and 13 run side by side after phase 10 (``CHILDREN_BATCHED``); a phase
run alone starts its own.

Every card-vs-CPU comparison gives the CPU run the blocks the card
resolves (``card_blocks``): the committed table's ``cuda`` entries under
``cpu`` keys in a temporary table.

No JAX and nothing of the JAX package is imported.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

FP_RTOL = 5e-2      # Eq. 3 across math libraries (see ROADMAP queue 3)
FP_FLOOR = 1e-30    # the Eq. 3 clip: values at or below it are all "zero"
M, K = 1024, 4
N_PEERS, BATCH = 65536, 4096
# all-pairs: fleet_health materialises [N, N] flag and fp matrices and
# copies them to the host (~7 bytes a pair), so its slab is cut to 16,384
# slots; the card-vs-CPU comparison runs at 2,048 to keep the CPU short
N_SLOTS, N_SLOTS_CPU = 16384, 2048
# the sharded fleet: the main path's registry over these shard counts;
# its card-vs-CPU comparison at 4,096 peers
SHARD_COUNTS = (1, 2, 4, 8)
N_SHARD_CPU = 4096
#: the mesh transport's round at the main path's 65,536 peers
MESH_TRANSPORT_SHARDS = 4
SEED = 0
#: kernels of the main path (phase 4) and of the all-pairs paths (phase 5)
MAIN_KERNELS = ("bloom_tick", "bloom_merge_compare", "one_vs_many_packed",
                "one_vs_many_i32")
HEALTH_KERNELS = ("matrix_tri", "matrix_rect_i32")
#: kernels of the hybrid path (phase 6): the fused sweep, and the exact
#: int32 overlay of the wide tail rows
HYBRID_KERNELS = ("hybrid", "one_vs_many_i32")
ENGINE_KERNELS = ("matrix_tri", "matrix_rect_u8", "matrix_mxu",
                  "matrix_rect_i32")
L2_BYTES = 50e6
#: T of the wide-T mxu timing, the first past the 16-bit-lane kernel's
#: MXU_T_MAX (8,191)
MXU_WIDE_T = 8192
#: rows and cols of the rect-i32 run whose int32 slabs fit in L2 together
L2_ROWS = (66 * 64, 64 * 64)

# data-sheet HBM rates (bytes/s), by the card's name
_HBM = (("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H200", 4.8e12),
        ("H100", 3.35e12))
# instructions/s outside the tensor cores: an SM issues at most 4 warp
# instructions (128 lanes) a clock, 132 SMs at 1.98 GHz boost (the
# guide's 67 TFLOP/s float32 with one FMA counted once).  No mix of
# instructions issues faster, whichever pipe runs them, so ops / INT_OPS
# is a time no kernel can beat.
INT_OPS = 128 * 132 * 1.98e9
# dense int8 tensor-core operations/s (the guide's table)
INT8_OPS = 1979e12
#: fewest instructions per (pair, lane) the all-pairs functions need on
#: sm_90: u8 flags keep a running max and min of a difference that fits
#: 16 bits, two lanes a word: one add of biased words per two lanes and
#: one three-input max and min per four; int32 wrap differences do not
#: pack, a subtraction per lane and a three-input max and min per two;
#: the violation count takes one add-relu per two lanes and one
#: three-input add of two packed 16-bit counts per four.
#: These count issue slots; the integer ALU pipe, which runs the DPX and
#: IADD3 instructions, takes half the issue rate (PERF.md §3).
#: The bound uses the lower of this and the built kernel's count (SASS).
MIN_OPS = {"matrix_tri": 1.0, "matrix_rect_u8": 1.0, "matrix_rect_i32": 2.0,
           "matrix_mxu": 0.75}



def mxu_wide_min_ops(T: int) -> float:
    """``MIN_OPS`` for mxu above ``MXU_T_MAX``, where a count can pass 16
    bits within a chunk: while T <= 32,766 the clamped values (a in
    [-1, T], b in [0, T + 1]) and every a - b fit signed 16-bit halves, so
    one add-relu and one dp2a into a 32-bit count take two lanes, 1 a
    pair and lane; past that a lane takes a word, a subtraction with relu
    and an add: 2."""
    return 1.0 if T <= 32766 else 2.0
#: kernel symbol in the SASS of each all-pairs record (for the tiled
#: templates the default 64 x 64 instance, tri the TRI instance of
#: rect-u8's; for rect-i32 its 16-byte staging), and the m lanes a 32-bit
#: word of its staged tiles holds: 2 for the packed 16-bit lanes of tri,
#: rect-u8 and mxu
_SASS_KERNELS = {"matrix_tri": ("rect_u8_u16x2_kernelILi64ELi64ELb1E", 2),
                 "matrix_rect_u8": ("rect_u8_u16x2_kernelILi64ELi64ELb0E", 2),
                 "matrix_rect_i32": ("rect_i32_kernelILi64ELi64ELb1E", 1),
                 "matrix_mxu": ("mxu_viol_s16x2_kernelILi64ELi64E", 2)}
# the hybrid path (phase 6): the bench generator of
# benchmarks/bench_hybrid.py:76-96 scaled to the serving tiers' defaults
# (hot tier 4,096 sessions, warm tier 65,536: src/repro/serve/churn.py:72-73)
# with its FULL chain length V = 384; hot capacity is the head plus the
# bench's margin of 8; the launcher's fp budget (src/repro/launch/serve.py:53)
HYB_V, HYB_HEAD, HYB_TAIL, HYB_WIDE = 384, 4088, 65536, 4
HYB_TAIL_V_MIN, HYB_MARGIN, HYB_BUDGET = 64, 8, 1e-4
HYB_DRAWS, HYB_ROUNDS = 2048, 6
# HybridEngine.pairs materialises [N, N] matrices: 16,384 sessions on the
# card (256 in the head), 2,048 (32 in the head) on the card and the CPU
HYB_PAIRS = ((16384, 256), (2048, 32))
#: bytes each row of merge_compare, one-vs-many and hybrid writes: two
#: bool flags, two float32 sums, two float32 fp
ROW_OUT_BYTES = 2 + 8 + 8
# sleep ahead of a timed loop: ~50 ms at boost clock, longer than the
# host takes to queue the loop, so the card never waits on the host
SLEEP_CYCLES = 100_000_000


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _fp_pair(x, y):
    """(x, y, array module) in float64: torch tensors stay on their
    device (a [16,384, 16,384] pair is compared there), anything else
    becomes numpy."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor) \
            and isinstance(y, torch.Tensor):
        return (x.to(torch.float64), y.to(device=x.device, dtype=torch.float64),
                torch)
    return np.asarray(x, np.float64), np.asarray(y, np.float64), np


def _max0(a) -> float:
    """The largest element of an array or tensor, 0.0 when it is empty."""
    n = a.numel() if hasattr(a, "numel") else a.size
    return float(a.max()) if n else 0.0


def fp_max_rel(x, y) -> float:
    """Largest relative gap between two fp arrays: 0 where they are
    equal (wrapped negative sums give inf on both sides), where both are
    NaN, or where both are at or below the Eq. 3 clip floor."""
    x, y, xp = _fp_pair(x, y)
    same = (x == y) | (xp.isnan(x) & xp.isnan(y))
    both_tiny = (xp.abs(x) <= FP_FLOOR) & (xp.abs(y) <= FP_FLOOR)
    with np.errstate(invalid="ignore"):
        den = xp.maximum(xp.maximum(xp.abs(x), xp.abs(y)),
                         xp.full_like(x, 1e-300))
        rel = xp.where(same | both_tiny, xp.zeros_like(x), xp.abs(x - y) / den)
    rel = xp.where(xp.isnan(rel), xp.full_like(rel, np.inf), rel)
    return _max0(rel)


def check_fp(x, y, what: str) -> float:
    rel = fp_max_rel(x, y)
    check(rel <= FP_RTOL, f"{what}: fp relative gap {rel:.3g} > {FP_RTOL}")
    x, y, xp = _fp_pair(x, y)
    finite = xp.isfinite(x) & xp.isfinite(y)
    return _max0(xp.abs(x[finite] - y[finite]))


def check_equal(x, y, what: str) -> None:
    x, y = np.asarray(x), np.asarray(y)
    check(x.shape == y.shape and np.array_equal(x, y),
          f"{what}: not identical")


def host(t):
    return t.cpu().numpy()


@contextlib.contextmanager
def card_blocks():
    """Within it, CPU calls resolve the blocks and engines the card
    resolves: the committed autotune table with each ``cuda`` entry
    copied under its ``cpu`` key, in a temporary table."""
    from repro_torch.kernels import autotune

    table = dict(autotune.load_table())
    table.update({k.replace("|cuda|", "|cpu|"): v for k, v in table.items()
                  if "|cuda|" in k})
    old = os.environ.get("REPRO_TORCH_AUTOTUNE_TABLE")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "autotune_table.json")
        with open(path, "w") as f:
            json.dump(table, f)
        os.environ["REPRO_TORCH_AUTOTUNE_TABLE"] = path
        try:
            yield
        finally:
            if old is None:
                del os.environ["REPRO_TORCH_AUTOTUNE_TABLE"]
            else:
                os.environ["REPRO_TORCH_AUTOTUNE_TABLE"] = old


def on(device: str):
    """``card_blocks()`` for the CPU, nothing for the card."""
    return card_blocks() if device == "cpu" else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# phase 1-2: card and build
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key, rate in _HBM:
        if key in name:
            return rate
    raise SmokeFailure(f"no data-sheet memory rate known for {name!r}")


def build() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
        log = paths[name].parent / f"{name}.log"
        if log.exists():
            print(f"[build] {name}: {log.read_text().strip()}")
    return time.perf_counter() - t0


_SASS_FN = re.compile(r"Function : (\S+)")
_SASS_INS = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_hot_loop(text: str, symbol: str, lanes_per_word: int = 1) -> dict:
    """Instructions per (pair, lane) in the hot loop of ``symbol`` in
    ``cuobjdump -sass`` output: the innermost backward-branch loop with
    the most 16-byte shared loads, where 8 of them (4 words of 4 rows and
    4 cols) feed 4 words x 16 pairs, that is 4 x ``lanes_per_word`` lanes
    x 16 pairs.  ``issue`` counts every instruction, ``alu`` all but the
    shared loads and the branch."""
    parts = _SASS_FN.split(text)
    for name, body in zip(parts[1::2], parts[2::2]):
        if symbol not in name:
            continue
        found = _SASS_INS.findall(body)
        ins = [(int(a, 16), op) for a, op, _ in found]
        loops = []
        for a, op, rest in found:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and target and int(target.group(1), 16) < int(a, 16):
                loops.append((int(target.group(1), 16), int(a, 16)))
        best = None
        for lo, hi in loops:
            if any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi) for l2, h2 in loops):
                continue                      # not innermost
            ops = [op for a, op in ins if lo <= a <= hi]
            n_lds = ops.count("LDS.128")
            if n_lds and (best is None or n_lds > best.count("LDS.128")):
                best = ops
        check(best is not None, f"sass: no shared-load loop in {symbol}")
        pairs = best.count("LDS.128") / 8 * 64 * lanes_per_word
        hist: dict = {}
        for op in best:
            hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
        alu = sum(1 for op in best if not op.startswith(("LDS", "BRA")))
        return {"issue": len(best) / pairs, "alu": alu / pairs,
                "per_pair": {k: v / pairs for k, v in
                             sorted(hist.items(), key=lambda kv: -kv[1])}}
    raise SmokeFailure(f"sass: no function {symbol}")


#: one-vs-many and merge_compare records whose row loop ``[sass]`` reads:
#: library, kernel symbol, ops the loop must hold (a prefix and a
#: substring each: the cp.async copy and three-input min of the stage
#: loop, the 16-byte loads of merge_compare's vector loop), cells a lane
#: takes per iteration (``ops.OVM_CHUNKS_PER_LANE`` 16-byte chunks; 8
#: int4 of each row)
_SASS_ROWS = {
    "one_vs_many_packed": ("one_vs_many", "ovm_kernelIhLb1E",
                           (("LDGSTS", ""), ("VIMNMX3", "")), 16),
    "one_vs_many_i32": ("one_vs_many", "ovm_kernelIiLb0E",
                        (("LDGSTS", ""), ("VIMNMX3", "")), 4),
    "bloom_merge_compare": ("bloom_compare", "merge_compare_kernel",
                            (("LDG", "128"), ("STG", "128")), 32),
}


def sass_row_loop(text: str, symbol: str, need, cells: int) -> dict:
    """Instructions per cell in the row loop of ``symbol``: the smallest
    backward-branch loop holding every op of ``need``, each instruction
    counted once per ``cells`` cells.  The count is static: it includes
    the loop's once-a-row code (tile closing, flag votes) at full weight,
    so it bounds the instructions a cell from above."""
    parts = _SASS_FN.split(text)
    for name, body in zip(parts[1::2], parts[2::2]):
        if symbol not in name:
            continue
        found = _SASS_INS.findall(body)
        ins = [(int(a, 16), op) for a, op, _ in found]
        best = None
        for a, op, rest in found:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if not (op.startswith("BRA") and target and int(target.group(1), 16) < int(a, 16)):
                continue
            lo, hi = int(target.group(1), 16), int(a, 16)
            ops = [o for x, o in ins if lo <= x <= hi]
            if all(any(o.startswith(p) and sub in o for o in ops) for p, sub in need):
                if best is None or len(ops) < len(best):
                    best = ops
        check(best is not None, f"sass: no row loop in {symbol}")
        hist: dict = {}
        for op in best:
            hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
        alu = sum(v for k, v in hist.items() if k in _ALU_OPS)
        return {"issue": len(best) / cells, "alu": alu / cells, "loop_instructions": len(best),
                "cells_per_iteration": cells,
                "per_cell": {k: v / cells for k, v in sorted(hist.items(), key=lambda kv: -kv[1])}}
    raise SmokeFailure(f"sass: no function {symbol}")


#: SASS ops on the integer ALU pipe, which takes half the issue rate
_ALU_OPS = {"IADD3", "VIADD", "LOP3", "PRMT", "SHF", "SEL", "ISETP", "VIMNMX", "VIMNMX3",
            "IMNMX", "LEA", "P2R", "R2P", "FSEL", "PLOP3"}


def sass_counts() -> dict:
    """``sass_hot_loop`` of each all-pairs kernel in the built libraries
    (``cuobjdump`` of the toolkit that built them)."""
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    paths = _build.build_all()
    text = {lib: subprocess.run([cuobjdump, "-sass", str(paths[lib])],
                                capture_output=True, text=True, check=True,
                                timeout=120).stdout
            for lib in ("bloom_matrix", "bloom_mxu", "one_vs_many", "bloom_compare")}
    out = {rec: dict(sass_hot_loop(text["bloom_mxu" if "mxu" in rec else "bloom_matrix"],
                                   sym, lanes), lanes_per_word=lanes)
           for rec, (sym, lanes) in _SASS_KERNELS.items()}
    from repro_torch.kernels import ops
    for rec, (lib, sym, need, cells) in _SASS_ROWS.items():
        if lib == "one_vs_many":
            cells *= ops.OVM_CHUNKS_PER_LANE
        out[rec] = sass_row_loop(text[lib], sym, need, cells)
    return out


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def compare_ovm(name, classify, q, peers, base, bm: int = 512) -> float:
    """``classify(peers, base)`` against the plain version at the m-tile
    ``bm`` the classify resolves, on the rows as given and once more one
    element into their buffers (scalar loads)."""
    import torch
    from repro_torch.kernels import ops, ref

    m = q.shape[0]
    flags, sums, fp = ref.one_vs_many_ref(q, peers, base,
                                          bm=ops.tile_width(m, bm))
    e = 0.0
    shifted = (offset_view(peers, 1),
               None if base is None else offset_view(base, 1))
    for p, b in ((peers, base), shifted):
        out = classify(p, b)
        what = f"{name} ptr%16={p.data_ptr() % 16}"
        check(out["q_le_p"].dtype == torch.bool, f"{what}: flags not bool")
        check_equal(host(out["q_le_p"]), host(flags[:, 0]), what)
        check_equal(host(out["p_le_q"]), host(flags[:, 1]), what)
        check_equal(host(out["sum_p"]), host(sums[:, 1]), what + " sum_p")
        check_equal(host(out["sum_q"]), host(sums[0, 0]), what + " sum_q")
        e = max(e, check_fp(out["fp_q_before_p"], fp[:, 0], what),
                check_fp(out["fp_p_before_q"], fp[:, 1], what))
    return e


def check_kernels(dev) -> dict:
    """Returns name -> largest absolute error seen against the plain
    version (0 for integer outputs, which must be identical)."""
    import torch
    from repro_torch.core.hashing import bloom_indices
    from repro_torch.kernels import ops, ref

    g = np.random.default_rng(SEED)
    err = {"bloom_tick": 0.0, "bloom_merge_compare": 0.0,
           "one_vs_many_packed": 0.0, "one_vs_many_i32": 0.0}

    # tick: main shape, ragged m, 16-bit cells, cells at the wrap point
    for B, m, dtype, hi_val in ((4096, 1024, torch.int32, 1000),
                                (4096, 1000, torch.int32, 1000),
                                (512, 1024, torch.int16, 30000)):
        cells = torch.as_tensor(g.integers(0, hi_val, (B, m)), dtype=dtype,
                                device=dev)
        cells[0, :] = torch.iinfo(dtype).max
        ev = g.integers(0, 2 ** 32, (2, B, 16), dtype=np.uint64).astype(np.int64)
        probes = bloom_indices(ev[0], ev[1], K, m, device=dev)
        probes = probes.reshape(B, -1).to(torch.int32).contiguous()
        got = ops.tick_probes(cells, probes)
        want = ref.bloom_tick_ref(cells, probes)
        torch.cuda.synchronize()
        check_equal(host(got), host(want), f"tick B={B} m={m} {dtype}")
    # ragged: one row, more rows than the grid has warps, rows that are
    # not 16-byte aligned (scalar cells), 16-bit cells wrapping, probes
    # at -1 and m that hit nothing, and up to 1000 probes a row
    for B, m, dtype, P in ((1, 1024, torch.int32, 4), (3, 1001, torch.int16, 1000),
                           (4101, 1001, torch.int32, 64), (4101, 7, torch.int16, 4),
                           (3, 7, torch.int32, 1000), (4101, 1000, torch.int16, 64)):
        info = torch.iinfo(dtype)
        cells = torch.as_tensor(g.integers(info.max - 300, info.max + 1, (B, m)),
                                dtype=dtype, device=dev)
        probes = torch.as_tensor(g.integers(-1, m + 1, (B, P)), dtype=torch.int32,
                                 device=dev)
        got = ops.tick_probes(cells, probes)
        want = ref.bloom_tick_ref(cells, probes)
        torch.cuda.synchronize()
        check_equal(host(got), host(want), f"tick B={B} m={m} P={P} {dtype}")
    print("[kernels] tick: identical to the plain version")

    # merge_compare: the record's B = 4096 and the receive path's B = 1,
    # B = 2 and more rows than the grid has CTAs (4101), ragged m (1000:
    # 16-byte rows; 7: scalar cells), rows near INT32_MAX; every case
    # once more from buffers one cell in (scalar cells)
    cases = []
    for B, m in ((4096, 1024), (4096, 1000), (1, 1024), (2, 1000), (4101, 7)):
        a = g.integers(0, 400, (B, m))
        b = a + g.integers(0, 2, (B, m)) * (g.random((B, 1)) < 0.5)
        b[::3] = g.integers(0, 400, (len(b[::3]), m))
        cases.append((a, b))
    a = 2 ** 31 - 1 - g.integers(0, 1000, (64, 1024))
    cases.append((a, np.minimum(a + g.integers(0, 3, a.shape), 2 ** 31 - 1)))
    for a_np, b_np in cases:
        B, m = a_np.shape
        a = torch.as_tensor(a_np, dtype=torch.int32, device=dev)
        b = torch.as_tensor(b_np, dtype=torch.int32, device=dev)
        merged, flags, sums, fp = ref.bloom_merge_compare_ref(
            a, b, bm=ops.tile_width(m, 512))
        for xa, xb in ((a, b), (offset_view(a, 1), offset_view(b, 1))):
            got = ops.merge_compare(xa, xb)
            what = f"merge_compare B={B} m={m} ptr%16={xa.data_ptr() % 16}"
            check(got["a_le_b"].dtype == torch.bool, f"{what}: flags not bool")
            check_equal(host(got["merged"]), host(merged), f"{what}: merged")
            check_equal(host(got["a_le_b"]), host(flags[:, 0]), f"{what}: a_le_b")
            check_equal(host(got["b_le_a"]), host(flags[:, 1]), f"{what}: b_le_a")
            check_equal(host(got["sum_a"]), host(sums[:, 0]), f"{what}: sum_a")
            check_equal(host(got["sum_b"]), host(sums[:, 1]), f"{what}: sum_b")
            err["bloom_merge_compare"] = max(
                err["bloom_merge_compare"],
                check_fp(got["fp_a_before_b"], fp[:, 0], what),
                check_fp(got["fp_b_before_a"], fp[:, 1], what))
    print("[kernels] merge_compare: identical, fp within tolerance, flags "
          "torch.bool")

    # packed: N=65,536 at m=1024 with random bases, then one row, 7 rows
    # and more rows than the grid has warps (65,539), ragged shapes, and
    # m-tiles that end inside a chunk group (m = 640, 1920: bm = 128, 384)
    for N, m, wide in ((N_PEERS, M, False), (1, M, False), (7, 1000, False),
                       (N_PEERS + 3, M, False), (1000, 1000, False), (300, 1008, False),
                       (77, 520, False), (5, 7, False), (200, 640, False),
                       (100, 1920, False), (2000, M, True), (100, 1920, True)):
        q_res = g.integers(0, 200, m)
        if wide:  # a query span past 16 bits
            q_res[::5] += 70000
        q = torch.as_tensor(q_res + 5000, dtype=torch.int32, device=dev)
        delta = g.integers(-1, 2, (N, m)) * (g.random((N, m)) < 0.05)
        kind = g.integers(0, 3, (N, 1))
        res = np.where(kind == 0, q_res + np.abs(delta),
                       np.where(kind == 1, q_res - np.abs(delta),
                                g.integers(0, 256, (N, m))))
        res = np.clip(res, 0, 255)
        base = np.where(kind[:, 0] < 2, 5000, g.integers(-2 ** 31, 2 ** 31 - 256, N))
        peers = torch.as_tensor(res, dtype=torch.uint8, device=dev)
        base_t = torch.as_tensor(base, dtype=torch.int32, device=dev)
        bm = ops._one_vs_many_blocks(N, m, None, None, "cuda")[1]
        err["one_vs_many_packed"] = max(
            err["one_vs_many_packed"],
            compare_ovm(f"packed N={N} m={m} wide={wide}",
                        lambda p, b: ops._classify_vs_many_packed(q, p, b),
                        q, peers, base_t, bm))
    print("[kernels] one_vs_many packed: identical, fp within tolerance, "
          "flags torch.bool")

    # i32: N=256 at m=1024 across the int32 wrap point, the main path's 8
    # promoted rows, one row, 7 rows, more rows than the grid has warps,
    # then ragged
    for N, m in ((256, M), (8, M), (1, M), (7, 1000), (N_PEERS + 3, M),
                 (77, 1000), (5, 7)):
        q_np = 2 ** 31 - 1 - g.integers(0, 100, m)
        step = g.integers(0, 300, (N, 1)) * g.integers(-1, 2, (N, 1))
        noise = g.integers(-1, 2, (N, m)) * (g.random((N, m)) < 0.01)
        p_np = ((q_np + step + noise) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        q = torch.as_tensor(q_np.astype(np.int64), device=dev).to(torch.int32)
        peers = torch.as_tensor(p_np, device=dev)
        err["one_vs_many_i32"] = max(
            err["one_vs_many_i32"],
            compare_ovm(f"i32 N={N} m={m}",
                        lambda p, b: ops._classify_vs_many(q, p), q, peers, None))
    print("[kernels] one_vs_many i32: identical, fp within tolerance, flags "
          "torch.bool")
    return err


# bases of packed all-pairs rows: mostly one window, some a few steps off,
# some more than 256 off (the clipped delta decides), some at both ends
# of the int32 range (the delta is a wrap-subtraction)
_PAIR_BASES = np.array([5000] * 12 + [5001, 5003, 4800, 5300,
                                      -2 ** 31, 2 ** 31 - 100], np.int64)


def pair_inputs(g, n: int, m: int):
    """[n, m] u8 residuals around one window row (equal, ancestor,
    descendant, forked and unrelated rows) and [n] int32 bases."""
    local = g.integers(2, 200, m)
    kind = np.arange(n) % 5
    step = g.integers(-1, 2, (n, m)) * (g.random((n, m)) < 0.02)
    rows = np.repeat(local[None], n, axis=0)
    rows[kind == 1] += np.abs(step[kind == 1])
    rows[kind == 2] -= np.abs(step[kind == 2])
    rows[kind == 3] += step[kind == 3]
    rows[kind == 4] = g.integers(0, 256, ((kind == 4).sum(), m))
    base = g.choice(_PAIR_BASES, n)
    return rows.astype(np.uint8), base.astype(np.int32)


def mxu_inputs(g, n: int, mc: int, m: int, T: int, lo: int):
    """[n, m] and [mc, m] u8 with int32 bases around ``lo``: half in the
    window, the rest far below or above it, at the edges of the mxu
    kernel's [-257, T + 1] offset cut, or where u8 + base - lo wraps in
    int32; the first quarter of cols equal to rows."""
    far = np.array([-2 ** 30, -300, -258, -257, -256, -2, T + 1, T + 2, 300, 2 ** 30]
                   + [2 ** 31 - 1 - k for k in (0, 1, 100, 200, 254, 255, 256)], np.int64)

    def side(k):
        res = g.integers(0, T - 3, (k, m))
        res[1::2] = g.integers(0, 256, (len(res[1::2]), m))
        off = g.integers(0, 3, k).astype(np.int64)
        pick = g.random(k) < 0.5
        off[pick] = g.choice(far, int(pick.sum()))
        base = ((lo + off) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        return res.astype(np.uint8), base

    rows, rb = side(n)
    cols, cb = side(mc)
    k = min(n, mc) // 4
    cols[:k], cb[:k] = rows[:k], rb[:k]
    return rows, cols, rb, cb


def check_pair_kernels(dev) -> dict:
    """The four all-pairs kernels against their plain versions, at the
    slice's 16,384 x 1024 and at a ragged shape; returns name -> largest
    absolute fp error (flags, sums and violation counts must be
    identical)."""
    import torch
    from repro_torch.kernels import ops, ref

    g = np.random.default_rng(SEED + 4)
    err = dict.fromkeys(("matrix_tri", "matrix_rect_u8", "matrix_rect_i32",
                         "matrix_mxu"), 0.0)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    for N, Mc, m in ((N_SLOTS, N_SLOTS, M), (1000, 777, 640)):
        rows, rb = (t(x) for x in pair_inputs(g, N, m))
        cols, cb = (t(x) for x in pair_inputs(g, Mc, m))
        k = min(N, Mc) // 2
        cols[:k], cb[:k] = rows[:k], rb[:k]
        what = f"N={N} M={Mc} m={m}"
        for with_base in (True, False):
            got = ops.rect_u8_flags(rows, cols, rb, cb, with_base=with_base)
            want = ref.rect_u8_flags_ref(rows, cols,
                                         *((rb, cb) if with_base else ()))
            torch.cuda.synchronize()
            for x, y, f in zip(got, want, ("le", "ge")):
                check(torch.equal(x, y), f"rect_u8 {f} {what}")
            got = ops.tri_flags(rows, rb, with_base=with_base)
            want = ref.tri_flags_ref(rows, rb if with_base else None)
            torch.cuda.synchronize()
            for x, y, f in zip(got, want, ("le", "ge")):
                check(torch.equal(x, y), f"tri {f} N={N} m={m}")
            del got, want
        # int32 logical rows: the far bases put rows across the wrap point
        rows32 = rows.to(torch.int32) + rb[:, None]
        cols32 = cols.to(torch.int32) + cb[:, None]
        col_sums = ref.wrap_sum_i32(cols32).to(torch.float32)
        le, ge, sums, fp = ops.rect_i32_stats(rows32, cols32, col_sums)
        w_le, w_ge, w_sums, w_fp = ref.rect_i32_stats_ref(
            rows32, cols32, col_sums, bm=ops.tile_width(m, 512))
        torch.cuda.synchronize()
        check(torch.equal(le, w_le) and torch.equal(ge, w_ge),
              f"rect_i32 flags {what}")
        check(torch.equal(sums, w_sums), f"rect_i32 row sums {what}")
        check(bool(le.any()), f"rect_i32 {what}: no ordered pair")
        err["matrix_rect_i32"] = max(err["matrix_rect_i32"],
                                     check_fp(fp, w_fp, "rect_i32 fp"))
        del le, ge, fp, w_le, w_ge, w_fp
        # mxu: window-relative values in [0, T] around lo != 0
        T, lo = (64, -123457) if N == N_SLOTS else (8, 77)
        a, b = rows % (T - 4), cols % (T - 4)
        ab = t(lo + g.integers(0, 4, N).astype(np.int32))
        bb = t(lo + g.integers(0, 4, Mc).astype(np.int32))
        got = ops.mxu_viol(a, b, ab, bb, lo=lo, n_thresholds=T)
        want = ref.mxu_viol_ref(a, b, ab, bb, lo=lo, n_thresholds=T)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"mxu T={T} lo={lo} {what}")
        check(bool((got == 0).any()) and bool((got > 0).any()),
              f"mxu {what}: counts all zero or none zero")
        del got, want
    # mxu on its 16-bit lanes: ragged m (byte reads where rows are not
    # 4-byte aligned), N and M ragged against each tile, lo near both
    # ends of int32, bases far outside the window on both sides and where
    # u8 + base - lo wraps, identical rows; m = 8192 at T = 64 flushes
    # counts above 16 bits several times; T = MXU_WIDE_T, past MXU_T_MAX, runs
    # the 32-bit-lane kernel
    for m, T, lo, (bi, bj) in ((2, 8, -5, (64, 64)), (130, 16, 2 ** 31 - 21, (32, 128)),
                               (1001, 32, -2 ** 31 + 3, (128, 64)),
                               (8192, 64, 2 ** 31 - 1, (64, 64)), (640, 64, 0, (32, 32)),
                               (M, MXU_WIDE_T, -123457, (64, 64))):
        rows, cols, rb, cb = (t(x) for x in mxu_inputs(g, 1000, 777, m, T, lo))
        got = ops.mxu_viol(rows, cols, rb, cb, lo=lo, n_thresholds=T, bi=bi, bj=bj)
        want = ref.mxu_viol_ref(rows, cols, rb, cb, lo=lo, n_thresholds=T)
        torch.cuda.synchronize()
        what = f"mxu m={m} T={T} lo={lo} tile {bi}x{bj}"
        check(torch.equal(got, want), what)
        check(bool((torch.diagonal(got[:190, :190]) == 0).all()),
              f"{what}: identical rows with counts")
        check(m < 8192 or float(want.max()) > 65535, f"{what}: no count above 16 bits")
        del got, want
    # tri and rect-u8 on their 16-bit lanes and rect-i32 on its cp.async
    # staging: odd and ragged m (lane m - 1 pads the last word and chunk),
    # rows one element into their buffer (byte reads, 4-byte copies), N
    # and M ragged against each tile (tri at bt = 32 where the tile has a
    # 32 edge, else 64); int32 rows near the wrap and rows whose sums
    # exceed 2^24
    for m, (bi, bj) in ((1, (64, 64)), (3, (32, 128)), (1001, (128, 64)),
                        (130, (32, 32)), (M, (64, 128))):
        rows_np, rb_np = pair_inputs(g, 1000, m)
        cols_np, cb_np = pair_inputs(g, 777, m)
        rb_np[7::97] = -2 ** 31 + 5000       # 2^31 from the common base 5000
        cols_np[:300], cb_np[:300] = rows_np[:300], rb_np[:300]
        rb, cb = t(rb_np), t(cb_np)
        near = (2 ** 31 - 1 - g.integers(0, 300, m)).astype(np.int64)
        big = 40_000 + g.integers(-3, 4, (1000, m)) * 997
        r32_np = np.where((np.arange(1000) % 2 == 0)[:, None],
                          rows_np.astype(np.int64) + near, big)
        r32_np = (r32_np & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        c32_np = ((cols_np.astype(np.int64) + near) & 0xFFFFFFFF
                  ).astype(np.uint32).view(np.int32)
        c32_np[:300] = r32_np[:300]
        col_sums = ref.wrap_sum_i32(t(c32_np)).to(torch.float32)
        for offset in (0, 1):
            what = f"m={m} tile {bi}x{bj} offset {offset}"
            rows, cols = (offset_view(t(x), offset) for x in (rows_np, cols_np))
            for with_base in (True, False):
                got = ops.rect_u8_flags(rows, cols, rb, cb, bi=bi, bj=bj,
                                        with_base=with_base)
                want = ref.rect_u8_flags_ref(rows, cols,
                                             *((rb, cb) if with_base else ()))
                torch.cuda.synchronize()
                for x, y, f in zip(got, want, ("le", "ge")):
                    check(torch.equal(x, y), f"rect_u8 {f} {what} base={with_base}")
                check(bool(got[0].any()) and not bool(got[0].all()),
                      f"rect_u8 {what}: le all equal")
                bt = 32 if 32 in (bi, bj) else 64
                got = ops.tri_flags(rows, rb, bt=bt, with_base=with_base)
                want = ref.tri_flags_ref(rows, rb if with_base else None)
                torch.cuda.synchronize()
                for x, y, f in zip(got, want, ("le", "ge")):
                    check(torch.equal(x, y), f"tri {f} {what} bt={bt} base={with_base}")
            r32, c32 = (offset_view(t(x), offset) for x in (r32_np, c32_np))
            got = ops.rect_i32_stats(r32, c32, col_sums, bi=bi, bj=bj)
            want = ref.rect_i32_stats_ref(r32, c32, col_sums,
                                          bm=ops.tile_width(m, 512))
            torch.cuda.synchronize()
            for x, y, f in zip(got[:3], want[:3], ("le", "ge", "row sums")):
                check(torch.equal(x, y), f"rect_i32 {f} {what}")
            check(bool(got[0].any()), f"rect_i32 {what}: no ordered pair")
            check(m < 1000 or bool((got[2][1::2].abs() > 2 ** 24).all()),
                  f"rect_i32 {what}: no row sum above 2^24")
            err["matrix_rect_i32"] = max(err["matrix_rect_i32"],
                                         check_fp(got[3], want[3],
                                                  f"rect_i32 fp {what}"))
            del got, want
    print("[kernels] tri, rect_u8, rect_i32, mxu: identical to their plain "
          "versions, fp within tolerance")
    return err


def offset_view(x, offset: int):
    """``x`` copied into a buffer ``offset`` elements in: contiguous, its
    data pointer aligned to one element only."""
    import torch
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def hybrid_inputs(g, H: int, T: int, m: int, dev, near_wrap: bool = False):
    """A query, the chain version V, hot metadata [H, 2] and sums [H],
    and a packed tail [T, m] around the query (equal, ancestor,
    descendant, forked and unrelated rows; some bases far away, at the
    int32 wrap point with ``near_wrap``)."""
    import torch
    q_res = g.integers(0, 200, m)
    q_base = 2 ** 31 - 1 - 150 if near_wrap else 5000
    V = HYB_V
    meta = np.stack([g.integers(0, 2 * V, H), g.integers(0, 3, H)], 1)
    meta[: min(H, 4), 0] = V
    kind = np.arange(T) % 5
    step = g.integers(-1, 2, (T, m)) * (g.random((T, m)) < 0.03)
    rows = np.repeat(q_res[None], T, axis=0)
    rows[kind == 1] += np.abs(step[kind == 1])
    rows[kind == 2] -= np.abs(step[kind == 2])
    rows[kind == 3] += step[kind == 3]
    rows[kind == 4] = g.integers(0, 256, ((kind == 4).sum(), m))
    base = np.full(T, q_base, np.int64)
    base[kind == 4] = g.integers(-2 ** 31, 2 ** 31 - 256, (kind == 4).sum())
    t = lambda x, d: torch.as_tensor(x, dtype=d, device=dev)  # noqa: E731
    q = ((q_res + q_base) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return (t(q, torch.int32), V, t(meta, torch.int32),
            t(K * meta.sum(1), torch.float32),
            t(np.clip(rows, 0, 255), torch.uint8),
            t((base & 0xFFFFFFFF).astype(np.uint32).view(np.int32), torch.int32))


def check_hybrid_kernel(dev) -> dict:
    """The hybrid kernel against its plain version at the path's shapes
    (H = 4,096 hot rows over T = 65,540 tail rows, m = 1024 and 512) and
    at ragged ones (H and T not multiples of bn, m = 200 and 1000,
    near-wrap bases): flags and sums identical, fp within tolerance, hot
    fp exactly 0; and its tail rows bit-identical to the packed
    one-vs-many kernel on the same tail."""
    import torch
    from repro_torch.kernels import ops, ref

    g = np.random.default_rng(SEED + 7)
    T_path = HYB_TAIL + HYB_WIDE
    err = 0.0
    for H, T, m, near_wrap, offset in (
            (HYB_HEAD + HYB_MARGIN, T_path, M, False, 0),
            (HYB_HEAD + HYB_MARGIN, T_path, M // 2, True, 0),
            (HYB_HEAD + HYB_MARGIN, T_path, M, False, 1),
            (13, 1001, 200, True, 0), (4095, 77, 1000, True, 0),
            (1, 9, 520, False, 0), (1, 1, M, False, 0), (1, 1, M, True, 1),
            (5, 300, 640, False, 0),
            (HYB_HEAD + 1, 1, 1000, True, 0), (1, T_path, M, True, 0)):
        q, V, meta, hs, tail, base = hybrid_inputs(g, H, T, m, dev, near_wrap)
        if offset:
            tail = offset_view(tail, offset)  # scalar loads
        what = f"hybrid H={H} T={T} m={m} ptr%16={tail.data_ptr() % 16}"
        flags, sums, fp = ops.hybrid(q, V, meta, hs, tail, base)
        check(flags.dtype == torch.bool, f"{what}: flags not bool")
        w_flags, w_sums, w_fp = ref.hybrid_classify_ref(
            q, V, meta, hs, tail, base, bm=ops.tile_width(m, 512))
        torch.cuda.synchronize()
        check(torch.equal(flags, w_flags), f"{what}: flags")
        check(torch.equal(sums, w_sums), f"{what}: sums")
        check(bool((fp[:H] == 0).all()), f"{what}: hot fp not exactly 0")
        err = max(err, check_fp(fp, w_fp, what))
        flat = ops._classify_vs_many_packed(q, tail, base,
                                            bm=ops.OVM_BLOCKS[1])
        out = ops._classify_dict(flags, sums, fp)
        for key in ("q_le_p", "p_le_q", "sum_p", "fp_q_before_p",
                    "fp_p_before_q"):
            check(torch.equal(out[key][H:], flat[key]),
                  f"{what}: tail {key} differs from one_vs_many_packed")
        check(torch.equal(out["sum_q"], flat["sum_q"]), f"{what}: sum_q")
        check(bool(out["q_le_p"][:H].any()) and bool(out["p_le_q"][H:].any()),
              f"{what}: degenerate verdicts")
    print("[kernels] hybrid: identical to the plain version, fp within "
          "tolerance, hot fp exactly 0, tail rows bit-identical to "
          "one_vs_many_packed")
    return {"hybrid": err}


# ---------------------------------------------------------------------------
# phase 4: the main path, on the card and on the CPU
# ---------------------------------------------------------------------------

def make_peers(local: np.ndarray, n: int, seed: int) -> np.ndarray:
    """[n, m] int32 peer clocks around the local logical cells: ancestors,
    descendants, equal, forked and unrelated peers, plus 8 promoted rows
    (span > 255 and forked; near-wrap bases)."""
    g = np.random.default_rng(seed)
    L = local.astype(np.int64)
    m = L.shape[0]
    kind = np.arange(n) % 5
    up = (g.random((n, m)) < 0.03).astype(np.int64)
    down = ((g.random((n, m)) < 0.03) & (L > 0)).astype(np.int64)
    rows = np.repeat(L[None], n, axis=0)
    rows[kind == 0] -= down[kind == 0]                    # ancestors
    rows[kind == 1] += up[kind == 1]                      # descendants
    rows[kind == 3] += up[kind == 3] - down[kind == 3]    # mostly forked
    rows[kind == 4] = g.poisson(1.0, ((kind == 4).sum(), m))  # unrelated
    nz = int(np.flatnonzero(L > 0)[0])
    for i in range(4):                                    # span > 255
        rows[i] = L
        rows[i, (nz + 1 + i) % m] += 300
        rows[i, nz] -= 1
    for i in range(4, 8):                                 # near-wrap base
        rows[i] = L + (2 ** 31 - 2000) + i
    return (rows & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def drive(device: str, n_peers: int = N_PEERS, m: int = M,
          n_ticks: int = 256) -> dict:
    """The port's main path through its entry points; returns what the
    run produced (host arrays) and its end-to-end times."""
    import torch
    from repro_torch.core import clock as bc
    from repro_torch.core import wire
    from repro_torch.kernels import ops
    from repro_torch.runtime import ClockConfig, ClockRuntime

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    out: dict = {"times": {}}
    rt = ClockRuntime(ClockConfig(m=m, k=K), device=device)
    for s in range(n_ticks):
        rt.tick_step(s)
    local = host(rt.clock.logical_cells())
    rows = make_peers(local, n_peers, SEED + 1)
    zero = torch.zeros((), dtype=torch.int32)
    clocks = [bc.BloomClock(cells=torch.from_numpy(rows[i]), base=zero, k=K)
              for i in range(n_peers)]

    reg = rt.make_registry(n_peers)
    sync()
    t0 = time.perf_counter()
    for lo in range(0, n_peers, BATCH):
        reg.admit_many({f"p{i}": clocks[i]
                        for i in range(lo, min(lo + BATCH, n_peers))})
    sync()
    out["times"]["admit_s"] = time.perf_counter() - t0
    out["n_wide"] = len(reg._wide)

    t0 = time.perf_counter()
    view = rt.classify_fleet(reg)
    out["times"]["classify_all_ms"] = (time.perf_counter() - t0) * 1e3
    out["dispatch"] = dict(ops.LAST_DISPATCH)
    out["view0"] = (view.status.copy(), view.fp.copy(), np.asarray(view.sums).copy())

    pick = list(range(8, 8 + 40))
    out["lineage"] = [rt.lineage(clocks[i]) for i in pick]
    out["admit_merge"] = [rt.admit_merge(clocks[i]) for i in pick]
    out["clock_after_merge"] = host(rt.clock.logical_cells())

    out["rounds"] = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        rep = rt.gossip(reg)
        sync()
        out["times"].setdefault("gossip_round_ms", []).append(
            (time.perf_counter() - t0) * 1e3)
        out["rounds"].append((rep.accepted.copy(), rep.quarantined.copy(),
                              rep.stragglers.copy(), rep.unconfident.copy(),
                              rep.view.status.copy(), rep.view.fp.copy(),
                              rep.pushback_bytes))
    out["clock"] = host(rt.clock.logical_cells())
    out["frame"] = wire.encode_clock(rt.snapshot())
    out["slab"] = (host(reg.cells_u8), host(reg.base), host(reg.sums),
                   host(reg.alive), reg._crc_host.copy())
    out["wide"] = {s: r.copy() for s, r in reg._wide.items()}
    out["counts"] = view.counts()
    out["rt"], out["reg"] = rt, reg
    return out


def profile_round(rt, reg) -> dict:
    """One more loopback gossip round on the card under ``torch.profiler``
    and the port's own span tracer: wall time, device busy time (summed
    kernel time on the one stream), the idle share, time per session
    span and the kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fleet.gossip import GossipConfig
    from repro_torch.obs import Observer, Tracer

    tracer = Tracer()
    cfg = GossipConfig(policy=rt.policy, straggler_gap=rt.cfg.straggler_gap,
                       observer=Observer(trace=tracer))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.gossip(reg, cfg=cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms in kernels)
    spans: dict = {}
    for ev in tracer.events():
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur_us"] / 1e3
    top = sorted(kernels, key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "spans_ms": spans,
            "top_kernels_ms": [[k[:60], ms] for k, ms in top]}


def profiled(fn) -> dict:
    """``fn()`` once on the card under ``torch.profiler``: wall ms (host
    clock, synchronised), kernel and copy ms summed over the device
    events and their count, the card's idle share without and with the
    copies, and the device events that took the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    device = [(e.key, e.self_device_time_total / 1e3) for e in events]
    copy_ms = sum(ms for k, ms in device if k.startswith(("Memcpy", "Memset")))
    kernel_ms = sum(ms for _, ms in device) - copy_ms
    top = sorted(device, key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "copy_ms": copy_ms,
            "device_events": sum(e.count for e in events),
            "idle_share": 1.0 - kernel_ms / wall_ms,
            "idle_share_with_copies": 1.0 - (kernel_ms + copy_ms) / wall_ms,
            "top_device_ms": [[k[:60], ms] for k, ms in top]}


def compare_runs(gpu: dict, cpu: dict) -> None:
    check_equal(gpu["view0"][0], cpu["view0"][0], "classify_fleet statuses")
    check_fp(gpu["view0"][1], cpu["view0"][1], "classify_fleet fp")
    check_equal(gpu["view0"][2], cpu["view0"][2], "classify_fleet sums")
    for (sg, fg), (sc, fc) in zip(gpu["lineage"], cpu["lineage"]):
        check(sg == sc, f"lineage {sg} vs {sc}")
        check_fp([fg], [fc], "lineage fp")
    for (og, sg, fg), (oc, sc, fc) in zip(gpu["admit_merge"], cpu["admit_merge"]):
        check(og == oc and sg == sc, f"admit_merge {og, sg} vs {oc, sc}")
        check_fp([fg], [fc], "admit_merge fp")
    check_equal(gpu["clock_after_merge"], cpu["clock_after_merge"],
                "clock after admit_merge")
    for r, (rg, rc) in enumerate(zip(gpu["rounds"], cpu["rounds"])):
        for j, what in enumerate(("accepted", "quarantined", "stragglers",
                                  "unconfident", "status")):
            check_equal(rg[j], rc[j], f"gossip round {r} {what}")
        check_fp(rg[5], rc[5], f"gossip round {r} fp")
        check(rg[6] == rc[6], f"gossip round {r} push-back bytes")
    check_equal(gpu["clock"], cpu["clock"], "clock after gossip")
    check(gpu["frame"] == cpu["frame"], "wire frame of the local clock")
    for j, what in enumerate(("cells_u8", "base", "sums", "alive", "crc")):
        check_equal(gpu["slab"][j], cpu["slab"][j], f"registry {what}")
    check(gpu["wide"].keys() == cpu["wide"].keys(), "promoted slots")
    for s in gpu["wide"]:
        check_equal(gpu["wide"][s], cpu["wide"][s], f"promoted row {s}")


def sim_check() -> dict:
    from repro_torch.core.sim import SimConfig, run_gossip_sim
    cfg = SimConfig(n_nodes=64, n_events=4000, m=M, k=K)
    res = {}
    for d in ("cuda", "cpu"):
        with on(d):
            res[d] = run_gossip_sim(cfg, device=d)
    for d, r in res.items():
        print(f"[sim] {d}: {r.summary()}")
        check(r.false_negatives == 0, f"gossip sim on {d}: fn != 0")
    keys = ("rounds", "claims", "false_positives", "merges", "quarantines",
            "pushback_bytes")
    for key in keys:
        check(getattr(res["cuda"], key) == getattr(res["cpu"], key),
              f"gossip sim {key} differs between devices")
    return {key: getattr(res["cuda"], key) for key in keys}


# ---------------------------------------------------------------------------
# phase 4b: the mesh-sharded fleet registry
# ---------------------------------------------------------------------------

def shard_mesh(shards: int):
    """A fleet mesh of ``shards`` distinct cards where there are that
    many, else every shard on the one card; and which it is."""
    import torch
    from repro_torch.launch.mesh import make_fleet_mesh

    if torch.cuda.device_count() >= shards:
        return make_fleet_mesh(shards), "distinct cards"
    return make_fleet_mesh(shards, device="cuda"), "one card"


def fill(reg, clocks) -> None:
    for lo in range(0, len(clocks), BATCH):
        reg.admit_many({f"p{i}": clocks[i]
                        for i in range(lo, min(lo + BATCH, len(clocks)))})


def classify_ms(reg, local, reps: int = 5) -> list:
    """Host-clock ms of ``classify_all`` calls, each ending in a
    synchronise (the view is on the host when the call returns)."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg.classify_all(local)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def same_view(got, want, what: str, fp_bits: bool = True) -> None:
    check_equal(got.status, want.status, f"{what} statuses")
    check_equal(got.sums, want.sums, f"{what} sums")
    if fp_bits:
        check_equal(got.fp, want.fp, f"{what} fp bits")
    else:
        check_fp(got.fp, want.fp, f"{what} fp")


def same_round(got, want, what: str) -> None:
    for key in ("accepted", "quarantined", "stragglers", "unconfident"):
        check_equal(getattr(got, key), getattr(want, key), f"{what} {key}")
    same_view(got.view, want.view, f"{what} view")
    check(got.pushback_bytes == want.pushback_bytes,
          f"{what} push-back bytes")


def drive_shards() -> dict:
    """The main path's registry (65,536 peers of ``make_peers``, m = 1024)
    split over 1, 2, 4 and 8 row shards on the card, each held bit for
    bit to the unsharded card registry: ``classify_all`` (with the
    launch counts reset just before and read just after: s packed
    one-vs-many launches and one for the promoted rows), one loopback
    gossip round (verdicts, fp bits, push-back bytes, the merged
    clock's frame, the slab after push-back); one more registry over 4
    shards runs its round over ``MeshCollectiveTransport`` (the digest
    ring), held to the same loopback round.  Times: ``classify_all``
    on the host clock, 2 passes over every registry in turn, 10 calls
    each a pass; the device time of the (sharded) one-vs-many call."""
    import torch
    from repro_torch.core import clock as bc
    from repro_torch.core import wire
    from repro_torch.fleet import (GossipConfig, MeshCollectiveTransport,
                                   anti_entropy_session, gossip_round)
    from repro_torch.kernels import ops
    from repro_torch.runtime import ClockConfig, ClockRuntime

    rt = ClockRuntime(ClockConfig(m=M, k=K), device="cuda")
    for s in range(256):
        rt.tick_step(s)
    local = rt.clock
    rows = make_peers(host(local.logical_cells()), N_PEERS, SEED + 1)
    zero = torch.zeros((), dtype=torch.int32)
    clocks = [bc.BloomClock(cells=torch.from_numpy(rows[i]), base=zero, k=K)
              for i in range(N_PEERS)]
    cfg = GossipConfig(policy=rt.policy, straggler_gap=rt.cfg.straggler_gap)
    q = local.logical_cells().to(torch.int32).contiguous()

    regs = {"unsharded": rt.make_registry(N_PEERS)}
    out = {"unsharded": {}}
    for s in SHARD_COUNTS:
        mesh, where = shard_mesh(s)
        regs[s] = rt.make_registry(N_PEERS, mesh=mesh)
        out[s] = {"mesh": where}
    mesh, where = shard_mesh(MESH_TRANSPORT_SHARDS)
    via_mesh = rt.make_registry(N_PEERS, mesh=mesh)
    out["mesh_transport"] = {"mesh": where}
    for reg in (*regs.values(), via_mesh):
        fill(reg, clocks)
        check(len(reg._wide) == 8, f"{len(reg._wide)} promoted rows, "
                                   f"expected 8")
    want = regs["unsharded"].classify_all(local)
    for s in SHARD_COUNTS:
        reg = regs[s]
        check(reg.n_shards == s, f"{reg.n_shards} shards, expected {s}")
        ops.reset_launches()
        got = reg.classify_all(local)
        launches = {k: ops.LAUNCHES[k] for k in MAIN_KERNELS}
        check(launches["one_vs_many_packed"] == s,
              f"{launches['one_vs_many_packed']} packed launches at {s} shards")
        check(launches["one_vs_many_i32"] == 1,
              f"{launches['one_vs_many_i32']} overlay launches at {s} shards")
        check(got.engine == "packed_sharded+wide_overlay",
              f"engine {got.engine} at {s} shards")
        same_view(got, want, f"classify_all at {s} shards")
        out[s]["launches"] = launches
        out[s]["blocks"] = {k: ops.LAST_DISPATCH.get(k) for k in ("bn", "bm")}
    for _ in range(2):
        for key, reg in regs.items():
            out[key].setdefault("classify_all_ms", []).extend(
                classify_ms(reg, local, reps=10))
    for key, reg in regs.items():
        sl = reg._slab()
        if key == "unsharded":
            fn = lambda i: ops._classify_vs_many_packed(q, sl.cells_u8, sl.base)
        else:
            fn = lambda i: ops._classify_vs_many_packed_sharded(
                q, sl.cells_u8, sl.base, mesh=sl.mesh)
        out[key]["device_ms"] = events_ms(fn, 1, queued=True)

    def one_round(reg, transport=None):
        if transport is None:
            merged, rep = gossip_round(reg, local, cfg)
        else:
            merged, rep = anti_entropy_session(reg, local, transport(reg), cfg)
        torch.cuda.synchronize()
        return (rep, wire.encode_clock(bc.to_wire(merged)),
                [host(getattr(reg, n)) for n in ("cells_u8", "base", "sums",
                                                  "alive")])

    want_round = one_round(regs.pop("unsharded"))
    rounds = [(s, reg, None) for s, reg in regs.items()]
    rounds.append((f"{MESH_TRANSPORT_SHARDS} (mesh transport)", via_mesh,
                   MeshCollectiveTransport))
    for s, reg, transport in rounds:
        t0 = time.perf_counter()
        rep, frame, after = one_round(reg, transport)
        round_ms = (time.perf_counter() - t0) * 1e3
        same_round(rep, want_round[0], f"gossip round at {s} shards")
        check(rep.shards == reg.n_shards, f"report shards {rep.shards}")
        check(frame == want_round[1], f"merged clock frame at {s} shards")
        for n, a, b in zip(("cells_u8", "base", "sums", "alive"), after,
                           want_round[2]):
            check_equal(a, b, f"slab {n} after push-back at {s} shards")
    d = MESH_TRANSPORT_SHARDS
    check(rep.transport == "mesh", f"transport {rep.transport}")
    check(rep.digest_bytes == 9 * N_PEERS * (d - 1) // d,
          f"mesh digest bytes {rep.digest_bytes}")
    digests, _ = MeshCollectiveTransport(via_mesh).digests()
    check(len(digests) == len(via_mesh), f"{len(digests)} digests")
    sums = host(via_mesh.sums)
    check(all(g.clock_sum == float(sums[via_mesh.slot_of(pid)])
              for pid, g in digests.items()), "mesh digests vs the slab")
    out["mesh_transport"].update(
        round_ms=round_ms, digest_bytes=rep.digest_bytes,
        pushback_bytes=rep.pushback_bytes,
        accepted=int(rep.accepted.sum()))
    for key, rec in out.items():
        if key == "mesh_transport":
            continue
        ms = rec["classify_all_ms"]
        rec["classify_all_median_ms"] = float(np.median(ms))
        rec["classify_all_range_ms"] = [min(ms), max(ms)]
        del rec["classify_all_ms"]
    out["device_count"] = torch.cuda.device_count()
    return out


@contextlib.contextmanager
def strategy(name: str):
    """Within it, every sharded all-pairs runs strategy ``name``: a CUDA
    mesh whose shards share the one card reads no table entry, so this
    is how the smoke runs "replicated" through ``fleet_health``."""
    import functools
    from repro_torch.kernels import ops

    orig = ops._compare_matrix_packed_sharded
    ops._compare_matrix_packed_sharded = functools.partial(orig,
                                                           strategy=name)
    try:
        yield
    finally:
        ops._compare_matrix_packed_sharded = orig


def shard_health_check() -> dict:
    """``fleet_health`` at 2,048 slots over 4 shards on the card under
    each strategy against the unsharded card registry: all-pairs
    matrices bit-identical and the same health, the ring's launches (4
    tri, 6 rect-u8, the int32 rim); then the ring over 4 shards of the
    CPU, whose statuses and flags must equal the card's (fp within
    tolerance)."""
    from repro_torch.fleet import fleet_health
    from repro_torch.kernels import ops

    mesh, where = shard_mesh(4)
    ref = pairs_registry("cuda", N_SLOTS_CPU)
    reg = pairs_registry("cuda", N_SLOTS_CPU, mesh=mesh)
    want = fleet_health(ref)
    wp = ref.all_pairs().to_host()
    out = {"mesh": where}
    for name, label in (("ring", "ring_full+wide_rim"),
                        ("replicated", "replicated_tri+wide_rim")):
        with strategy(name):
            ops.reset_launches()
            got = fleet_health(reg)
            launches = {k: ops.LAUNCHES[k] for k in ENGINE_KERNELS}
            gp = reg.all_pairs().to_host()
        kernels = HEALTH_KERNELS + (("matrix_rect_u8",) if name == "ring"
                                    else ())
        for kname in kernels:
            check(launches[kname] > 0, f"kernel {kname} was not launched by "
                                       f"the sharded fleet_health ({name})")
        if name == "ring":
            check(launches["matrix_tri"] == 4
                  and launches["matrix_rect_u8"] == 6,
                  f"ring launches {launches} over 4 shards")
        check(got.shards == 4 and "shards=4" in got.summary(),
              "health shards")
        check(gp.engine == label, f"engine {gp.engine}, expected {label}")
        for key in ("a_le_b", "b_le_a", "concurrent", "fp", "row_sums"):
            check_equal(gp[key], wp[key], f"sharded all_pairs {key} ({name})")
        check_equal(got.component, want.component, "sharded fork components")
        check_equal(got.straggler_mask, want.straggler_mask,
                    "sharded stragglers")
        check_equal(got.fp_hist, want.fp_hist, "sharded fp histogram")
        check(got.comparable_fraction == want.comparable_fraction
              and got.mean_strict_fp == want.mean_strict_fp, "sharded health")
        out[name] = {"launches": launches, "engine": gp.engine}
    from repro_torch.launch.mesh import make_fleet_mesh
    with card_blocks():
        creg = pairs_registry("cpu", N_SLOTS_CPU,
                              mesh=make_fleet_mesh(4, device="cpu"))
        ch = fleet_health(creg)
        cp = creg.all_pairs().to_host()
    check(cp.engine == "ring_full+wide_rim", f"CPU engine {cp.engine}")
    for key in ("a_le_b", "b_le_a", "concurrent", "row_sums"):
        check_equal(cp[key], wp[key], f"CPU ring all_pairs {key}")
    check_fp(cp.fp, wp.fp, "CPU ring all_pairs fp")
    check_equal(ch.component, want.component, "CPU ring fork components")
    check_equal(ch.straggler_mask, want.straggler_mask, "CPU ring stragglers")
    out["health"] = health_record(got)
    return out


def ring_inputs(dev):
    """The narrow rows of the engines' check at 16,384 slots, packed with
    a base a row, on ``dev``."""
    import torch
    from repro_torch.kernels import pack

    rows = torch.as_tensor(narrow_rows(N_SLOTS), device=dev)
    u8, base, ok = pack.pack_rows(rows)
    check(bool(ok.all()), "ring rows must pack")
    return u8, base


def one_call_ms(fn, devices) -> dict:
    """One call at a time: ``one_ms``, the best of 3 calls each queued
    alone behind a sleep kernel on the first device (CUDA events, the
    autotuner's rule, ``autotune._measure``), and ``host_ms``, the median
    of 5 calls on the host clock, each ending in a synchronise of every
    device of the mesh (the latency a caller sees)."""
    import torch
    from repro_torch.kernels import autotune

    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(0)
        for d in set(devices):
            torch.cuda.synchronize(d)
        host.append((time.perf_counter() - t0) * 1e3)
    return {"one_ms": autotune._measure(lambda: fn(0), devices[0],
                                        count=False) * 1e3,
            "host_ms": float(np.median(host))}


def ring_op_check() -> dict:
    """The bare ``_compare_matrix_packed_sharded`` at N = 16,384, m =
    1,024 over s = 1, 2, 4, 8 shards (distinct cards where there are
    that many, else the one card) under both strategies: the ring's
    launches a call (s tri, s(s - 1)/2 rect-u8), flags, sums and fp
    identical to the unsharded tri (``_compare_matrix_packed``), and the
    device ms of a call beside the unsharded one's; the ring at s = 4 and
    the unsharded call once more under the profiler.  Times are CUDA
    events on ``devices[0]``, whose stream waits for every card's work
    (the block-rows and sums are copied onto it): ``ms`` a loop of 10
    calls queued behind the sleep kernel, ``call_ms`` the same loop not
    queued, ``one_ms`` one call queued alone (best of 3); ``host_ms``
    the host clock around one call and a synchronise of every card."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.sharding import split_rows

    dev = torch.device("cuda", 0)
    u8, base = ring_inputs(dev)
    want = ops._compare_matrix_packed(u8, base, engine="tri",
                                      uniform_base=False)
    check(bool(want["a_le_b"].any()) and bool(want["concurrent"].any()),
          "ring inputs degenerate")
    one = lambda i: ops._compare_matrix_packed(u8, base, engine="tri",
                                               uniform_base=False)
    out = {"unsharded": {**measure(one, 1, iters=10, warmup=2),
                         **one_call_ms(one, (dev,))}}
    for s in SHARD_COUNTS:
        mesh, where = shard_mesh(s)
        cells, bases = split_rows(u8, mesh.devices), split_rows(base,
                                                                mesh.devices)
        for name in ("ring", "replicated"):
            def call(i, name=name):
                return ops._compare_matrix_packed_sharded(
                    cells, bases, mesh=mesh, strategy=name,
                    uniform_base=False)
            ops.reset_launches()
            got = call(0)
            launches = {k: ops.LAUNCHES[k]
                        for k in ("matrix_tri", "matrix_rect_u8")}
            if name == "ring":
                check(launches == {"matrix_tri": s,
                                   "matrix_rect_u8": s * (s - 1) // 2},
                      f"ring launches {launches} at {s} shards")
            for key in ("a_le_b", "b_le_a", "concurrent", "fp", "row_sums"):
                check(torch.equal(got[key], want[key]),
                      f"sharded {name} {key} at {s} shards vs unsharded tri")
            del got
            out[f"{name} s={s}"] = {"mesh": where, "launches": launches,
                                    **measure(call, 1, iters=10, warmup=2),
                                    **one_call_ms(call, mesh.devices)}
            if name == "ring" and s == 4:
                out["profile"] = {"ring s=4": profiled(lambda: call(0))}
    out["profile"]["unsharded"] = profiled(
        lambda: ops._compare_matrix_packed(u8, base, engine="tri",
                                           uniform_base=False))
    return out


def shard_cpu_check() -> dict:
    """The sharded registry at 4,096 peers over 4 shards on the CPU (the
    plain versions, given the card's blocks) against the same on the
    card: classify_all and one gossip round."""
    import torch
    from repro_torch.core import clock as bc
    from repro_torch.fleet import ClockRegistry, GossipConfig, gossip_round
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.runtime import ClockConfig, ClockRuntime

    rows = None
    res = {}
    for device in ("cuda", "cpu"):
        with on(device):
            rt = ClockRuntime(ClockConfig(m=M, k=K), device=device)
            for s in range(256):
                rt.tick_step(s)
            local = rt.clock
            if rows is None:
                rows = make_peers(host(local.logical_cells()), N_SHARD_CPU,
                                  SEED + 7)
            zero = torch.zeros((), dtype=torch.int32)
            reg = ClockRegistry(N_SHARD_CPU, M, K,
                                mesh=make_fleet_mesh(4, device=device))
            fill(reg, [bc.BloomClock(torch.from_numpy(r), zero, K)
                       for r in rows])
            view = reg.classify_all(local)
            _, rep = gossip_round(reg, local, GossipConfig())
            res[device] = (view, rep)
    (gv, gr), (cv, cr) = res["cuda"], res["cpu"]
    same_view(gv, cv, "sharded classify_all, card vs CPU", fp_bits=False)
    same_round(gr, cr, "sharded gossip round, card vs CPU")
    return {"counts": gv.counts(), "accepted": int(gr.accepted.sum())}


def shard_sim_check(want: dict) -> dict:
    """The audited gossip sim with a registry over 8 shards on the card,
    over the loopback and the mesh transport: fn == 0 and the unsharded
    card run's counts."""
    from repro_torch.core.sim import SimConfig, run_gossip_sim
    from repro_torch.fleet import ClockRegistry
    from repro_torch.kernels import ops

    mesh, where = shard_mesh(8)
    factory = lambda cap, m, k: ClockRegistry(cap, m, k, mesh=mesh)
    out = {"mesh": where}
    for transport in ("loopback", "mesh"):
        ops.reset_launches()
        r = run_gossip_sim(SimConfig(n_nodes=64, n_events=4000, m=M, k=K),
                           device="cuda", registry_factory=factory,
                           transport=transport)
        check(r.false_negatives == 0, f"sharded gossip sim ({transport}): "
                                      f"fn != 0")
        check(r.transport == transport, f"sim transport {r.transport}")
        check(ops.LAUNCHES["one_vs_many_packed"] == 8 * r.rounds,
              f"{ops.LAUNCHES['one_vs_many_packed']} packed launches over "
              f"{r.rounds} sharded rounds")
        for key, v in want.items():
            check(getattr(r, key) == v,
                  f"sharded gossip sim ({transport}) {key} differs")
        check((r.digest_bytes > 0) == (transport == "mesh"),
              f"sim digest bytes {r.digest_bytes} over {transport}")
        out[transport] = r.summary()
    return out


def shard_phase(sim: dict) -> None:
    """Phase 4b: drive the sharded registry and print its ``[shard]``
    lines; ``sim`` holds the unsharded card sim's counts."""
    shard = drive_shards()
    u = shard["unsharded"]
    print(f"[shard] {shard['device_count']} CUDA device(s); unsharded card "
          f"registry ({N_PEERS} peers, m={M}): classify_all median "
          f"{u['classify_all_median_ms']} ms (range "
          f"{json.dumps(u['classify_all_range_ms'])}, 20 calls), one-vs-many "
          f"device ms {u['device_ms']}")
    for s in SHARD_COUNTS:
        r = shard[s]
        print(f"[shard] s={s} on {r['mesh']}: statuses, sums, fp bits, "
              f"gossip verdicts, wire bytes and the slab identical to the "
              f"unsharded card registry; launches a classify_all "
              f"{json.dumps(r['launches'])} at (bn, bm) "
              f"{json.dumps(r['blocks'])}; classify_all median "
              f"{r['classify_all_median_ms']} ms (range "
              f"{json.dumps(r['classify_all_range_ms'])}, 20 calls); sharded "
              f"one-vs-many device ms {r['device_ms']}")
    mt = shard["mesh_transport"]
    print(f"[shard] one gossip round over MeshCollectiveTransport, "
          f"{N_PEERS} peers over {MESH_TRANSPORT_SHARDS} shards on "
          f"{mt['mesh']}: verdicts, fp bits, push-back bytes, merged frame "
          f"and slab identical to the unsharded loopback round; digests the "
          f"slab's sums: {json.dumps(mt)}")
    print(f"[shard] fleet_health at {N_SLOTS_CPU} slots over 4 shards under "
          f"ring and replicated bit-identical to unsharded, the CPU ring's "
          f"statuses and flags identical: "
          f"{json.dumps(shard_health_check())}")
    ring = ring_op_check()
    u = ring.pop("unsharded")
    prof = ring.pop("profile")
    print(f"[shard] all-pairs at N={N_SLOTS} m={M}: unsharded tri "
          f"(_compare_matrix_packed) {u['ms']} ms (call {u['call_ms']} ms, "
          f"one call {u['one_ms']} ms, host {u['host_ms']} ms), CUDA events "
          f"on the first card")
    for key, r in ring.items():
        print(f"[shard] all-pairs {key} on {r['mesh']}: flags, sums and fp "
              f"identical to the unsharded tri; launches a call "
              f"{json.dumps(r['launches'])}; {r['ms']} ms (call "
              f"{r['call_ms']} ms, one call {r['one_ms']} ms, host "
              f"{r['host_ms']} ms)")
    print(f"[shard] all-pairs at N={N_SLOTS}, one call under the profiler "
          f"(device time by event): {json.dumps(prof)}")
    print(f"[shard] {N_SHARD_CPU} peers over 4 shards: card and CPU agree "
          f"(statuses, sums, gossip verdicts, push-back bytes; fp within "
          f"tolerance): {json.dumps(shard_cpu_check())}")
    print(f"[shard] gossip sim over 8 shards on the card, loopback and mesh "
          f"transports: fn=0, the unsharded run's counts: "
          f"{json.dumps(shard_sim_check(sim))}")


# ---------------------------------------------------------------------------
# phase 4c: multi-host gossip (sockets, the peers launcher, chaos)
# ---------------------------------------------------------------------------

#: the README's socket deployment (README.md:229-246, ``ClockConfig``'s m
#: and k): 256 peers served on 127.0.0.1, a leader registry of capacity
#: 256; the leader has ticked 600 events, 64 peers tick before the third
#: session, and the leader ticks 16 more of its own (B = 1 each)
SOCK_PEERS, SOCK_EVENTS, SOCK_TICKED, SOCK_NEAR_WRAP = 256, 600, 64, 4
SOCK_LEADER_TICKS = 16
#: the hostile fleet: the chaos smoke's fault mix over 64 nodes, 8 event
#: rounds (faults quiesced after round 6), a registry row corrupted
CHAOS_NODES, CHAOS_ROUNDS, CHAOS_SEED = 64, 8, 7
#: each child process (the peers launcher, the chaos smoke) is bounded
CHILD_TIMEOUT = 300
I32_MAX = 2 ** 31 - 1


def probes(n_events: int, first: int = 0) -> np.ndarray:
    """[n, K] bloom probes of event ids first .. first + n - 1, by the
    runtime's hasher."""
    from repro_torch.core.hashing import bloom_indices
    ids = np.arange(first, first + n_events, dtype=np.int64)
    return bloom_indices(ids >> 32, ids & 0xFFFFFFFF, K, M).numpy()


def ticked(p: np.ndarray, cells=None) -> np.ndarray:
    """int64 cells after the events of probe table ``p``."""
    out = np.zeros(M, np.int64) if cells is None else cells.copy()
    np.add.at(out, p.reshape(-1), 1)
    return out


def socket_fleet(seed: int) -> dict:
    """The staged fleet's host clocks: strict prefixes of the leader's
    600 events (ancestors), prefixes with private events (forks), short
    prefixes (stragglers), the leader plus private events (descendants),
    and 4 peers past the int32 wrap in some cells (forks on the exact
    i32 rim); the new cells of the 64 peers that tick before the third
    session; the kind of each peer."""
    g = np.random.default_rng(seed)
    lead = probes(SOCK_EVENTS)
    rows, kinds = {}, {}
    for i in range(SOCK_PEERS):
        pid = f"peer{i:03d}"
        own = probes(int(g.integers(1, 24)), first=(1 << 40) + 100 * i)
        if i < SOCK_NEAR_WRAP:
            rows[pid], kinds[pid] = I32_MAX - 50 + g.integers(0, 101, M), "wrap"
        elif i % 4 == 0:
            p = int(g.integers(50, SOCK_EVENTS))
            rows[pid], kinds[pid] = ticked(np.concatenate([lead[:p], own])), "fork"
        elif i % 4 == 1:
            rows[pid], kinds[pid] = ticked(lead[:int(g.integers(0, 24))]), "straggler"
        elif i % 4 == 2:
            rows[pid], kinds[pid] = ticked(np.concatenate([lead, own])), "descendant"
        else:
            rows[pid], kinds[pid] = ticked(lead[:int(g.integers(100, SOCK_EVENTS + 1))]), "ancestor"
    movers = sorted(g.choice([p for p in rows if kinds[p] != "wrap"],
                             SOCK_TICKED, replace=False))
    return {"rows": rows, "kinds": kinds, "lead": lead,
            "movers": {pid: probes(3, first=(1 << 41) + 10 * j)
                       for j, pid in enumerate(movers)}}


def drive_socket(device: str, fleet: dict, nodes: dict, addresses: dict) -> dict:
    """Three sessions of a leader on ``device`` over ``SocketTransport``
    against the served fleet, each node reset to the staged clocks first:
    round 0 pulls every frame, round 1 nothing, round 2 the 64 peers
    that ticked (and the leader ticks 16 events of its own before it).
    On the card the launch counts are reset just before the sessions and
    read just after."""
    import torch
    from repro_torch.causal import CausalPolicy
    from repro_torch.core import clock as bc
    from repro_torch.core import wire
    from repro_torch.fleet import ClockRegistry, GossipConfig, SocketTransport
    from repro_torch.fleet import anti_entropy_session
    from repro_torch.kernels import ops
    from repro_torch.launch.peers import _ticked_clock
    from repro_torch.obs import Observer, Tracer

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    for pid, node in nodes.items():
        node.set_cells(fleet["rows"][pid])
    tracer = Tracer()
    policy = CausalPolicy(observer=Observer(trace=tracer))
    reg = ClockRegistry(SOCK_PEERS, M, K, device=device, policy=policy)
    tp = SocketTransport(addresses, timeout=10.0)
    cfg = GossipConfig(policy=policy)
    local = _ticked_clock(M, K, SOCK_EVENTS, device)
    check_equal(host(local.logical_cells()), ticked(fleet["lead"]),
                f"the leader's ticked clock on {device}")
    own = np.arange(1 << 42, (1 << 42) + SOCK_LEADER_TICKS, dtype=np.int64)
    out = {"sessions": []}
    sync()
    ops.reset_launches()
    for r in range(3):
        if r == 2:
            for pid, p in fleet["movers"].items():
                nodes[pid].set_cells(ticked(p, nodes[pid].cells()))
            for e in own:
                local = bc.tick(local, int(e) >> 32, int(e) & 0xFFFFFFFF)
        n_ev = len(tracer.events())
        sync()
        t0 = time.perf_counter()
        local, rep = anti_entropy_session(reg, local, tp, cfg)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        spans, pull = {}, {}
        for ev in tracer.events()[n_ev:]:
            if ev["name"].startswith("gossip.") and ev["name"] != "gossip.session":
                spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur_us"] / 1e3
            if ev["name"] == "gossip.pull":
                pull = ev["attrs"]
        merged = host(local.logical_cells())
        out["sessions"].append({
            "masks": tuple(getattr(rep, k).copy() for k in (
                "accepted", "quarantined", "stragglers", "unconfident")),
            "status": rep.view.status.copy(), "fp": rep.view.fp.copy(),
            "merged": merged, "rows": host(reg.cells), "wide": sorted(reg._wide),
            "bytes": (rep.digest_bytes, rep.delta_bytes, rep.pushback_bytes),
            "have": dict(tp.have), "slot": {p: reg.slot_of(p) for p in reg.peer_ids()},
            "pulled": (pull.get("wanted"), pull.get("pulled", 0)),
            "unreachable": rep.unreachable, "ms": ms, "spans": spans,
            "union_crc": wire.cells_crc(merged),
            "held": {pid: node.digest().crc for pid, node in nodes.items()},
            "summary": rep.summary()})
    sync()
    out["launches"] = dict(ops.LAUNCHES)
    # the sockets alone: one bare pull of every frame, no ingest
    digests, _ = tp.digests()
    t0 = time.perf_counter()
    frames, _ = tp.pull(list(addresses))
    out["bare_pull_ms"] = (time.perf_counter() - t0) * 1e3
    check(len(frames) == SOCK_PEERS, f"{device}: bare pull got {len(frames)}")
    out["ingest_ms"] = ingest_ms(device, digests, frames)
    return out


def ingest_ms(device: str, digests: dict, frames: dict) -> dict:
    """The session's delta ingest alone, on frames served from memory
    into a fresh registry on ``device``: every frame admitted, then the
    same frames merged into the live rows (``have`` cleared), each timed
    on the host clock to a synchronise."""
    import torch
    from repro_torch.fleet import ClockRegistry
    from repro_torch.fleet.transport.base import Transport
    from repro_torch.fleet.transport.session import _ingest_delta
    from repro_torch.obs.observer import resolve

    class Feed(Transport):
        name, authoritative = "feed", False

        def digests(self):
            self._begin_round()
            return dict(digests), 0

        def pull(self, peer_ids):
            return {p: frames[p] for p in peer_ids}, 0

        def push(self, peer_ids, frame):
            return 0

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    reg = ClockRegistry(SOCK_PEERS, M, K, device=device)
    feed, out = Feed(), {}
    for what in ("admit", "merge"):
        feed.have.clear()
        sync()
        t0 = time.perf_counter()
        _ingest_delta(reg, feed, resolve(None))
        sync()
        out[what] = (time.perf_counter() - t0) * 1e3
    check(len(reg) == SOCK_PEERS, f"{device}: the ingest admitted {len(reg)}")
    return out


def check_socket_run(run: dict, fleet: dict, device: str) -> None:
    """What the staged fleet must show on either device."""
    from repro_torch.fleet import registry as fr
    s0, s1, s2 = run["sessions"]
    kinds = fleet["kinds"]
    check(s0["pulled"] == (SOCK_PEERS, SOCK_PEERS) and s0["bytes"][1] > 0,
          f"{device}: round 0 pulled {s0['pulled']}, not all {SOCK_PEERS}")
    check(s1["pulled"] == (0, 0) and s1["bytes"][1] == 0,
          f"{device}: round 1 pulled {s1['pulled']} ({s1['bytes'][1]} B)")
    check(s2["pulled"] == (SOCK_TICKED, SOCK_TICKED),
          f"{device}: round 2 pulled {s2['pulled']}, not the {SOCK_TICKED} "
          "that ticked")
    for r, s in enumerate(run["sessions"]):
        check(not s["unreachable"], f"{device}: unreachable {s['unreachable']}")
        for pid, slot in s["slot"].items():
            # §3: a peer causally ordered with the leader is never called
            # concurrent (a peer that ticked its own events may be)
            if (kinds[pid] in ("ancestor", "straggler", "descendant")
                    and not (r == 2 and pid in fleet["movers"])):
                check(int(s["status"][slot]) != fr.FORKED,
                      f"{device}: round {r}: {kinds[pid]} {pid} called FORKED")
    wrap = {s0["slot"][p] for p in kinds if kinds[p] == "wrap"}
    check(wrap <= set(s0["wide"]), f"{device}: near-wrap rows not promoted")
    for s in (s0, s2):
        for pid, slot in s["slot"].items():
            if s["masks"][0][slot]:
                check(s["held"][pid] == s["union_crc"],
                      f"{device}: accepted {pid} does not hold the union")


def compare_socket_runs(gpu: dict, cpu: dict) -> None:
    for r, (g, c) in enumerate(zip(gpu["sessions"], cpu["sessions"])):
        for j, what in enumerate(("accepted", "quarantined", "stragglers",
                                  "unconfident")):
            check_equal(g["masks"][j], c["masks"][j], f"socket round {r} {what}")
        check_equal(g["status"], c["status"], f"socket round {r} statuses")
        check_fp(g["fp"], c["fp"], f"socket round {r} fp")
        check_equal(g["merged"], c["merged"], f"socket round {r} merged cells")
        check_equal(g["rows"], c["rows"], f"socket round {r} registry rows")
        for key in ("wide", "bytes", "have", "slot", "pulled", "held"):
            check(g[key] == c[key], f"socket round {r}: {key} differs")


def run_children(cmds: list) -> list:
    """Run child processes side by side, each in a session of its own
    and bounded by ``CHILD_TIMEOUT``; every process of their groups is
    stopped before returning.  ``cmds`` holds (argv, what) pairs; returns
    (stdout + stderr, wall seconds) for each; fails on a non-zero exit."""
    import signal
    import threading
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    results: list = [None] * len(cmds)

    def one(i: int, proc, t0: float) -> None:
        try:
            out, _ = proc.communicate(timeout=CHILD_TIMEOUT)
            results[i] = (out, time.perf_counter() - t0, False)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
            results[i] = (out, time.perf_counter() - t0, True)

    procs, threads = [], []
    try:
        for i, (cmd, _) in enumerate(cmds):
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True,
                                    start_new_session=True)
            procs.append(proc)
            threads.append(threading.Thread(target=one, args=(i, proc, t0)))
            threads[-1].start()
        for th in threads:
            th.join()
    finally:
        for proc in procs:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
    for (_, what), proc, (out, _, late) in zip(cmds, procs, results):
        if late:
            raise SmokeFailure(f"{what} ran past {CHILD_TIMEOUT} s:\n{out[-4000:]}")
        check(proc.returncode == 0,
              f"{what} exited {proc.returncode}:\n{out[-4000:]}")
    return [(out, wall) for out, wall, _ in results]


def run_child(cmd: list, what: str) -> tuple[str, float]:
    """``run_children`` of one child."""
    return run_children([(cmd, what)])[0]


#: set by the full run: the launchers' child processes of phases 4c (c),
#: 10, 11, 12 and 13 then run side by side after phase 10
#: (``run_launchers``); a phase run alone starts its own
CHILDREN_BATCHED = False


def run_launchers(specs: list) -> None:
    """Run (argv, what, report) child specs side by side; ``report(out,
    wall, note)`` checks each child's output and prints its line."""
    runs = run_children([(argv, what) for argv, what, _ in specs])
    note = f" ({len(specs)} side by side)" if len(specs) > 1 else ""
    for (_, _, report), (out, wall) in zip(specs, runs):
        report(out, wall, note)


def serve_launcher(tag: str, arch=None) -> tuple:
    """``python -m repro_torch.launch.serve`` (the full config's defaults)
    or ``--arch <arch> --smoke``: it must exit 0 having served on the
    card."""
    argv = ([] if arch is None else ["--arch", arch, "--smoke"])
    cmd = " ".join(["python -m repro_torch.launch.serve", *argv])

    def report(out: str, wall: float, note: str) -> None:
        lines = [ln for ln in out.splitlines() if ln.startswith("[serve]")]
        check(any("on cuda: prefill" in ln for ln in lines),
              f"{cmd} printed no serving line:\n{out[-2000:]}")
        what = " (defaults: the full config on the card)" if arch is None else ""
        print(f"[{tag}] {cmd}{what} exited 0 in {wall:.1f} s{note}: "
              f"{json.dumps(lines)}")
    return [sys.executable, "-m", "repro_torch.launch.serve", *argv], cmd, report


def train_launcher(ckpt_dir: str) -> tuple:
    """``python -m repro_torch.launch.train`` with ``TRAIN_CHILD_ARGS``
    (the full config on the card): it must exit 0 having run its steps."""
    def report(out: str, wall: float, note: str) -> None:
        lines = [ln for ln in out.splitlines() if ln.startswith("[train]")]
        check(any(ln.startswith(f"[train] done: {TRAIN_CHILD_STEPS} steps")
                  for ln in lines),
              f"launch.train printed no finished run:\n{out[-2000:]}")
        print(f"[train] python -m repro_torch.launch.train "
              f"{' '.join(TRAIN_CHILD_ARGS)} (the launcher's defaults "
              f"otherwise: the full config on the card) exited 0 in "
              f"{wall:.1f} s{note}: {json.dumps(lines)}")
    return ([sys.executable, "-m", "repro_torch.launch.train",
             *TRAIN_CHILD_ARGS, "--ckpt-dir", ckpt_dir, "--log-every", "1"],
            "python -m repro_torch.launch.train", report)


def chaos_launcher() -> tuple:
    """``python -m repro_torch.fleet.chaos --smoke`` (the registry on the
    card): it must exit 0 and print its OK."""
    def report(out: str, wall: float, note: str) -> None:
        for line in out.splitlines():
            if line.startswith("chaos-smoke"):
                print(f"[socket] (c) {line}")
        check("chaos-smoke: OK" in out, "chaos smoke: no OK")
        print(f"[socket] (c) chaos smoke on the card: exit 0 in {wall:.2f} s "
              f"wall{note}")
    return ([sys.executable, "-m", "repro_torch.fleet.chaos", "--smoke"],
            "the chaos smoke", report)


def chaos_fault_tuples(obs) -> list:
    """``FaultEvent.as_tuple()`` of every injected fault, from the chaos
    records the transport writes one a fault (``ChaosTransport._fault``),
    with the ephemeral TCP ports a detail may quote masked."""
    out = []
    for r in obs.audit.chaos_events():
        head, _, detail = r.detail.partition(": ")
        rnd, phase = head[1:].split("/")
        out.append((int(rnd), phase, r.peer_id, r.action,
                    re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:*", detail)))
    return out


def chaos_sim(device: str) -> tuple:
    from repro_torch.causal import CausalPolicy
    from repro_torch.core.sim import SimConfig, run_gossip_sim
    from repro_torch.fleet import GossipConfig
    from repro_torch.fleet.chaos import smoke_chaos
    from repro_torch.obs import AuditTrail, Observer

    obs = Observer(audit=AuditTrail())
    t0 = time.perf_counter()
    with on(device):
        res = run_gossip_sim(
            SimConfig(n_nodes=CHAOS_NODES, m=M, k=K, seed=CHAOS_SEED),
            n_rounds=CHAOS_ROUNDS,
            gossip_cfg=GossipConfig(policy=CausalPolicy(fp_threshold=1.0),
                                    straggler_gap=np.inf, observer=obs,
                                    merge_forked=True),
            transport="socket",
            chaos=smoke_chaos(CHAOS_SEED, CHAOS_NODES, CHAOS_ROUNDS - 1),
            corrupt_at=(3, 1), device=device)
    wall = time.perf_counter() - t0
    check(res.false_negatives == 0, f"chaos sim on {device}: fn != 0")
    check(res.converged, f"chaos sim on {device} did not converge")
    check(res.repaired >= 1, f"chaos sim on {device} repaired nothing")
    check(res.fault_events > 0, f"chaos sim on {device} injected nothing")
    return res, chaos_fault_tuples(obs), wall


def socket_phase() -> None:
    import dataclasses
    import resource

    from repro_torch.fleet import ClockNode, ClockPeerServer
    from repro_torch.fleet.transport.socket import stop_servers

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    print(f"[socket] file descriptors: soft limit {soft}, hard {hard}; "
          f"{SOCK_PEERS} listening sockets and one connection at a time")
    check(soft >= SOCK_PEERS + 256, f"soft RLIMIT_NOFILE {soft} too low")

    # (a) the staged fleet in one process, on the card and on the CPU
    fleet = socket_fleet(SEED + 7)
    nodes, servers = {}, []
    try:
        for pid in fleet["rows"]:
            nodes[pid] = ClockNode(pid, M, K)
            servers.append(ClockPeerServer(nodes[pid]).start())
        addresses = {pid: s.address for pid, s in zip(nodes, servers)}
        gpu = drive_socket("cuda", fleet, nodes, addresses)
        with card_blocks():
            cpu = drive_socket("cpu", fleet, nodes, addresses)
    finally:
        stop_servers(servers)
    for d, run in (("cuda", gpu), ("cpu", cpu)):
        check_socket_run(run, fleet, d)
        for r, s in enumerate(run["sessions"]):
            print(f"[socket] (a) {d} session {r}: {s['ms']} ms host clock, "
                  f"spans {json.dumps(s['spans'])}; pulled {s['pulled'][1]} "
                  f"of {s['pulled'][0]} wanted; digest/delta/push bytes "
                  f"{list(s['bytes'])}; {s['summary']}")
    for d, run in (("cuda", gpu), ("cpu", cpu)):
        ing = run["ingest_ms"]
        print(f"[socket] (a) {d}: a bare SocketTransport.pull of the "
              f"{SOCK_PEERS} frames {run['bare_pull_ms']} ms; the ingest "
              f"alone (decode, place on {d}, write, keys) from memory: admit "
              f"{ing['admit']} ms ({ing['admit'] / SOCK_PEERS} a frame), merge "
              f"into the live rows {ing['merge']} ms ({ing['merge'] / SOCK_PEERS}"
              f" a frame)")
    compare_socket_runs(gpu, cpu)
    launches = {k: gpu["launches"][k] for k in
                ("bloom_tick", "one_vs_many_packed", "one_vs_many_i32")}
    for kname, n in launches.items():
        check(n > 0, f"kernel {kname} was not launched on the socket path")
    print(f"[socket] (a) {SOCK_PEERS} peers, m={M}, k={K}: card and CPU agree "
          f"(masks, statuses, merged cells, registry rows, promoted slots, "
          f"digest/delta/push bytes, have keys; fp within tolerance); "
          f"round 0 pulled all, round 1 none, round 2 the {SOCK_TICKED} that "
          f"ticked; launches on the card's three sessions {json.dumps(launches)}")

    # (b) real processes: a leader on the card, 7 children on the CPU
    with tempfile.TemporaryDirectory() as d:
        out, wall = run_child(
            [sys.executable, "-m", "repro_torch.launch.peers", "--smoke", "8",
             "--m", str(M), "--k", str(K), "--rounds", "3", "--trace-dir", d],
            "the peers smoke")
    check("[leader] OK: 8 processes converged" in out, "peers smoke: no OK")
    for line in out.splitlines():
        if line.startswith("[leader] round") or line.startswith("[leader] OK") \
                or line.startswith("[leader] trace OK"):
            print(f"[socket] (b) {line}")
    print(f"[socket] (b) 8 processes (leader on the card, 7 children on the "
          f"CPU): exit 0 in {wall:.2f} s wall")

    # (c) the hostile fleet
    if not CHILDREN_BATCHED:
        run_launchers([chaos_launcher()])
    res = {d: chaos_sim(d) for d in ("cuda", "cpu")}
    (rg, sg, wg), (rc, sc, wc) = res["cuda"], res["cpu"]
    check(sg == sc, "chaos schedule differs between the card and the CPU")
    fg, fc = dataclasses.asdict(rg), dataclasses.asdict(rc)
    check_fp([fg.pop("mean_predicted_fp")], [fc.pop("mean_predicted_fp")],
             "chaos sim mean predicted fp")
    check(fg == fc, f"chaos sim results differ: {fg} vs {fc}")
    for d, (r, s, w) in res.items():
        print(f"[socket] (c) chaos sim {CHAOS_NODES} nodes m={M} on {d}: "
              f"{r.summary()} ({len(s)} faults, {w:.2f} s wall)")
    print(f"[socket] (c) card and CPU: the same {len(sg)}-fault schedule and "
          f"the same result fields (fp within tolerance)")


# ---------------------------------------------------------------------------
# phase 5: the all-pairs path
# ---------------------------------------------------------------------------

def pairs_registry(device: str, n_slots: int, observer=None, mesh=None):
    """A registry of ``n_slots`` peers from ``make_peers`` around a ticked
    local clock (8 promoted rows), with ~1% of the slots evicted; over
    ``mesh`` when one is given."""
    import torch
    from repro_torch.causal import CausalPolicy
    from repro_torch.core import clock as bc
    from repro_torch.fleet import ClockRegistry
    from repro_torch.runtime import ClockConfig, ClockRuntime

    rt = ClockRuntime(ClockConfig(m=M, k=K), device=device)
    for s in range(256):
        rt.tick_step(s)
    rows = make_peers(host(rt.clock.logical_cells()), n_slots, SEED + 3)
    zero = torch.zeros((), dtype=torch.int32)
    reg = ClockRegistry(n_slots, M, K, policy=CausalPolicy(observer=observer),
                        mesh=mesh, device=device)
    for lo in range(0, n_slots, BATCH):
        reg.admit_many({f"p{i}": bc.BloomClock(torch.from_numpy(rows[i]), zero, K)
                        for i in range(lo, min(lo + BATCH, n_slots))})
    reg.evict_many([f"p{i}" for i in range(50, n_slots, 100)])
    return reg


def health_record(h) -> dict:
    return {"n_alive": h.n_alive, "n_components": h.n_components,
            "comparable_fraction": h.comparable_fraction,
            "stragglers": int(h.straggler_mask.sum()),
            "mean_strict_fp": h.mean_strict_fp, "fp_hist": h.fp_hist.tolist()}


def drive_health(dev) -> dict:
    """``fleet_health`` over the 16,384-slot registry on the card: the
    launch counts of that one call, its wall time and spans, the same
    all-pairs call timed alone (synchronised) and its transfer, then one
    more call under the profiler for device time and the idle share."""
    import torch
    from repro_torch.fleet import fleet_health
    from repro_torch.kernels import ops
    from repro_torch.obs import Observer, Tracer

    tracer = Tracer()
    reg = pairs_registry("cuda", N_SLOTS, Observer(trace=tracer))
    check(len(reg._wide) == 8, f"{len(reg._wide)} promoted rows, expected 8")
    n_ev = len(tracer.events())
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    health = fleet_health(reg)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ops.LAUNCHES)
    spans = {}
    for ev in tracer.events()[n_ev:]:
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur_us"] / 1e3
    for name in HEALTH_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by fleet_health")
    check(health.n_alive == N_SLOTS - len(range(50, N_SLOTS, 100)),
          "fleet_health alive count")
    check(health.fp_hist.sum() > 0, "fleet_health fp profile is empty")

    t0 = time.perf_counter()
    res = reg.all_pairs()
    torch.cuda.synchronize()
    all_pairs_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    res.to_host()
    to_host_ms = (time.perf_counter() - t0) * 1e3
    engine = res.engine
    del res

    prof = profiled(lambda: fleet_health(reg))
    prof["profiled_wall_ms"] = prof.pop("wall_ms")
    return {"launches": launches, "engine": engine, "wall_ms": wall_ms,
            "spans_ms": spans, "all_pairs_ms": all_pairs_ms,
            "to_host_ms": to_host_ms, **prof, "health": health_record(health)}


def narrow_rows(n: int) -> np.ndarray:
    """[n, M] int32 logical rows whose global value span is <= 64 (the
    mxu engine's window): equal, ancestor, descendant, forked and
    unrelated rows around one clock, offset from 0.  Row sums stay below
    2^24, where float32 is exact, so the packed engines' full-row sums
    and the int32 kernel's tile-ordered sums are identical."""
    g = np.random.default_rng(SEED + 5)
    local = g.integers(2, 60, M)
    kind = np.arange(n) % 5
    step = g.integers(-1, 2, (n, M)) * (g.random((n, M)) < 0.01)
    rows = np.repeat(local[None], n, axis=0)
    rows[kind == 1] += np.abs(step[kind == 1])
    rows[kind == 2] -= np.abs(step[kind == 2])
    rows[kind == 3] += step[kind == 3]
    rows[kind == 4] = g.integers(0, 62, ((kind == 4).sum(), M))
    return (rows + 7000).astype(np.int32)


def engines_check(dev) -> dict:
    """``CausalEngine.pairs`` with the tri, full and mxu engines on a fully
    alive 16,384 slab of span <= 64, and the i32 kernel (``pack=False``)
    on its int32 rows: flags and row sums must be identical.  Returns
    the launch counts of these four calls and the engines' wall ms."""
    import torch
    from repro_torch.causal import CausalEngine, CausalPolicy, PackedSlab
    from repro_torch.kernels import ops, pack

    rows = torch.as_tensor(narrow_rows(N_SLOTS), device=dev)
    u8, base, ok = pack.pack_rows(rows)
    check(bool(ok.all()), "narrow rows must pack")
    slab = PackedSlab(u8, base, base_host=host(base).astype(np.int64))
    torch.cuda.synchronize()
    ops.reset_launches()
    got, times = {}, {}
    for name, pol, arg in (("tri", CausalPolicy(engine="tri"), slab),
                           ("full", CausalPolicy(engine="full"), slab),
                           ("mxu", CausalPolicy(engine="mxu"), slab),
                           ("i32", CausalPolicy(pack=False), rows)):
        t0 = time.perf_counter()
        res = CausalEngine(pol).pairs(arg)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        check(res.engine == name, f"pairs asked for {name}, ran {res.engine}")
        got[name] = (res.le, res.ge, res.row_sums)
        del res
    launches = dict(ops.LAUNCHES)
    for name in ENGINE_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by pairs")
    le, ge, sums = got["tri"]
    check(bool(le.any()) and not bool(le.all()), "tri flags degenerate")
    for name, (le2, ge2, sums2) in got.items():
        check(torch.equal(le, le2) and torch.equal(ge, ge2),
              f"pairs flags: {name} differs from tri")
        check(torch.equal(sums, sums2), f"pairs row sums: {name} differs from tri")
    return {"launches": launches, "ms": times,
            "ordered_fraction": float((le | ge).float().mean())}


def health_cpu_check() -> dict:
    """``fleet_health`` at 2,048 slots on the card and on the CPU."""
    from repro_torch.fleet import fleet_health

    out = {}
    for device in ("cuda", "cpu"):
        with on(device):
            reg = pairs_registry(device, N_SLOTS_CPU)
            t0 = time.perf_counter()
            health = fleet_health(reg)
            ms = (time.perf_counter() - t0) * 1e3
            out[device] = (health, reg.all_pairs().to_host(), ms)
    (gh, gp, gms), (ch, cp, cms) = out["cuda"], out["cpu"]
    check(gp.engine == cp.engine, f"engine {gp.engine} vs {cp.engine}")
    for key in ("a_le_b", "b_le_a", "concurrent", "row_sums"):
        check_equal(gp[key], cp[key], f"all_pairs {key} at {N_SLOTS_CPU}")
    check_fp(gp.fp, cp.fp, f"all_pairs fp at {N_SLOTS_CPU}")
    check_equal(gh.component, ch.component, "fork component labels")
    check(gh.n_components == ch.n_components, "n_components")
    check_equal(gh.straggler_mask, ch.straggler_mask, "straggler mask")
    check_equal(gh.sums, ch.sums, "health sums")
    check(gh.comparable_fraction == ch.comparable_fraction, "comparable fraction")
    check_fp([gh.mean_strict_fp], [ch.mean_strict_fp], "mean strict fp")
    return {"cuda_ms": gms, "cpu_ms": cms, "engine": gp.engine,
            "health": health_record(gh)}


# ---------------------------------------------------------------------------
# phase 6: the hybrid path
# ---------------------------------------------------------------------------

def hybrid_population(rng, n_head: int, n_tail: int, n_wide: int) -> list:
    """(sid, v, events) per session in Zipf-popularity order, as
    ``benchmarks/bench_hybrid.py:_population`` builds it: one session
    equal to the local chain, tiny head sessions (v in [1, 9), 0-2
    private events), ``tail/0`` at the binding point v = 64, then
    ``n_wide`` tail sessions with 300 copies of one private event (their
    span exceeds a byte: the int32 side dict) and the other tail
    sessions (v in [64, V), 0-2 private events)."""
    from repro_torch.core.hashing import stable_event_id

    pop = [("hot/0", HYB_V, ())]
    for i in range(1, n_head):
        v, npriv = int(rng.integers(1, 9)), int(rng.integers(0, 3))
        pop.append((f"hot/{i}", v, tuple(
            stable_event_id(b"hybrid/bench-priv", i, j) for j in range(npriv))))
    pop.append(("tail/0", HYB_TAIL_V_MIN, ()))
    for w in range(n_wide):
        pop.append((f"wide/{w}", int(rng.integers(HYB_TAIL_V_MIN, HYB_V)),
                    (stable_event_id(b"hybrid/wide", w),) * 300))
    for i in range(1, n_tail):
        v, npriv = int(rng.integers(HYB_TAIL_V_MIN, HYB_V)), int(rng.integers(0, 3))
        pop.append((f"tail/{i}", v, tuple(
            stable_event_id(b"hybrid/bench-priv", n_head + i, j)
            for j in range(npriv))))
    return pop


def verify_view(view, idx_of: dict, v: np.ndarray, npriv: np.ndarray) -> dict:
    """Violations of one classify against the ground truth of
    ``bench_hybrid.py:_truth``/``_verify_view`` (a session is a v-long
    prefix of the V-long chain plus private events), vectorised.
    ``*_claimed_max`` is the largest fp of a strict verdict's claimed
    direction (what the fp budget binds); ``*_any_max`` the bench's
    larger fp of the two directions of every row, claimed or not."""
    idx = np.fromiter((idx_of[s] for s in view.sids), np.int64, len(view.sids))
    t_le, t_ge = v[idx] >= HYB_V, npriv[idx] == 0
    le, ge, hot = view.q_le_p, view.p_le_q, view.hot
    wrong = (le & ~t_le) | (ge & ~t_ge)
    claimed = np.where(le ^ ge, np.where(le, view.fp_q_before_p,
                                         view.fp_p_before_q), 0.0)
    any_dir = np.maximum(view.fp_q_before_p, view.fp_p_before_q)
    return {"fn": int(((t_le & ~le) | (t_ge & ~ge)).sum()),
            "hot_fp": int(wrong[hot].sum()), "tail_fp": int(wrong[~hot].sum()),
            "hot_any_max": float(any_dir[hot].max(initial=0.0)),
            "tail_claimed_max": float(claimed[~hot].max(initial=0.0)),
            "tail_any_max": float(any_dir[~hot].max(initial=0.0))}


_VIEW_FIELDS = ("sids", "hot", "q_le_p", "p_le_q", "sum_p", "sum_q",
                "fp_q_before_p", "fp_p_before_q", "engine")


def drive_hybrid(device: str) -> dict:
    """The hybrid path through its entry points at the slice's size (see
    the module docstring): admission, Zipf churn that promotes the head,
    fused classifies, the adaptive fold and its replay, the check against
    the ground truth and against a flat packed slab.  The launch counts
    are read before the flat-slab comparison."""
    import torch
    from repro_torch.causal import PackedSlab
    from repro_torch.hybrid import (AdaptiveConfig, AdaptivePolicy,
                                    HybridConfig, HybridEngine, derive_mk,
                                    replay_resize)
    from repro_torch.kernels import ops
    from repro_torch.obs.audit import AuditTrail

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(SEED + 8)
    pop = hybrid_population(rng, HYB_HEAD, HYB_TAIL, HYB_WIDE)
    sids = [sid for sid, _, _ in pop]
    head = sids[:HYB_HEAD]
    N = len(pop)
    idx_of = {sid: i for i, sid in enumerate(sids)}
    v_arr = np.array([v for _, v, _ in pop])
    np_arr = np.array([len(ev) for _, _, ev in pop])
    out: dict = {"times": {}, "views": [], "checks": []}
    trail = AuditTrail(store_frames=True)
    eng = HybridEngine(
        HybridConfig(m=M, k=K, hot_capacity=HYB_HEAD + HYB_MARGIN,
                     tail_capacity=1 << (N - 1).bit_length(),
                     promote_after=3, min_residency=0,
                     max_migrations_per_window=1 << 30, window=1 << 30),
        audit=trail, device=device)
    ops.reset_launches()
    eng.advance_local(HYB_V)
    t0 = time.perf_counter()
    eng.admit_many(pop)
    out["times"]["admit_s"] = time.perf_counter() - t0

    def churn_round():
        z = rng.zipf(1.1, HYB_DRAWS)
        for i in np.minimum(z - 1, N - 1):
            eng.touch(sids[i])
        for _ in range(6):
            for sid in head:
                eng.touch(sid)

    def classify(key=None):
        sync()
        t0 = time.perf_counter()
        view = eng.classify()
        if key:
            out["times"].setdefault(key, []).append(
                (time.perf_counter() - t0) * 1e3)
        out["views"].append({f: getattr(view, f) for f in _VIEW_FIELDS})
        out["checks"].append(verify_view(view, idx_of, v_arr, np_arr))
        return view

    t0 = time.perf_counter()
    for _ in range(2):
        churn_round()
        view = classify()
        check(view.engine.startswith("fused_hot_tail"),
              f"hybrid classify ran {view.engine}")
    for _ in range(10_000):
        if all(eng.sessions[s].hot for s in head):
            break
        for sid in head:
            eng.touch(sid)
    check(all(eng.sessions[s].hot for s in head), "head never fully promoted")
    out["times"]["promote_s"] = time.perf_counter() - t0
    for _ in range(3):
        classify("classify_m1024_ms")
    out["m0"] = eng.m
    out["hot_rows"], out["tail_rows"] = len(eng._hot), len(eng._t_order)

    m_want, _ = derive_mk(HYB_BUDGET, K * HYB_V, K * HYB_TAIL_V_MIN, m_max=M,
                          k=K)
    eng.adaptive = AdaptivePolicy(eng, AdaptiveConfig(fp_budget=HYB_BUDGET,
                                                      window=3))
    for _ in range(HYB_ROUNDS):
        churn_round()
        classify("classify_churn_ms")
    check(eng.resizes == 1, f"expected one adaptive resize, got {eng.resizes}")
    check(eng.m == m_want, f"resized to m={eng.m}, derived {m_want}")
    check(all(eng.sessions[s].hot for s in head), "churn displaced the head")
    rows = json.loads(next(r for r in trail.records if r.kind == "resize").detail)["rows"]
    t0 = time.perf_counter()
    rep = replay_resize(trail)
    out["times"]["replay_s"] = time.perf_counter() - t0
    check(rep.ok and rep.matched == rep.checked == rows,
          f"resize replay: {rep.summary()} of {rows} rows")
    out["replay"] = rep.summary()
    for _ in range(3):
        classify("classify_m512_ms")
    sync()
    out["launches"] = dict(ops.LAUNCHES)
    out["n_classify"] = len(out["views"])

    acc = {key: (sum if key.endswith("fp") or key == "fn" else max)(
        c[key] for c in out["checks"]) for key in out["checks"][0]}
    check(acc["fn"] == 0, f"hybrid false negatives: {acc}")
    check(acc["hot_fp"] == 0 and acc["hot_any_max"] == 0.0,
          f"hybrid hot rows not exact: {acc}")
    check(acc["tail_claimed_max"] <= HYB_BUDGET * 1.01,
          f"hybrid tail claims above the budget: {acc}")
    out["acc"] = acc

    # the tail rows against the same tail as a flat packed slab
    slab = eng.slab()
    H = slab.hot_count
    bn, bm = ops._hybrid_blocks(H + slab.cells_u8.shape[0], H, eng.m, None,
                                None, device)
    flat = eng.engine.classify(eng.local_clock(), PackedSlab(
        slab.cells_u8, slab.base, wide=slab.wide), bn=bn, bm=bm).to_host()
    last = out["views"][-1]
    for key in ("q_le_p", "p_le_q", "sum_p", "fp_q_before_p",
                "fp_p_before_q"):
        check_equal(last[key][H:], getattr(flat, key),
                    f"hybrid tail {key} vs flat packed slab")
    out["m"], out["resizes"] = eng.m, eng.resizes
    out["tail_u8"] = host(slab.cells_u8)
    out["tail_base"] = host(slab.base)
    out["eng"] = eng
    return out


def compare_hybrid(gpu: dict, cpu: dict) -> None:
    check(len(gpu["views"]) == len(cpu["views"]), "hybrid classify counts")
    for r, (g, c) in enumerate(zip(gpu["views"], cpu["views"])):
        for key in ("sids", "sum_q", "engine"):
            check(g[key] == c[key], f"hybrid view {r}: {key}")
        for key in ("hot", "q_le_p", "p_le_q", "sum_p"):
            check_equal(g[key], c[key], f"hybrid view {r} {key}")
        for key in ("fp_q_before_p", "fp_p_before_q"):
            check_fp(g[key], c[key], f"hybrid view {r} {key}")
    check(gpu["m"] == cpu["m"] and gpu["resizes"] == cpu["resizes"],
          "hybrid post-resize geometry")
    check_equal(gpu["tail_u8"], cpu["tail_u8"], "hybrid tail rows")
    check_equal(gpu["tail_base"], cpu["tail_base"], "hybrid tail bases")


def hybrid_pairs(device: str, n: int, n_head: int) -> dict:
    """``HybridEngine.pairs`` over ``n`` sessions of the same generator
    (``n_head`` in the head, 4 wide tail rows), the head promoted by
    sweeps; checks the hot-hot block against set containment computed
    here, with fp exactly 0."""
    import torch
    from repro_torch.hybrid import HybridConfig, HybridEngine
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED + 9)
    pop = hybrid_population(rng, n_head, n - n_head - HYB_WIDE, HYB_WIDE)
    eng = HybridEngine(
        HybridConfig(m=M, k=K, hot_capacity=n_head + HYB_MARGIN,
                     tail_capacity=1 << (n - 1).bit_length(), promote_after=3,
                     min_residency=0, max_migrations_per_window=1 << 30,
                     window=1 << 30), device=device)
    eng.advance_local(HYB_V)
    eng.admit_many(pop)
    head = pop[:n_head]
    for _ in range(3):
        for sid, _, _ in head:
            eng.touch(sid)
    check(list(eng._hot) == [sid for sid, _, _ in head], "pairs: head not hot")
    if device == "cuda":
        torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res, order = eng.pairs()
    if device == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ops.LAUNCHES)
    H = n_head
    vs = [v for _, v, _ in head]
    ev = [set(e) for _, _, e in head]
    want = np.array([[vs[a] <= vs[b] and ev[a] <= ev[b] for b in range(H)]
                     for a in range(H)])
    check_equal(host(res.le[:H, :H]), want, f"pairs at {n}: hot-hot le")
    check_equal(host(res.ge[:H, :H]), want.T, f"pairs at {n}: hot-hot ge")
    check(bool((res.fp[:H, :H] == 0).all()), f"pairs at {n}: hot-hot fp")
    check(res.engine.endswith("+hot_exact") and "wide_rim" in res.engine,
          f"pairs at {n}: engine {res.engine}")
    return {"res": res, "order": order, "ms": ms, "launches": launches,
            "engine": res.engine}


# ---------------------------------------------------------------------------
# phase 7: the autotuner
# ---------------------------------------------------------------------------

def occupancy_specs() -> list:
    """Every kernel instance the autotuner's model describes, as (spec,
    rect-i32's 4-byte staging): tri at its two tiles, rect-u8, rect-i32
    (both stagings) and mxu (16- and 32-bit lanes) at every tile, and
    one-vs-many (both instances; the packed one is the hybrid's) at
    every bn for the paths' m and a ragged one."""
    from repro_torch.kernels import template as tp
    out = [(tp.CompareSpec(topology="tri", bi=b, bj=b), False)
           for b in tp.TRI_TILES]
    for bi in tp.PAIR_TILES:
        for bj in tp.PAIR_TILES:
            if bi * bj > tp.PAIR_MAX_PAIRS:
                continue
            out.append((tp.CompareSpec(topology="rect", bi=bi, bj=bj), False))
            for scalar in (False, True):
                out.append((tp.CompareSpec(topology="rect", pack="i32", bi=bi,
                                           bj=bj, with_stats=True), scalar))
            for T in (64, MXU_WIDE_T):
                out.append((tp.CompareSpec(topology="mxu", bi=bi, bj=bj,
                                           with_base=True, n_thresholds=T),
                            False))
    for m in (M, SERVE_M, 1000):
        for bn in range(1, 33):
            for pack in ("u8", "i32"):
                out.append((tp.CompareSpec(topology="one_vs_many", pack=pack,
                                           bi=bn, m=m, with_base=pack == "u8",
                                           with_stats=True), False))
    return out


def check_occupancy() -> dict:
    """(a): for every instance, ``template.ctas_per_sm`` from the built
    registers equal to the runtime's occupancy, and ``smem_python`` (and
    ``smem_estimate`` on the card) equal to the library's export."""
    from repro_torch.kernels import template as tp

    regs = {}
    n = 0
    for spec, scalar in occupancy_specs():
        a = tp.c_attrs(spec, scalar)
        what = spec.label() + (" scalar" if scalar else "")
        check(a["threads"] == tp.threads_of(spec), f"{what}: threads {a}")
        check(a["smem"] == tp.smem_python(spec) == tp.smem_estimate(spec, "cuda"),
              f"{what}: shared memory {a['smem']} vs {tp.smem_python(spec)}")
        want = tp.ctas_per_sm(a["threads"], a["regs"], a["smem"], a["static_smem"])
        check(want == a["ctas"], f"{what}: model {want} CTAs an SM, runtime "
              f"{a['ctas']} ({a})")
        regs[what] = [a["regs"], a["ctas"]]
        n += 1
    a = tp.row_sums_attrs()
    check(tp.ctas_per_sm(a["threads"], a["regs"], a["smem"], a["static_smem"])
          == a["ctas"], f"row sums: {a}")
    regs["rect_i32 row sums"] = [a["regs"], a["ctas"]]
    return {"instances": n + 1, "regs_ctas": regs}


def winner_rows(dev, g, N: int, m: int, near_wrap_share: float = 0.25):
    """A query and a packed slab around it for the winner checks: equal,
    ancestor, descendant and unrelated rows; a share of the bases far
    away (large, wrapping tile sums)."""
    import torch
    q_res = g.integers(0, 200, m)
    q = torch.as_tensor(q_res + 5000, dtype=torch.int32, device=dev)
    kind = g.integers(0, 4, (N, 1))
    delta = np.abs(g.integers(-1, 2, (N, m)) * (g.random((N, m)) < 0.05))
    res = np.where(kind == 0, q_res, np.where(kind == 1, q_res + delta,
                                              np.where(kind == 2, q_res - delta,
                                                       g.integers(0, 256, (N, m)))))
    base = np.full(N, 5000, np.int64)
    far = g.random(N) < near_wrap_share
    base[far] = g.integers(-2 ** 31, 2 ** 31 - 256, int(far.sum()))
    return (q, torch.as_tensor(np.clip(res, 0, 255), dtype=torch.uint8, device=dev),
            torch.as_tensor(base, dtype=torch.int32, device=dev))


def same_rows(got: dict, want: dict, what: str, fp_bits: bool) -> float:
    """Flags and sums identical; fp bit-identical (``fp_bits``) or within
    tolerance; returns the largest fp error."""
    for key in ("q_le_p", "p_le_q", "sum_p", "sum_q"):
        check_equal(host(got[key]), host(want[key]), f"{what} {key}")
    e = 0.0
    for key in ("fp_q_before_p", "fp_p_before_q"):
        if fp_bits:
            check_equal(host(got[key]).view(np.uint32),
                        host(want[key]).view(np.uint32), f"{what} {key} bits")
        else:
            e = max(e, check_fp(got[key], want[key], f"{what} {key}"))
    return e


def check_winner(dev, g, key: str, cfg: dict) -> None:
    """(c): the kernel at the winner's blocks against its plain version
    at the same blocks (flags, sums identical; fp within tolerance) and
    against the default blocks (flags identical; sums and fp
    bit-identical at equal bm)."""
    import torch
    from repro_torch.kernels import ops, ref

    op, _, n_b, h_b, m_b, _ = key.split("|")
    if op in ("one_vs_many", "hybrid"):
        bn, bm = cfg["bn"], cfg["bm"]
        dbn, dbm = ops.OVM_BLOCKS
        N, m = int(n_b[1:]), int(m_b[1:])
        if op == "one_vs_many":
            q, peers, base = winner_rows(dev, g, N, m)
            run = lambda bn, bm: ops._classify_vs_many_packed(  # noqa: E731
                q, peers, base, bn=bn, bm=bm, use_autotune=False)
            plain = ops._classify_dict(*ref.one_vs_many_ref(
                q, peers, base, bm=ops.tile_width(m, bm)))
        else:
            H = int(h_b[1:])
            q, V, meta, hs, tail, base = hybrid_inputs(g, H, N - H, m, dev)
            run = lambda bn, bm: ops._classify_hybrid(  # noqa: E731
                q, V, meta, hs, tail, base, bn=bn, bm=bm, use_autotune=False)
            plain = ops._classify_dict(*ref.hybrid_classify_ref(
                q, V, meta, hs, tail, base, bm=ops.tile_width(m, bm)))
        got = run(bn, bm)
        same_rows(got, plain, f"{key} winner vs plain", fp_bits=False)
        dflt = run(dbn, dbm)
        same_bm = ops.tile_width(m, bm) == ops.tile_width(m, dbm)
        for k in ("q_le_p", "p_le_q"):
            check_equal(host(got[k]), host(dflt[k]), f"{key} winner vs default {k}")
        if same_bm:
            same_rows(got, dflt, f"{key} winner vs default", fp_bits=True)
        return
    # matrix: the winner's engine at its blocks on a 2,048-row slab
    N, m = N_SLOTS_CPU, int(m_b[1:])
    engine, bi, bj, bm = cfg["engine"], cfg["bi"], cfg["bj"], cfg["bm"]
    dbi, dbj, dbm = ops.MATRIX_BLOCKS
    if engine == "i32":
        rows = torch.as_tensor(g.integers(-2 ** 31, 2 ** 31, (N, m)),
                               dtype=torch.int32, device=dev)
        col_sums = ref.wrap_sum_i32(rows).to(torch.float32)
        got = ops.rect_i32_stats(rows, rows, col_sums, bi=bi, bj=bj, bm=bm)
        want = ref.rect_i32_stats_ref(rows, rows, col_sums,
                                      bm=ops.tile_width(m, bm))
        dflt = ops.rect_i32_stats(rows, rows, col_sums, bi=dbi, bj=dbj, bm=dbm)
        for i, what in enumerate(("le", "ge", "row sums")):
            check_equal(host(got[i]), host(want[i]), f"{key} {what} vs plain")
        check_fp(got[3], want[3], f"{key} fp vs plain")
        flags = (got[0], got[1])
        dflags = (dflt[0], dflt[1])
        if ops.tile_width(m, bm) == ops.tile_width(m, dbm):
            check_equal(host(got[2]), host(dflt[2]), f"{key} row sums vs default")
            check_equal(host(got[3]).view(np.uint32), host(dflt[3]).view(np.uint32),
                        f"{key} fp bits vs default")
    elif engine == "tri":
        cells, base = (torch.as_tensor(x, device=dev) for x in pair_inputs(g, N, m))
        flags = ops.tri_flags(cells, base, bt=bi)
        want = ref.tri_flags_ref(cells, base)
        dflags = ops.tri_flags(cells, base, bt=dbi)
        for i in range(2):
            check_equal(host(flags[i]), host(want[i]), f"{key} flags vs plain")
    else:  # mxu
        T = 32
        rows, cols, rb, cb = (torch.as_tensor(x, device=dev)
                              for x in mxu_inputs(g, N, N, m, T, 5000))
        flags = (ops.mxu_viol(rows, cols, rb, cb, lo=5000, n_thresholds=T,
                              bi=bi, bj=bj),)
        want = ref.mxu_viol_ref(rows, cols, rb, cb, lo=5000, n_thresholds=T)
        dflags = (ops.mxu_viol(rows, cols, rb, cb, lo=5000, n_thresholds=T,
                               bi=dbi, bj=dbj),)
        check_equal(host(flags[0]), host(want), f"{key} counts vs plain")
    for i in range(len(flags)):
        check_equal(host(flags[i]), host(dflags[i]), f"{key} vs default blocks")


def drive_autotune(dev) -> dict:
    """(a) occupancy and shared memory, (b) the sweep into a temporary
    table with its ``[autotune]`` lines, (c) the winners' checks; the
    committed table is neither read nor written here."""
    from repro_torch.kernels import autotune

    t0 = time.perf_counter()
    occ = check_occupancy()
    print(f"[autotune] (a) occupancy model = cudaOccupancyMaxActiveBlocksPerMultiprocessor "
          f"and shared memory = the libraries' exports for {occ['instances']} "
          f"instances: registers and CTAs an SM {json.dumps(occ['regs_ctas'])}")
    t_occ = time.perf_counter() - t0
    explains: dict = {}
    shapes = [autotune.parse_size(s) for s in autotune.DEFAULT_SIZES]
    before = dict(autotune.SEARCH_STATS)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        results = autotune.autotune_shapes(shapes, device=dev, explains=explains)
        path = autotune.save_table(results, pathlib.Path(d) / "table.json")
        check(json.loads(path.read_text()).keys() == results.keys(),
              "temporary table round trip")
    t_sweep = time.perf_counter() - t1
    out = {}
    for key, cfg in sorted(results.items()):
        exp = explains[key]
        win = {k: v for k, v in cfg.items() if k != "us"}
        print(f"[autotune] {key} winner {json.dumps(win)} {cfg['us']} us default "
              f"{json.dumps(exp['default'])} {exp['default_us']} us model_rank "
              f"{exp['winner_rank']}/{exp['grid']} survivors "
              f"{exp['survivors']}/{exp['grid']}")
        out[key] = {"winner": win, "us": cfg["us"], "default_us": exp["default_us"],
                    "rank": exp["winner_rank"], "grid": exp["grid"],
                    "survivors": exp["survivors"],
                    "measured": exp["measured"]}
    g = np.random.default_rng(SEED + 30)
    for key, cfg in sorted(results.items()):
        check_winner(dev, g, key, cfg)
    print(f"[autotune] (c) every winner identical to its plain version at its "
          f"blocks and to the default blocks; occupancy {t_occ:.1f} s, sweep "
          f"{t_sweep:.1f} s, search {json.dumps({k: autotune.SEARCH_STATS[k] - before[k] for k in before})}")
    return out


def dispatch_lines(gpu: dict, hot: int, tail: int) -> dict:
    """(d): the engine and blocks each path resolves from the committed
    table (the resolvers the paths call, at the paths' shapes); the main
    path's classify must have dispatched the same."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ChurnConfig

    tc = ChurnConfig()
    res = {
        "main one_vs_many N=65536 m=1024": dict(zip(
            ("bn", "bm"), ops._one_vs_many_blocks(N_PEERS, M, None, None, "cuda"))),
        f"hybrid N={hot + tail} H={hot} m={M}": dict(zip(
            ("bn", "bm"), ops._hybrid_blocks(hot + tail, hot, M, None, None,
                                             "cuda"))),
        f"serving tiers pin N={tc.hot_capacity + tc.warm_capacity} m={SERVE_M}":
            dict(zip(("bn", "bm"), ops._one_vs_many_blocks(
                tc.hot_capacity + tc.warm_capacity, SERVE_M, None, None, "cuda"))),
    }
    from repro_torch.kernels import autotune
    cfg = autotune.lookup("matrix", N_SLOTS, N_SLOTS, M, "cuda") or {}
    engine = cfg.get("engine", "tri")
    engine = "tri" if engine == "i32" else engine
    res[f"all-pairs N={N_SLOTS} m={M} (symmetric)"] = dict(zip(
        ("engine", "bi", "bj", "bm"),
        (engine, *ops._matrix_blocks(engine, N_SLOTS, N_SLOTS, M, None, None,
                                     None, "cuda"))))
    res[f"all-pairs N={N_SLOTS} m={M} (rectangle)"] = dict(zip(
        ("engine", "bi", "bj", "bm"),
        ("full" if engine == "tri" else engine,
         *ops._matrix_blocks("full" if engine == "tri" else engine, N_SLOTS,
                             N_SLOTS, M, None, None, None, "cuda"))))
    for what, r in res.items():
        print(f"[dispatch] {what}: {json.dumps(r)}")
    main = res["main one_vs_many N=65536 m=1024"]
    d = gpu["dispatch"]
    check(d.get("bn") == main["bn"] and d.get("bm") == main["bm"],
          f"the main path dispatched {d}, the table resolves {main}")
    return res


# ---------------------------------------------------------------------------
# phase 9: times
# ---------------------------------------------------------------------------

def events_ms(fn, n_buf: int, *, queued: bool, iters: int = 50,
              warmup: int = 5) -> float:
    """Mean ms per call of ``fn(i)`` on the card's clock: CUDA events
    around ``iters`` calls cycling ``n_buf`` input buffers, after a
    warm-up.  ``queued`` puts a sleep kernel ahead of the loop, so the
    host has queued every call before the card reaches the first and the
    time is the card's alone; without it, host gaps between calls count
    (the cost to a caller)."""
    import torch
    for i in range(warmup):
        fn(i % n_buf)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(iters):
        fn(i % n_buf)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(fn, n_buf: int, iters: int = 50, warmup: int = 5) -> dict:
    """Device ms (queued) and call ms (not queued) of one function: the
    one rule for kernels, plain versions and library calls alike."""
    return {"ms": events_ms(fn, n_buf, queued=True, iters=iters, warmup=warmup),
            "call_ms": events_ms(fn, n_buf, queued=False, iters=iters,
                                 warmup=0)}


def n_buffers(nbytes: float) -> int:
    """Buffers to cycle so that the set is at least twice the L2."""
    return max(2, int(np.ceil(2 * L2_BYTES / nbytes)))


def time_kernels(dev, n_wide: int) -> dict:
    """For each kernel at the main path's shapes: the kernel's device
    time, its wrapper's call time, the plain version's and (tick) the
    library call's, with the bytes and operations its function needs."""
    import torch
    from repro_torch.core.hashing import bloom_indices
    from repro_torch.kernels import ops, ref

    g = np.random.default_rng(SEED + 2)
    bm = ops.tile_width(M, 512)
    rec = {}

    def entry(kernel_fn, plain_fn, nb, nbytes, n_ops, library_ms=None, **extra):
        k = measure(kernel_fn, nb)
        p = measure(plain_fn, nb, iters=10)
        return dict(ms=k["ms"], call_ms=k["call_ms"], plain_ms=p["ms"],
                    plain_call_ms=p["call_ms"], library_ms=library_ms,
                    bytes=nbytes, ops=n_ops, **extra)

    # tick: B=4096 clocks, E=16 events, k=4 -> P=64 probes per clock (the
    # serving tier's batched tick, the record's shape), then the main
    # path's B=1, E=1 -> P=4, whose cells sit in L2 (one tick writes what
    # the next reads), so 2 buffers.  Two library calls: in-place
    # scatter_add_ (touches only the probed sectors) and out-of-place
    # torch.scatter_add (new cells, as the function returns); the record
    # takes the faster.
    for B, E in ((4096, 16), (1, 1)):
        P = E * K
        nbytes = B * M * 4 * 2 + B * P * 4
        nb = n_buffers(nbytes) if B > 1 else 2
        cells = [torch.as_tensor(g.integers(0, 1000, (B, M)), dtype=torch.int32,
                                 device=dev) for _ in range(nb)]
        ev = g.integers(0, 2 ** 32, (2, B, E), dtype=np.uint64).astype(np.int64)
        probes = [bloom_indices(ev[0], ev[1], K, M, device=dev)
                  .reshape(B, -1).to(torch.int32).contiguous() for _ in range(nb)]
        probes64 = [p.to(torch.int64) for p in probes]
        ones = torch.ones((B, P), dtype=torch.int32, device=dev)
        lib_in = measure(lambda i: cells[i].scatter_add_(1, probes64[i], ones), nb)["ms"]
        lib_out = measure(lambda i: torch.scatter_add(cells[i], 1, probes64[i], ones),
                          nb)["ms"]
        r = entry(lambda i: ops.tick_probes(cells[i], probes[i]),
                  lambda i: ref.bloom_tick_ref(cells[i], probes[i]), nb, nbytes,
                  B * M + B * P, library_ms=min(lib_in, lib_out), B=B, P=P,
                  scatter_add_ms=lib_in, scatter_add_out_ms=lib_out)
        if B > 1:
            rec["bloom_tick"] = r
        else:
            rec["bloom_tick"]["main_shape"] = r
        del cells, probes, probes64

    # merge_compare: B=4096 pairs of m=1024 int32 rows (the record), then
    # the main path's B=1 (every receive compares one row pair), 2 buffers
    # as the B=1 tick; each row writes 2 bytes of flags and 16 of sums
    # and fp
    for B in (4096, 1):
        nbytes = B * M * 4 * 3 + B * ROW_OUT_BYTES
        nb = n_buffers(nbytes) if B > 1 else 2
        ab = [(torch.as_tensor(g.integers(0, 400, (B, M)), dtype=torch.int32, device=dev),
               torch.as_tensor(g.integers(0, 400, (B, M)), dtype=torch.int32, device=dev))
              for _ in range(nb)]
        r = entry(lambda i: ops.merge_compare(*ab[i]),
                  lambda i: ref.bloom_merge_compare_ref(*ab[i], bm=bm), nb, nbytes,
                  B * M * 5, B=B)
        if B > 1:
            rec["bloom_merge_compare"] = r
        else:
            rec["bloom_merge_compare"]["main_shape"] = r
        del ab

    # one-vs-many packed: the registry slab, N=65,536 rows of m=1024
    N = N_PEERS
    nbytes = N * M + N * 4 + M * 4 + N * ROW_OUT_BYTES
    nb = n_buffers(nbytes)
    q = torch.as_tensor(g.integers(0, 200, M) + 5000, dtype=torch.int32, device=dev)
    slabs = [(torch.as_tensor(g.integers(0, 256, (N, M)), dtype=torch.uint8, device=dev),
              torch.full((N,), 5000, dtype=torch.int32, device=dev))
             for _ in range(nb)]
    blocks = ops._one_vs_many_blocks(N, M, None, None, "cuda")
    rec["one_vs_many_packed"] = entry(
        lambda i: ops._classify_vs_many_packed(q, *slabs[i]),
        lambda i: ref.one_vs_many_ref(q, *slabs[i], bm=blocks[1]), nb, nbytes,
        N * M * 5, blocks=blocks, default_ms=measure(
            lambda i: ops._classify_vs_many_packed(q, *slabs[i], bn=ops.OVM_BLOCKS[0],
                                                   bm=ops.OVM_BLOCKS[1]), nb)["ms"])
    del slabs

    # one-vs-many i32: the promoted-row overlay, at the main path's
    # count of promoted rows
    N = max(n_wide, 1)
    nbytes = N * M * 4 + M * 4 + N * ROW_OUT_BYTES
    rows = torch.as_tensor(g.integers(0, 400, (N, M)), dtype=torch.int32, device=dev)
    rec["one_vs_many_i32"] = entry(
        lambda i: ops._classify_vs_many(q, rows),
        lambda i: ref.one_vs_many_ref(q, rows, bm=bm), 1, nbytes, N * M * 4,
        rows=N)
    return rec


def time_pair_kernels(dev, sass: dict) -> dict:
    """The all-pairs kernels at the slice's N = M = 16,384, m = 1024: device
    time, the plain version's, and for mxu a bf16 tensor-core product of
    the thermometer-encoded operands with float32 output (the TPU
    kernel's formulation, computing the same counts), with the bytes and
    instructions each function needs: per (pair, lane) the lower of
    ``MIN_OPS`` and the built kernel's hot loop (``sass``), and for mxu
    the tensor-core formulation's operations beside them; rect-i32 once
    more on slabs that fit in L2."""
    import torch
    from repro_torch.kernels import ops, ref

    g = np.random.default_rng(SEED + 6)
    N, m = N_SLOTS, M
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    slabs = [tuple(t(x) for x in pair_inputs(g, N, m)) for _ in range(2)]
    rec = {}

    def entry(name, kernel_fn, plain_fn, nbytes, lane_pairs, extra_ops=0,
              library_fns=None, tensor_ops=None):
        k = measure(kernel_fn, 2, iters=5, warmup=1)
        # the plain versions take seconds a call: one timed call each way
        p = measure(plain_fn, 2, iters=1, warmup=1)
        libs = {lib: measure(fn, 1, iters=3, warmup=1)["ms"]
                for lib, fn in (library_fns or {}).items()}
        per_pair = min(sass[name]["alu"], MIN_OPS[name])
        rec[name] = dict(ms=k["ms"], call_ms=k["call_ms"], plain_ms=p["ms"],
                         plain_call_ms=p["call_ms"],
                         library_ms=min(libs.values()) if libs else None,
                         libraries=libs, bytes=nbytes,
                         ops=lane_pairs * per_pair + extra_ops,
                         ops_per_pair=per_pair, tensor_ops=tensor_ops)

    flags = 2 * N * N
    entry("matrix_tri", lambda i: ops.tri_flags(*slabs[i]),
          lambda i: ref.tri_flags_ref(*slabs[i]), N * m + N * 4 + flags,
          N * (N + 1) // 2 * m)
    # the 32 x 32 instance, which pairs runs when asked for 32-row tiles
    k = measure(lambda i: ops.tri_flags(*slabs[i], bt=32), 2, iters=5, warmup=1)
    rec["matrix_tri"]["bt32"] = dict(ms=k["ms"], call_ms=k["call_ms"])
    entry("matrix_rect_u8",
          lambda i: ops.rect_u8_flags(slabs[i][0], slabs[1 - i][0], slabs[i][1],
                                      slabs[1 - i][1]),
          lambda i: ref.rect_u8_flags_ref(slabs[i][0], slabs[1 - i][0],
                                          slabs[i][1], slabs[1 - i][1]),
          2 * N * m + 2 * N * 4 + flags, N * N * m)
    i32 = [c.to(torch.int32) + b[:, None] for c, b in slabs]
    sums = [ref.wrap_sum_i32(x).to(torch.float32) for x in i32]
    bm = ops.tile_width(m, 512)
    entry("matrix_rect_i32",
          lambda i: ops.rect_i32_stats(i32[i], i32[1 - i], sums[1 - i]),
          lambda i: ref.rect_i32_stats_ref(i32[i], i32[1 - i], sums[1 - i], bm=bm),
          2 * N * m * 4 + N * 4 + flags + N * 4 + N * N * 4, N * N * m,
          extra_ops=N * m)
    # the same kernel on slabs that fit in L2 together (34 MB), 66 x 64
    # tiles (a whole number of waves of the ~264 resident blocks): its
    # time per pair and lane beside the one above says what share of the
    # 16,384 x 16,384 time L2 misses take
    rows_l2, cols_l2 = i32[0][:L2_ROWS[0]], i32[1][:L2_ROWS[1]]
    t_l2 = measure(lambda i: ops.rect_i32_stats(rows_l2, cols_l2, sums[1][:L2_ROWS[1]]),
                   1, iters=5, warmup=1)["ms"]
    rec["matrix_rect_i32"]["l2_resident"] = dict(
        ms=t_l2, N=L2_ROWS[0], M=L2_ROWS[1],
        slab_bytes=(L2_ROWS[0] + L2_ROWS[1]) * m * 4,
        ps_per_pair_lane=t_l2 * 1e9 / (L2_ROWS[0] * L2_ROWS[1] * m),
        full_ps_per_pair_lane=rec["matrix_rect_i32"]["ms"] * 1e9 / (N * N * m))
    del i32, sums
    T, lo = 64, -123457
    win = [(c % (T - 4), t(lo + g.integers(0, 4, N).astype(np.int32)))
           for c, _ in slabs]
    thr = torch.arange(1, T + 1, device=dev, dtype=torch.int32)
    vals = [(c.to(torch.int32) + (b - lo)[:, None]) for c, b in win]
    enc_a = (vals[0][:, :, None] >= thr).reshape(N, -1).to(torch.bfloat16)
    enc_b = (vals[1][:, :, None] < thr).reshape(N, -1).to(torch.bfloat16)
    del vals
    viol = ops.mxu_viol(win[0][0], win[1][0], win[0][1], win[1][1], lo=lo,
                        n_thresholds=T)
    lib = torch.mm(enc_a, enc_b.T, out_dtype=torch.float32)
    check(torch.equal(lib, viol), "mxu: the thermometer product's counts "
          "differ from the kernel's")
    del lib
    # the same 0/1 operands in int8 with int32 output (torch._int_mm), where
    # it takes them
    libraries = {"bf16 torch.mm": lambda i: torch.mm(enc_a, enc_b.T,
                                                     out_dtype=torch.float32)}
    enc_a8, enc_b8 = enc_a.to(torch.int8), enc_b.to(torch.int8)
    try:
        lib = torch._int_mm(enc_a8, enc_b8.T)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"[time] matrix_mxu: torch._int_mm refused the int8 thermometer "
              f"operands ({str(e).splitlines()[0]}); bf16 torch.mm alone")
    else:
        check(torch.equal(lib.to(torch.float32), viol), "mxu: the int8 "
              "thermometer product's counts differ from the kernel's")
        libraries["int8 torch._int_mm"] = lambda i: torch._int_mm(enc_a8, enc_b8.T)
        del lib
    del viol
    # the TPU kernel's formulation on int8 tensor cores: one multiply-add
    # per pair, lane and threshold
    entry("matrix_mxu",
          lambda i: ops.mxu_viol(win[i][0], win[1 - i][0], win[i][1],
                                 win[1 - i][1], lo=lo, n_thresholds=T),
          lambda i: ref.mxu_viol_ref(win[i][0], win[1 - i][0], win[i][1],
                                     win[1 - i][1], lo=lo, n_thresholds=T),
          2 * N * m + 2 * N * 4 + N * N * 4, N * N * m,
          library_fns=libraries, tensor_ops=2 * N * N * m * T)
    # above MXU_T_MAX: the 32-bit-lane kernel at N = M = 4096, T = 8192,
    # bases spread over the window so that counts are mostly non-zero;
    # its bound counts mxu_wide_min_ops(T) instructions a pair and lane
    Nw, T, lo = N_SLOTS // 4, MXU_WIDE_T, -123457
    wide = [(c[:Nw], t(lo + g.integers(0, T - 255, Nw).astype(np.int32)))
            for c, _ in slabs]
    kw = dict(lo=lo, n_thresholds=T)
    got = ops.mxu_viol(wide[0][0], wide[1][0], wide[0][1], wide[1][1], **kw)
    want = ref.mxu_viol_ref(wide[0][0], wide[1][0], wide[0][1], wide[1][1], **kw)
    check(torch.equal(got, want), f"mxu T={T}: the kernel differs from the plain version")
    check(bool((got > 0).any()) and bool((got == 0).any()),
          f"mxu T={T}: counts all zero or none zero")
    del got, want
    k = measure(lambda i: ops.mxu_viol(wide[i][0], wide[1 - i][0], wide[i][1],
                                       wide[1 - i][1], **kw), 2, iters=5, warmup=1)
    p = measure(lambda i: ref.mxu_viol_ref(wide[i][0], wide[1 - i][0], wide[i][1],
                                           wide[1 - i][1], **kw), 2, iters=2, warmup=1)
    rec["matrix_mxu"]["wide_t"] = dict(
        ms=k["ms"], call_ms=k["call_ms"], plain_ms=p["ms"], N=Nw, m=m, T=T,
        bytes=2 * Nw * m + 2 * Nw * 4 + Nw * Nw * 4,
        ops=mxu_wide_min_ops(T) * Nw * Nw * m, ops_per_pair=mxu_wide_min_ops(T))
    return rec


def time_hybrid(dev, H: int, T: int) -> dict:
    """The hybrid kernel at the path's H hot and T tail rows, m = 1024:
    its device time at the blocks the path resolves and at the default
    blocks, the plain version's, and the packed one-vs-many
    kernel's on the same tail, with the bytes the function must move
    (tail T·m + 4T, hot metadata and sums 12H, outputs 18(H+T), query
    4m)."""
    from repro_torch.kernels import ops, ref

    g = np.random.default_rng(SEED + 10)
    bn, bm = ops._hybrid_blocks(H + T, H, M, None, None, "cuda")
    nbytes = T * M + 4 * T + 12 * H + ROW_OUT_BYTES * (H + T) + 4 * M
    nb = n_buffers(nbytes)
    bufs = [hybrid_inputs(g, H, T, M, dev) for _ in range(nb)]
    k = measure(lambda i: ops.hybrid(*bufs[i], bn=bn, bm=bm), nb)
    d = measure(lambda i: ops.hybrid(*bufs[i]), nb)
    p = measure(lambda i: ref.hybrid_classify_ref(
        *bufs[i], bm=ops.tile_width(M, bm)), nb, iters=10)
    o = measure(lambda i: ops._classify_vs_many_packed(bufs[i][0], bufs[i][4],
                                                       bufs[i][5]), nb)
    return dict(ms=k["ms"], call_ms=k["call_ms"], plain_ms=p["ms"],
                plain_call_ms=p["call_ms"], library_ms=None, bytes=nbytes,
                ops=T * M * 5, packed_ms=o["ms"], packed_call_ms=o["call_ms"],
                hot=H, tail=T, blocks=(bn, bm), default_ms=d["ms"])


# ---------------------------------------------------------------------------
# phase 8: the serving path
# ---------------------------------------------------------------------------

# the serving tier at ChurnConfig()'s defaults (src/repro/serve/churn.py:58-77,
# bench_serve's full run, benchmarks/bench_serve.py:203-208): m = 256, k = 4;
# a step mints a quarter of its 15,625 arrivals (~3,906) with P = 3 private
# events each in one batched tick, and the replica ticks 4 events (B = 1)
SERVE_M = 256
SERVE_MINT = (3906, 3)
SERVE_REPLICA = (1, 4)
#: one-vs-many slabs of the path: a pipeline batch, the hot tier, a cold
#: chunk, the warm tier
SERVE_OVM_N = (256, 4096, 16384, 65536)
#: hot + warm capacity, the N at which the tiers pin their blocks
SERVE_PIN_N = 4096 + 65536
SERVE_KERNELS = ("bloom_tick", "one_vs_many_packed", "one_vs_many_i32")
#: the churn's run, cut for the script's time limit to an eighth of
#: ChurnConfig()'s 1,000,000 sessions over an eighth of its 64 steps: the
#: same 15,625 arrivals, queries and migrations a step, 8 steps (~89,000
#: stored sessions: the hot and warm tiers full, the rest cold)
SERVE_CHURN = dict(sessions=125_000, steps=8)
#: churn report fields that do not depend on thread timing (batch
#: boundaries move cache hits, latencies, qps and so promotions and the
#: tier counts); the final stored clocks are compared by ``stored_crc``
SERVE_DETERMINISTIC = ("sessions", "admitted", "rejected", "queries",
                       "migrations", "expiries", "fn_violations",
                       "concurrent_seen", "measured_fp")


def serve_tick_inputs(g, B: int, E: int, dev):
    """[B, m] int32 cells (one row at INT32_MAX) and the [B, E·k] probes
    of E hashed events a row, at m = 256."""
    import torch
    from repro_torch.core.hashing import bloom_indices

    cells = torch.as_tensor(g.integers(0, 1000, (B, SERVE_M)), dtype=torch.int32,
                            device=dev)
    cells[0, :] = torch.iinfo(torch.int32).max
    ev = g.integers(0, 2 ** 32, (2, B, E), dtype=np.uint64).astype(np.int64)
    probes = bloom_indices(ev[0], ev[1], K, SERVE_M, device=dev)
    return cells, probes.reshape(B, -1).to(torch.int32).contiguous()


def serve_slab(g, N: int, dev):
    """A query and N packed rows around it at m = 256: ancestors,
    descendants and unrelated rows, bases at the query's and anywhere."""
    import torch

    q_res = g.integers(0, 200, SERVE_M)
    delta = g.integers(-1, 2, (N, SERVE_M)) * (g.random((N, SERVE_M)) < 0.05)
    kind = g.integers(0, 3, (N, 1))
    res = np.where(kind == 0, q_res + np.abs(delta),
                   np.where(kind == 1, q_res - np.abs(delta),
                            g.integers(0, 256, (N, SERVE_M))))
    base = np.where(kind[:, 0] < 2, 5000, g.integers(-2 ** 31, 2 ** 31 - 256, N))
    return (torch.as_tensor(q_res + 5000, dtype=torch.int32, device=dev),
            torch.as_tensor(np.clip(res, 0, 255), dtype=torch.uint8, device=dev),
            torch.as_tensor(base, dtype=torch.int32, device=dev))


def check_serve_kernels(dev) -> dict:
    """The tick and one-vs-many at the serving path's shapes against
    their plain versions: cells, flags and sums identical, fp within
    tolerance."""
    import torch
    from repro_torch.causal import CausalEngine, PackedSlab
    from repro_torch.kernels import ops, ref

    g = np.random.default_rng(SEED + 20)
    err = {k: 0.0 for k in SERVE_KERNELS}
    for B, E in (SERVE_MINT, SERVE_REPLICA):
        cells, probes = serve_tick_inputs(g, B, E, dev)
        got = ops.tick_probes(cells, probes)
        check_equal(host(got), host(ref.bloom_tick_ref(cells, probes)),
                    f"serve tick B={B} P={E} events m={SERVE_M}")
    for N in SERVE_OVM_N:
        q, peers, base = serve_slab(g, N, dev)
        bm = ops._one_vs_many_blocks(N, SERVE_M, None, None, "cuda")[1]
        err["one_vs_many_packed"] = max(err["one_vs_many_packed"], compare_ovm(
            f"serve packed N={N} m={SERVE_M}",
            lambda p, b: ops._classify_vs_many_packed(q, p, b), q, peers, base,
            bm))
    # a pipeline batch with rim rows: the packed call plus the exact i32
    # overlay of its wide rows, the card against the CPU's plain versions
    q, peers, base = serve_slab(g, 256, dev)
    wide = {i: (g.integers(0, 70000, SERVE_M) + 5000).astype(np.int32)
            for i in (0, 3, 77, 255)}
    wide[3][:] = np.iinfo(np.int32).max - g.integers(0, 50, SERVE_M)
    rows = torch.as_tensor(np.stack([wide[i] for i in sorted(wide)]), device=dev)
    err["one_vs_many_i32"] = compare_ovm(
        f"serve i32 N={len(wide)} m={SERVE_M}",
        lambda p, b: ops._classify_vs_many(q, p), q, rows, None)
    eng = CausalEngine()
    got = eng.classify(q, PackedSlab(peers, base, wide=wide)).to_host()
    with card_blocks():
        want = eng.classify(q.cpu(), PackedSlab(peers.cpu(), base.cpu(),
                                                wide=wide)).to_host()
    check(got.engine == want.engine == "packed+wide_overlay",
          f"serve overlay engine {got.engine}")
    for key in ("q_le_p", "p_le_q", "sum_p", "sum_q"):
        check_equal(getattr(got, key), getattr(want, key), f"serve overlay {key}")
    for key in ("fp_q_before_p", "fp_p_before_q"):
        err["one_vs_many_i32"] = max(err["one_vs_many_i32"], check_fp(
            getattr(got, key), getattr(want, key), f"serve overlay {key}"))
    print(f"[kernels] serving shapes (m={SERVE_M}): tick at B={SERVE_MINT[0]} "
          f"x {SERVE_MINT[1]} events and B=1 x {SERVE_REPLICA[1]}, packed "
          f"one-vs-many at N={list(SERVE_OVM_N)}, a 256-row batch with 4 wide "
          f"rows through the i32 overlay: identical to the plain versions, "
          f"fp within tolerance")
    return err


def flat_check(tiers, replica) -> dict:
    """``TieredRegistry.classify`` over every stored session against one
    flat ``ClockRegistry`` on the card holding the same clocks under the
    same pinned policy: statuses and sums identical, fp bit-identical."""
    import dataclasses
    import torch
    from repro_torch.core import clock as bc
    from repro_torch.fleet.registry import ClockRegistry
    from repro_torch.kernels import pack

    t0 = time.perf_counter()
    sids = tiers.sids()
    rows = np.empty((len(sids), tiers.m), np.int32)
    at, slots = [], []
    for i, sid in enumerate(sids):
        cells, slot = tiers.stored_row(sid)
        if cells is None:
            at.append(i)
            slots.append(slot)
        else:
            rows[i] = cells
    idx = torch.as_tensor(slots, device=tiers.device)
    rows[at] = host(pack.unpack_rows(tiers.hot.cells_u8[idx], tiers.hot.base[idx]))
    flat = ClockRegistry(capacity=len(sids), m=tiers.m, k=tiers.k,
                         policy=dataclasses.replace(tiers.policy, observer=None),
                         device=tiers.device)
    zero = torch.zeros((), dtype=torch.int32)
    for lo in range(0, len(sids), 65536):
        flat.admit_many({sids[i]: bc.BloomClock(cells=torch.from_numpy(rows[i]),
                                                base=zero, k=tiers.k)
                         for i in range(lo, min(lo + 65536, len(sids)))})
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    view = tiers.classify(replica)
    tiered_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fv = flat.classify_all(replica)
    flat_ms = (time.perf_counter() - t0) * 1e3
    check(view.sids == sids, "tiered classify session order")
    fslots = np.fromiter((flat.slot_of(s) for s in sids), np.int64, len(sids))
    check_equal(view.status, fv.status[fslots], "tiered vs flat statuses")
    check_equal(view.sums, fv.sums[fslots], "tiered vs flat sums")
    check_equal(view.fp.view(np.uint32), fv.fp[fslots].view(np.uint32),
                "tiered vs flat fp bits")
    return {"sessions": len(sids), "tiers": view.tier_counts(),
            "counts": view.counts(), "engine": view.engine,
            "flat_build_s": build_s, "tiered_classify_ms": tiered_ms,
            "flat_classify_ms": flat_ms}


def span_totals(events) -> dict:
    out: dict = {}
    for ev in events:
        n, ms = out.get(ev["name"], (0, 0.0))
        out[ev["name"]] = (n + 1, ms + ev["dur_us"] / 1e3)
    return {k: {"n": n, "ms": ms} for k, (n, ms) in sorted(out.items())}


def drive_serve() -> dict:
    """The full churn on the card with the launch counts reset just
    before it and read just after; then the flat-slab check on its final
    store."""
    from repro_torch.kernels import ops
    from repro_torch.obs import Observer, Tracer
    from repro_torch.serve import ChurnConfig, run_churn

    tracer = Tracer()
    out: dict = {}

    def inspect(tiers, replica):
        out["launches"] = {k: ops.LAUNCHES[k] for k in SERVE_KERNELS}
        out["spans"] = span_totals(tracer.events())
        n_run = len(tracer.events())
        out["flat"] = flat_check(tiers, replica)
        out["flat"]["spans"] = span_totals(tracer.events()[n_run:])

    ops.reset_launches()
    t0 = time.perf_counter()
    report = run_churn(ChurnConfig(**SERVE_CHURN),
                       observer=Observer(trace=tracer),
                       device="cuda", inspect=inspect)
    out["process_s"] = time.perf_counter() - t0
    out["report"] = report.to_dict()
    check(report.fn_violations == 0,
          f"serve churn: {report.fn_violations} false negatives")
    check(report.tier_counts.get("cold", 0) > 0, "serve churn: cold tier empty")
    for kname in ("bloom_tick", "one_vs_many_packed"):
        check(out["launches"][kname] > 0,
              f"kernel {kname} was not launched on the serving path")
    return out


def stored_crc(tiers) -> int:
    """CRC32 over every stored session's id and logical cells, in
    session order: equal CRCs mean equal final clocks."""
    import zlib
    from repro_torch.core import wire

    crc = 0
    for sid in sorted(tiers.sids(), key=lambda s: int(s[1:])):
        cells = host(tiers.get(sid, count=False).logical_cells())
        crc = zlib.crc32(f"{sid}:{wire.cells_crc(cells)};".encode(), crc)
    return crc


def serve_quick() -> dict:
    """``ChurnConfig.quick()`` (audited) on the card and on the CPU: the
    deterministic fields and the CRC of every final stored clock
    identical, audit replay clean on both."""
    from repro_torch.serve import ChurnConfig, run_churn

    res, crc = {}, {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        with on(d):
            r = run_churn(ChurnConfig.quick(), device=d,
                          inspect=lambda tiers, _, d=d: crc.update(
                              {d: stored_crc(tiers)}))
        res[d] = r
        check(r.fn_violations == 0, f"quick churn on {d}: fn != 0")
        rp = r.replay
        check(rp is not None and not rp["mismatches"]
              and rp["checked"] == rp["matched"] > 0,
              f"quick churn on {d}: audit replay {rp}")
        print(f"[serve] quick churn on {d}: {time.perf_counter() - t0:.3f} s, "
              f"replay {json.dumps(rp)}")
    for key in SERVE_DETERMINISTIC:
        check(getattr(res["cuda"], key) == getattr(res["cpu"], key),
              f"quick churn {key} differs between devices")
    check(crc["cuda"] == crc["cpu"], "quick churn: final stored clocks differ")
    out = {key: getattr(res["cuda"], key) for key in SERVE_DETERMINISTIC}
    out["stored_crc"] = crc["cuda"]
    return out


def time_serve(dev) -> dict:
    """The tick at the mint's shape and one-vs-many at m = 256, N = 256
    (a pipeline batch), 65,536 (the warm tier) and 69,632 (hot + warm,
    where the tiers pin their blocks) at the blocks the table gives that
    N: device ms of the kernel, the plain version and (tick)
    ``scatter_add_``, with bytes and operations."""
    import torch
    from repro_torch.kernels import ops, ref

    g = np.random.default_rng(SEED + 21)
    out = {}
    B, E = SERVE_MINT
    P = E * K
    nbytes = B * SERVE_M * 4 * 2 + B * P * 4
    nb = n_buffers(nbytes)
    bufs = [serve_tick_inputs(g, B, E, dev) for _ in range(nb)]
    p64 = [p.to(torch.int64) for _, p in bufs]
    ones = torch.ones((B, P), dtype=torch.int32, device=dev)
    lib_in = measure(lambda i: bufs[i][0].scatter_add_(1, p64[i], ones), nb)["ms"]
    lib_out = measure(lambda i: torch.scatter_add(bufs[i][0], 1, p64[i], ones),
                      nb)["ms"]
    k = measure(lambda i: ops.tick_probes(*bufs[i]), nb)
    p = measure(lambda i: ref.bloom_tick_ref(*bufs[i]), nb, iters=10)
    out["tick"] = dict(B=B, P=P, ms=k["ms"], call_ms=k["call_ms"],
                       plain_ms=p["ms"], library_ms=min(lib_in, lib_out),
                       scatter_add_ms=lib_in, scatter_add_out_ms=lib_out,
                       bytes=nbytes, ops=B * SERVE_M + B * P)
    for N in (SERVE_OVM_N[0], SERVE_OVM_N[-1], SERVE_PIN_N):
        nbytes = N * SERVE_M + N * 4 + SERVE_M * 4 + N * ROW_OUT_BYTES
        nb = n_buffers(nbytes)
        slabs = [serve_slab(g, N, dev) for _ in range(nb)]
        bn, bm_n = ops._one_vs_many_blocks(N, SERVE_M, None, None, "cuda")
        k = measure(lambda i: ops._classify_vs_many_packed(*slabs[i], bn=bn,
                                                           bm=bm_n), nb)
        p = measure(lambda i: ref.one_vs_many_ref(
            *slabs[i], bm=ops.tile_width(SERVE_M, bm_n)), nb, iters=10)
        out[f"packed_{N}"] = dict(N=N, blocks=[bn, bm_n], ms=k["ms"],
                                  call_ms=k["call_ms"], plain_ms=p["ms"],
                                  library_ms=None, bytes=nbytes,
                                  ops=N * SERVE_M * 5)
    return out


# ---------------------------------------------------------------------------
# phase 10: model serving
# ---------------------------------------------------------------------------

#: launch/serve.py's defaults (src/repro/launch/serve.py:30-34, 74): the
#: architecture, batch, prompt and generated tokens, the policy's gate
MODEL_ARCH, MODEL_BATCH, MODEL_PROMPT, MODEL_GEN = "qwen1_5_0_5b", 4, 32, 16
MODEL_FP_THRESHOLD = 1e-4
#: Qwen1.5-0.5B's full config: 24 layers, d 1,024, 16 heads, d_ff 2,816,
#: V 151,936, tied embeddings
MODEL_PARAMS = 463_987_712
MODEL_KERNELS = ("bloom_tick", "bloom_merge_compare", "one_vs_many_i32")
#: the card-vs-CPU run: the full widths, depth cut to 2 layers
MODEL_CMP_LAYERS = 2
#: bfloat16 logits across devices: each side rounds every product's
#: output to 8 bits of mantissa after summing in its own order; 0.0625
#: is four bfloat16 ulps at magnitude 2-4 (the largest gap between two
#: frameworks on the CPU at these widths was 0.031), plus 2% of the value
LOGIT_ATOL, LOGIT_RTOL = 0.0625, 0.02


def model_engine(params, cfg, device, replica_id: str):
    """A ``ServingEngine`` as ``launch.serve`` builds it (``params`` a
    flat dict or an already built ``Transformer``, shared)."""
    from repro_torch.causal import CausalPolicy
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.serving import ServeConfig, ServingEngine

    return ServingEngine(
        params, cfg,
        ServeConfig(max_batch=MODEL_BATCH,
                    max_seq=MODEL_PROMPT + MODEL_GEN + 8, seed=SEED),
        ClockConfig(policy=CausalPolicy(fp_threshold=MODEL_FP_THRESHOLD)),
        replica_id=replica_id, device=device)


def model_prompts(vocab: int):
    """``launch.serve``'s prompts: a CPU generator seeded ``seed + 1``."""
    import torch
    return torch.randint(0, vocab, (MODEL_BATCH, MODEL_PROMPT),
                         generator=torch.Generator().manual_seed(SEED + 1))


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def decode_steps(model, cfg, prompts, feed=None, timed: bool = False,
                 n_gen: int = MODEL_GEN, frames=None):
    """Prefill (an enc-dec model's with the encoder over ``frames``),
    then ``n_gen`` greedy decode steps on the bare model (no clocks):
    each step's logits as float32 on the host, the tokens fed
    (``feed``'s where given, else the argmax), the prefill's and, with
    ``timed``, each step's host-clock ms to a synchronise."""
    import torch
    from repro_torch.models import transformer as T

    dev = model.device
    sync(dev)
    t0 = time.perf_counter()
    logits, caches = T.prefill(model, cfg, prompts, enc_frames=frames,
                               buf_len=MODEL_PROMPT + MODEL_GEN + 8)
    sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out, fed, ms = [logits.float().cpu()], [], []
    for i in range(n_gen):
        tok = (feed[i].to(dev) if feed is not None
               else logits.argmax(-1).to(torch.int32))
        fed.append(tok.cpu())
        sync(dev)
        t0 = time.perf_counter()
        logits, caches = T.decode_step(model, cfg, caches, tok,
                                       MODEL_PROMPT + i)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits.float().cpu())
    return {"logits": out, "fed": fed, "ms": ms if timed else None,
            "prefill_ms": prefill_ms,
            "caches": caches, "next": logits.argmax(-1).to(torch.int32)}


def guarded_serve(a, cfg, prompts, tag: str) -> dict:
    """Engine ``a`` admits ``prompts`` and generates ``MODEL_GEN`` tokens;
    engine B merges A's clock and adopts the session, C ticks its own
    history and refuses it; the launch counts reset just before and read
    just after.  Returns the session, its tokens on the host, admit and
    generate seconds, the launches and the migration verdicts."""
    from repro_torch.core import clock as bc
    from repro_torch.kernels import ops
    from repro_torch.runtime.clock_runtime import LineageStatus

    dev = a.device
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    sess = a.admit(prompts)
    sync(dev)
    t1 = time.perf_counter()
    out = a.generate(sess, MODEL_GEN)
    sync(dev)
    t2 = time.perf_counter()
    b = model_engine(a.model, cfg, dev, "B")
    b.clock.clock = bc.merge(b.clock.clock, a.clock.clock)
    b_ok, b_status, b_fp = b.can_adopt(sess)
    c = model_engine(a.model, cfg, dev, "C")
    c.clock.tick("own-history")
    c_ok, c_status, _ = c.can_adopt(sess)
    mask = b.adopt_many([sess])
    sync(dev)
    launches = {k: ops.LAUNCHES[k] for k in MODEL_KERNELS}
    check(b_ok and b_status in (LineageStatus.SAME, LineageStatus.ANCESTOR),
          f"{tag} replica B refused A's session ({b_status}, fp {b_fp})")
    check(not c_ok and c_status == LineageStatus.FORKED,
          f"{tag} replica C did not refuse A's session ({c_status})")
    check(list(mask) == [True] and sess["sid"] in b.sessions,
          f"{tag} replica B's adopt_many gave {list(mask)}")
    toks = out.cpu()
    check(tuple(toks.shape) == (MODEL_BATCH, MODEL_GEN)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"{tag} generated tokens {tuple(toks.shape)} out of range")
    check(bool(sess["last_logits"].float().isfinite().all()),
          f"{tag} non-finite logits")
    return {"sess": sess, "toks": toks, "admit_s": t1 - t0,
            "generate_s": t2 - t1, "launches": launches,
            "migration": {"B": [b_status, b_fp], "C": c_status}}


def drive_model(dev) -> dict:
    """Phase 10 (a) and (c) at Qwen1.5-0.5B's full config on the card:
    engine A serves ``launch.serve``'s defaults (admit, then ``generate``)
    and engines B and C guard a migration (``guarded_serve``); then the
    bare model's prefill and decode steps timed, one decode step
    profiled."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import clock as bc
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = get_config(MODEL_ARCH)
    check(cfg.n_params() == MODEL_PARAMS,
          f"{MODEL_ARCH}: {cfg.n_params()} params, not {MODEL_PARAMS}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(dev).manual_seed(SEED), cfg, dev)
    a = model_engine(params, cfg, dev, "A")
    sync(dev)
    setup_s = time.perf_counter() - t0
    prompts = model_prompts(cfg.vocab)
    warm = decode_steps(a.model, cfg, prompts.to(dev))   # cuBLAS set-up
    del warm

    run = guarded_serve(a, cfg, prompts, "[model]")
    sess, toks = run["sess"], run["toks"]

    timed = decode_steps(a.model, cfg, prompts.to(dev), timed=True)
    # the engine step's clock work alone: one tick and one session merge
    clock_ms = []
    for i in range(MODEL_GEN):
        sync(dev)
        t3 = time.perf_counter()
        a.clock.tick("tokens", a.replica_id, 10_000 + i)
        sess["clock"].clock = bc.merge(sess["clock"].clock, a.clock.clock)
        sync(dev)
        clock_ms.append((time.perf_counter() - t3) * 1e3)
    nxt = timed["next"]
    caches = timed["caches"]
    prof = profiled(lambda: T.decode_step(a.model, cfg, caches, nxt,
                                          MODEL_PROMPT + MODEL_GEN))
    gen_s = run["generate_s"]
    return {
        "setup_s": setup_s, "prefill_ms": run["admit_s"] * 1e3,
        "generate_ms": gen_s * 1e3, "tok_s": MODEL_BATCH * MODEL_GEN / gen_s,
        "engine_step_ms": gen_s * 1e3 / MODEL_GEN,
        "decode_ms": float(np.median(timed["ms"][1:])),
        "decode_ms_all": timed["ms"], "profile": prof,
        "prefill_bare_ms": timed["prefill_ms"],
        "clock_ms": float(np.median(clock_ms[1:])),
        # every weight a step reads once, in the compute dtype (the
        # norms' float32 scales too)
        "weight_bytes": sum(b.numel() * b.element_size()
                            for b in a.model.buffers()),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": run["launches"], "sample": toks[:, :8].tolist(),
        "migration": run["migration"],
        "clock_sum": float(a.clock.clock.sum()),
    }


def model_run(device, params, cfg, feed=None, n_gen: int = MODEL_GEN) -> dict:
    """Phase 10 (b) on one device: the bare model's prefill and ``n_gen``
    decode steps (fed ``feed``'s tokens where given), then engine A
    serves the same prompts for ``n_gen`` tokens and engine B, which
    ticked once and merged A's clock, classifies A's first session and
    a second one admitted after the merge."""
    from repro_torch.core import clock as bc

    a = model_engine(params, cfg, device, "A")
    prompts = model_prompts(cfg.vocab)
    steps = decode_steps(a.model, cfg, prompts.to(device), feed=feed,
                         n_gen=n_gen)
    s1 = a.admit(prompts)
    out = a.generate(s1, n_gen)
    b = model_engine(a.model, cfg, device, "B")
    b.clock.tick("own", 1)
    b.clock.clock = bc.merge(b.clock.clock, a.clock.clock)
    s2 = a.admit(prompts[:2])
    a.generate(s2, 3)
    lineage = b.can_adopt(s1)
    mask = b.adopt_many([s1, s2])
    cells = {name: host(c.logical_cells()) for name, c in (
        ("A", a.clock.clock), ("B", b.clock.clock),
        ("s1", s1["clock"].clock), ("s2", s2["clock"].clock))}
    rows = {f"{eng}.{name}": host(getattr(e.sessions, name))
            for eng, e in (("A", a), ("B", b))
            for name in ("cells_u8", "base", "sums", "alive")}
    return {"steps": steps, "tokens": out.cpu().numpy(), "mask": mask,
            "lineage": lineage, "cells": cells, "rows": rows,
            "slots": {"A": dict(a.sessions._slot_of),
                      "B": dict(b.sessions._slot_of)}}


def compare_logit_steps(gl: list, cl: list, tag: str, held=None) -> tuple:
    """Hold two ``decode_steps`` runs' logits, the card's ``gl`` and the
    CPU's ``cl`` (fed the card's tokens): within ``LOGIT_ATOL +
    LOGIT_RTOL |x|`` and greedy tokens identical outside near ties, on
    the rows ``held`` [B, steps] marks at each step (all of them
    without it).  Returns (max logit gap, excused [B, steps]: near ties
    and unheld steps)."""
    steps = len(gl)
    if held is None:
        held = np.ones((MODEL_BATCH, steps), bool)
    max_gap, excused = 0.0, np.zeros((MODEL_BATCH, steps), bool)
    for i, (lg, lc) in enumerate(zip(gl, cl)):
        lg, lc = lg.numpy(), lc.numpy()
        check(bool(np.isfinite(lg).all() and np.isfinite(lc).all()),
              f"{tag} non-finite logits at step {i}")
        rows = held[:, i]
        gap = np.abs(lg - lc)[rows]
        check(bool((gap <= LOGIT_ATOL + LOGIT_RTOL * np.abs(lc[rows])).all()),
              f"{tag} logits of step {i} differ by {gap.max()} across devices")
        max_gap = max(max_gap, float(gap.max(initial=0.0)))
        top2 = np.sort(lc, -1)[:, -2:]
        # the argmax may differ only where the CPU's top two logits lie
        # within the tolerance of each other (a near tie)
        near = (top2[:, 1] - top2[:, 0]
                <= LOGIT_ATOL + LOGIT_RTOL * np.abs(top2[:, 1]))
        excused[:, i] = near | ~rows
        same = lg.argmax(-1) == lc.argmax(-1)
        check(bool((same | excused[:, i]).all()),
              f"{tag} greedy tokens of step {i} differ past the tolerance")
    return max_gap, excused


def compare_model_runs(g: dict, c: dict, tag: str, held=None) -> tuple:
    """Hold two ``model_run``s, the card's ``g`` and the CPU's ``c`` (fed
    the card's tokens): the bare runs' logits by ``compare_logit_steps``
    (on the rows ``held`` marks); the engines' tokens identical up to a
    row's first difference, which must fall on a near tie or an unheld
    step; clocks, registry rows and slots, the adopt_many mask and the
    lineage identical, fp within tolerance.  Returns (max logit gap,
    excused [B, steps], rows whose engine tokens diverged, fp gap)."""
    max_gap, excused = compare_logit_steps(
        g["steps"]["logits"], c["steps"]["logits"], tag, held)
    # the engines' tokens: identical up to a row's first difference,
    # which must fall on a step whose top two logits are within tolerance
    diverged = 0
    for r in range(MODEL_BATCH):
        diff = np.flatnonzero(g["tokens"][r] != c["tokens"][r])
        if diff.size:
            check(bool(excused[r, diff[0]]),
                  f"{tag} engine tokens of row {r} differ at step {diff[0]}")
            diverged += 1
    for name, cells in g["cells"].items():
        check_equal(cells, c["cells"][name], f"{tag} {name} clock cells")
    for name, rows in g["rows"].items():
        check_equal(rows, c["rows"][name], f"{tag} registry {name}")
    check(g["slots"] == c["slots"], f"{tag} registry slots differ")
    check_equal(g["mask"], c["mask"], f"{tag} adopt_many mask")
    check(list(g["mask"]) == [True, False], f"{tag} mask {list(g['mask'])}")
    check(g["lineage"][:2] == c["lineage"][:2],
          f"{tag} can_adopt {g['lineage']} vs {c['lineage']}")
    fp_gap = check_fp([g["lineage"][2]], [c["lineage"][2]], f"{tag} can_adopt")
    return max_gap, excused, diverged, fp_gap


def model_cpu_check(dev) -> dict:
    """Phase 10 (b): the full widths at ``MODEL_CMP_LAYERS`` layers, the
    weights drawn once on the card and copied to the CPU, the same
    prompts on both; the CPU's bare decode is fed the card's tokens."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_config(MODEL_ARCH), n_layers=MODEL_CMP_LAYERS)
    params = init_params(torch.Generator(dev).manual_seed(SEED), cfg, dev)
    t0 = time.perf_counter()
    g = model_run(dev, params, cfg)
    t_card = time.perf_counter() - t0
    params = {k: v.cpu() for k, v in params.items()}
    t0 = time.perf_counter()
    with card_blocks():
        c = model_run("cpu", params, cfg, feed=g["steps"]["fed"])
    t_cpu = time.perf_counter() - t0

    max_gap, excused, diverged, fp_gap = compare_model_runs(g, c, "[model]")
    return {"layers": MODEL_CMP_LAYERS, "max_logit_gap": max_gap,
            "near_tie_steps": int(excused.sum()),
            "rows_diverged_at_near_ties": diverged,
            "tokens_identical": bool((g["tokens"] == c["tokens"]).all()),
            "fp": [g["lineage"][2], c["lineage"][2]], "fp_abs_gap": fp_gap,
            "card_s": t_card, "cpu_s": t_cpu}


def model_phase(dev, rate: float) -> dict:
    """Phase 10: (a) and (c) in-process, (a) once more through the
    launcher in a child process, (b) card against CPU.  Returns the
    serving path's launches."""
    run = drive_model(dev)
    bound_ms = run["weight_bytes"] / rate * 1e3
    prof = run["profile"]
    print(f"[model] {MODEL_ARCH} full config ({MODEL_PARAMS} params, "
          f"bfloat16 compute, float32 masters) on the card: weights and "
          f"engine set up in {run['setup_s']:.2f} s; admit (prefill "
          f"{MODEL_BATCH}x{MODEL_PROMPT}, its ticks, the session clock and "
          f"registry row) {run['prefill_ms']} ms, the bare prefill "
          f"{run['prefill_bare_ms']} ms; generate "
          f"{MODEL_GEN} tokens {run['generate_ms']} ms "
          f"({run['engine_step_ms']} ms an engine step with its clock "
          f"ticks, {run['tok_s']} tok/s); an engine step's clock work "
          f"(one tick, one session merge) {run['clock_ms']} ms (median)")
    print(f"[model] decode step (bare model, host clock to a synchronise): "
          f"median over steps 2-{MODEL_GEN} {run['decode_ms']} ms, all "
          f"{json.dumps(run['decode_ms_all'])}; bound {bound_ms} ms "
          f"({run['weight_bytes']} bytes of compute-dtype weights at "
          f"{rate / 1e12} TB/s): the step at {run['decode_ms'] / bound_ms:.2f}x it")
    print(f"[model] one decode step under the profiler: wall "
          f"{prof['wall_ms']} ms, kernels {prof['kernel_ms']} ms "
          f"({prof['device_events']} device events), copies "
          f"{prof['copy_ms']} ms, idle share {prof['idle_share']} "
          f"({prof['idle_share_with_copies']} with copies), top "
          f"{json.dumps(prof['top_device_ms'])}")
    print(f"[model] peak memory {run['peak_gb']} GB; launches on the serving "
          f"path {json.dumps(run['launches'])}; sample outputs "
          f"{run['sample']}; engine clock sum {run['clock_sum']}")
    for kname, n in run["launches"].items():
        check(n > 0, f"kernel {kname} was not launched on the serving path")
    print(f"[model] migration guard on the card: B (merged A's clock) "
          f"{run['migration']['B'][0]} fp {run['migration']['B'][1]}, "
          f"adopted; C (own history) {run['migration']['C']}, refused")
    del run["profile"]
    if not CHILDREN_BATCHED:
        run_launchers([serve_launcher("model")])
    small = model_cpu_check(dev)
    print(f"[model] card and CPU agree at the full widths, depth cut to "
          f"{MODEL_CMP_LAYERS} layers: engine and session clocks, registry "
          f"rows and adopt_many masks identical; logits within "
          f"{LOGIT_ATOL} + {LOGIT_RTOL}|x|; greedy tokens identical outside "
          f"near ties: {json.dumps(small)}")
    return run["launches"]


# ---------------------------------------------------------------------------
# phase 11: training
# ---------------------------------------------------------------------------

#: the training run: ``launch/train.py``'s defaults (batch 8, seq 128, lr
#: 3e-3, float32 AdamW moments; src/repro/launch/train.py:110-116) for 12
#: steps, a checkpoint every 4 and a failure injected at step 8
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 12, 4, 8
TRAIN_ARGS = ("--steps", str(TRAIN_STEPS), "--ckpt-every",
              str(TRAIN_CKPT_EVERY), "--inject-failure", str(TRAIN_FAIL_AT))
#: the launcher's command line in a child process, cut for the script's
#: time limit to 2 steps without checkpoints (the in-process loop above
#: runs the launcher's checkpoints and restart at the full config, and
#: the ``gpu`` case ``test_cuda_train_launcher_restart_exits_zero`` its
#: command line's)
TRAIN_CHILD_STEPS = 2
TRAIN_CHILD_ARGS = ("--steps", str(TRAIN_CHILD_STEPS))
TRAIN_KERNELS = ("bloom_tick", "bloom_merge_compare", "one_vs_many_i32")
ASYNC_KERNELS = ("bloom_tick", "one_vs_many_packed")
#: steps timed after the run (the median leaves out the first)
TRAIN_TIMED_STEPS = 6
#: card against CPU: the full widths, depth, batch and sequence cut
TRAIN_CMP_LAYERS, TRAIN_CMP_BATCH, TRAIN_CMP_SEQ, TRAIN_CMP_STEPS = 2, 2, 32, 2
#: bfloat16 compute across devices: losses and grad norms within 2e-2
#: relative (each side rounds every product's output to 8 bits of
#: mantissa after summing in its own order)
TRAIN_LOSS_RTOL = 2e-2
#: dense bfloat16 tensor-core peak of an H100 SXM (data sheet)
BF16_FLOPS = 989e12
#: AdamW's float32 bytes a parameter: the param, its gradient and both
#: moments read once, the param and both moments written once
ADAMW_BYTES = 7 * 4
#: the async cases' clock config (tests/test_integration.py:135): every
#: comparable pod is confident, no straggler gap
ASYNC_CLOCK = dict(m=256, fp_threshold=1.0 - 1e-6, straggler_gap=1e9)
#: the async data stream and SGD step (tests/test_integration.py:136-151)
ASYNC_BATCH, ASYNC_SEQ, ASYNC_LR = 4, 32, 2e-3
_TRAIN_LINE = re.compile(
    r"\[train\] step=(\d+) loss=(\S+) gnorm=(\S+) clock_sum=(\d+)")


def train_opt(n_steps: int, state_dtype: str = "float32"):
    """``launch.train``'s optimizer for ``n_steps``, with moments of
    ``state_dtype``."""
    from repro_torch.optim.adamw import OptConfig
    return OptConfig(lr=3e-3, total_steps=n_steps,
                     warmup_steps=max(n_steps // 20, 5),
                     state_dtype=state_dtype)


def train_args(ckpt_dir: str):
    """``launch.train``'s arguments for this phase's run."""
    from repro_torch.launch import train as launch
    return launch.parse_args([*TRAIN_ARGS, "--ckpt-dir", ckpt_dir,
                              "--log-every", "1"])


def train_steps_of(log: str) -> dict:
    """{step: (loss, gnorm, clock_sum)} of the ``[train]`` step lines."""
    return {int(m[1]): (float(m[2]), float(m[3]), int(m[4]))
            for m in _TRAIN_LINE.finditer(log)}


def drive_train(dev) -> dict:
    """Phase 11 (a): ``launch.train.train_loop`` at the launcher's
    defaults with checkpoints and an injected restart, then
    ``admit_restore_latest`` over the directory, with the launch counts
    reset just before and read just after; then the step timed, one step
    profiled, one checkpoint's snapshot and write timed."""
    import io

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.runtime.training import make_train_step

    with tempfile.TemporaryDirectory() as d:
        args = train_args(os.path.join(d, "ckpt"))
        cfg, opt_cfg, clock_cfg, data = launch.build(args)
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        ops.reset_launches()
        sync(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = launch.train_loop(args)
            latest, lineage = out["runtime"].admit_restore_latest(
                CheckpointManager(args.ckpt_dir))
        sync(dev)
        wall_s = time.perf_counter() - t0
        launches = {k: ops.LAUNCHES[k] for k in TRAIN_KERNELS}
        log = buf.getvalue()
        state, runtime = out["final_state"], out["runtime"]
        peak_gb = (torch.cuda.max_memory_allocated() / 1e9
                   if torch.device(dev).type == "cuda" else None)
        steps = train_steps_of(log)
        check(sorted(steps) == list(range(TRAIN_STEPS)),
              f"[train] step lines {sorted(steps)}:\n{log[-3000:]}")
        losses = [steps[s][0] for s in range(TRAIN_STEPS)]
        check(all(np.isfinite(losses)), f"[train] non-finite losses {losses}")
        check(losses[-1] < losses[0],
              f"[train] loss did not fall: {losses[0]} -> {losses[-1]}")
        for s, (_, _, csum) in steps.items():
            check(csum == clock_cfg.k * (s + 1),
                  f"[train] step {s}: clock_sum {csum} != k x {s + 1}")
        check(int(state.step) == TRAIN_STEPS
              and int(state.clock_cells.sum()) == clock_cfg.k * TRAIN_STEPS,
              f"[train] state step {int(state.step)}, clock sum "
              f"{int(state.clock_cells.sum())} != k x {TRAIN_STEPS}")
        restore = [ln for ln in log.splitlines() if "[train] restore" in ln]
        check(len(restore) == 1 and f"step={TRAIN_FAIL_AT} lineage=descendant"
              in restore[0] and "admitted=True" in restore[0],
              f"[train] restart: {restore}")
        check(latest == TRAIN_STEPS, f"[train] admit_restore_latest named "
              f"{latest}, not {TRAIN_STEPS}: {lineage.summary()}")
        clock_sum = int(state.clock_cells.sum())

        step_fn = make_train_step(cfg, opt_cfg, clock_cfg)
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ms = []
        for s in range(TRAIN_STEPS, TRAIN_STEPS + TRAIN_TIMED_STEPS):
            batch = data.batch(s, device=dev)
            batch["ev_hi"], batch["ev_lo"] = data.event_id(s)
            sync(dev)
            t1 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            sync(dev)
            ms.append((time.perf_counter() - t1) * 1e3)
        check(bool(np.isfinite(float(metrics["loss"]))),
              "[train] a timed step's loss is not finite")
        step_peak_gb = (torch.cuda.max_memory_allocated() / 1e9
                        if torch.device(dev).type == "cuda" else None)
        prof = (profiled(lambda: step_fn(state, batch))
                if torch.device(dev).type == "cuda" else None)
        mgr = CheckpointManager(os.path.join(d, "timed"), keep=1)
        mgr.save(TRAIN_STEPS + TRAIN_TIMED_STEPS, state, runtime.snapshot())
        mgr.wait()
        ckpt_bytes = os.path.getsize(os.path.join(
            d, "timed", f"step_{TRAIN_STEPS + TRAIN_TIMED_STEPS}", "state.npz"))
    return {"wall_s": wall_s, "launches": launches, "batch": args.batch,
            "seq": args.seq,
            "lines": [ln for ln in log.splitlines() if ln.startswith("[train]")],
            "losses": losses, "latest": latest, "lineage": lineage.summary(),
            "step_ms": float(np.median(ms[1:])), "step_ms_all": ms,
            "profile": prof,
            "peak_gb": peak_gb, "step_peak_gb": step_peak_gb, "snapshot_ms": mgr.last_save["snapshot_s"] * 1e3,
            "write_ms": mgr.last_save["write_s"] * 1e3,
            "ckpt_bytes": ckpt_bytes, "clock_sum": clock_sum}


def move_state(state, device):
    """A ``TrainState`` (or any checkpoint tree) copied to ``device``."""
    from repro_torch.checkpoint.manager import _rebuild
    return _rebuild(state, lambda key, t: t.to(device))


def train_run(device, state, cfg, opt_cfg, clock_cfg, n_steps: int,
              seq: int = TRAIN_CMP_SEQ) -> dict:
    """``n_steps`` of the launcher's train step from ``state`` (copied to
    ``device``) on the launcher's data stream at the cut batch and
    sequence (``seq``); an enc-dec config's batch with a step's frames
    (``encdec_frames``)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.runtime.training import make_train_step

    state = move_state(state, device)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=TRAIN_CMP_BATCH))
    step = make_train_step(cfg, opt_cfg, clock_cfg)
    metrics = []
    for s in range(n_steps):
        batch = data.batch(s, device=device)
        batch["ev_hi"], batch["ev_lo"] = data.event_id(s)
        if cfg.is_encdec:
            batch["enc_frames"] = encdec_frames(TRAIN_CMP_BATCH, cfg,
                                                s).to(device)
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"state": state, "metrics": metrics}


def npz_layout(path: str) -> list:
    """(key, shape, dtype) of every array of an ``.npz`` file, in its
    order, read from the arrays' headers alone."""
    import zipfile
    fmt = np.lib.format
    out = []
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            with z.open(name) as f:
                header = (fmt.read_array_header_1_0
                          if fmt.read_magic(f) == (1, 0)
                          else fmt.read_array_header_2_0)
                shape, _, dtype = header(f)
            out.append((name.removesuffix(".npy"), shape, dtype.str))
    return out


def train_cpu_check(dev, cfg) -> dict:
    """Phase 11 (b): ``TRAIN_CMP_STEPS`` steps at ``cfg``'s widths on the
    card and the CPU from one state drawn on the card: clock cells
    identical, losses and grad norms within ``TRAIN_LOSS_RTOL``, every
    param within the most two AdamW trajectories can part (each step
    moves an element by at most lr x (|m^/sqrt(v^)| <= 1.0003 + wd
    |p|), so 2 x 1.0003 x the steps' lr plus the weight decay's share);
    both checkpoints' npz keys, shapes and dtypes identical, and the
    card's checkpoint restored into the CPU run's state identical."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _leaves
    from repro_torch.causal import CausalPolicy
    from repro_torch.runtime.clock_runtime import ClockConfig, ClockRuntime
    from repro_torch.runtime.training import init_train_state

    # the launcher's optimizer and clock for a run of TRAIN_CMP_STEPS
    opt_cfg = train_opt(TRAIN_CMP_STEPS)
    clock_cfg = ClockConfig(policy=CausalPolicy(fp_threshold=1e-4))
    state = init_train_state(torch.Generator(dev).manual_seed(SEED), cfg,
                             opt_cfg, clock_cfg, device=dev)
    t0 = time.perf_counter()
    g = train_run(dev, state, cfg, opt_cfg, clock_cfg, TRAIN_CMP_STEPS)
    t_card = time.perf_counter() - t0
    start = move_state(state, "cpu")
    del state
    t0 = time.perf_counter()
    c = train_run("cpu", start, cfg, opt_cfg, clock_cfg, TRAIN_CMP_STEPS)
    t_cpu = time.perf_counter() - t0
    gs, cs = g["state"], c["state"]
    check_equal(host(gs.clock_cells), host(cs.clock_cells),
                "[train] card vs CPU clock cells")
    check(int(gs.step) == int(cs.step) == TRAIN_CMP_STEPS, "[train] steps")
    loss_gap = 0.0
    for i, (mg, mc) in enumerate(zip(g["metrics"], c["metrics"])):
        check(mg["lr"] == mc["lr"] and mg["clock_sum"] == mc["clock_sum"],
              f"[train] step {i}: lr or clock_sum differ")
        for key in ("loss", "grad_norm"):
            gap = abs(mg[key] - mc[key]) / abs(mc[key])
            check(gap <= TRAIN_LOSS_RTOL,
                  f"[train] step {i} {key}: card {mg[key]} CPU {mc[key]}")
            loss_gap = max(loss_gap, gap)
    lrs = [m["lr"] for m in c["metrics"]]
    p_max = max(float(p.abs().max()) for p in cs.params.values())
    bound = sum(2 * 1.0003 * lr + 2 * lr * opt_cfg.weight_decay * p_max
                for lr in lrs) + 1e-6
    worst, parted, n = 0.0, 0, 0
    for k, p in cs.params.items():
        d = (gs.params[k].cpu() - p).abs()
        worst = max(worst, float(d.max()))
        # apart by more than the first step's lr: an update of opposite
        # sign in some step (a gradient near zero rounded either way)
        parted += int((d > lrs[0]).sum())
        n += d.numel()
        check(float(d.max()) <= bound,
              f"[train] param {k}: card and CPU {float(d.max())} apart, "
              f"past the AdamW bound {bound}")
    with tempfile.TemporaryDirectory() as d:
        snap = ClockRuntime(clock_cfg, device="cpu").snapshot()
        CheckpointManager(os.path.join(d, "card")).save(
            TRAIN_CMP_STEPS, gs, snap, block=True)
        CheckpointManager(os.path.join(d, "cpu")).save(
            TRAIN_CMP_STEPS, cs, snap, block=True)
        shapes = [npz_layout(os.path.join(d, side, f"step_{TRAIN_CMP_STEPS}",
                                          "state.npz"))
                  for side in ("card", "cpu")]
        check(shapes[0] == shapes[1], "[train] checkpoint keys, shapes or "
              "dtypes differ between the card's and the CPU's")
        back, _ = CheckpointManager(os.path.join(d, "card")).restore(
            target_structure=cs, device="cpu")
    for (key, a), (_, b) in zip(_leaves(gs), _leaves(back)):
        check(b.device.type == "cpu" and torch.equal(a.cpu(), b),
              f"[train] the card's checkpoint restored {key} differently")
    return {"layers": cfg.n_layers, "batch": TRAIN_CMP_BATCH,
            "seq": TRAIN_CMP_SEQ, "steps": TRAIN_CMP_STEPS,
            "losses": [[m["loss"] for m in g["metrics"]],
                       [m["loss"] for m in c["metrics"]]],
            "max_loss_or_gnorm_rel_gap": loss_gap, "max_param_gap": worst,
            "param_bound": bound, "share_apart_past_lr1": parted / n,
            "npz_leaves": len(shapes[0]), "card_s": t_card, "cpu_s": t_cpu}


def async_run(device, params, cfg) -> dict:
    """Phase 11 (c) on one device: the reference's forked-pod sequence
    with ``AsyncConfig``'s 4 pods and 2 local SGD steps, two rounds, pod
    2 restored from its pre-commit clock before round 2."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.runtime.async_trainer import (AsyncConfig,
                                                   AsyncCoordinator,
                                                   run_pod_round)
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import cross_entropy

    def sgd_step(p, batch):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        logits, _ = T.forward_train(leaves, cfg, batch["tokens"])
        loss = cross_entropy(logits, batch["labels"], cfg.vocab)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return ({k: w.detach() - ASYNC_LR * gr
                 for (k, w), gr in zip(leaves.items(), grads)}, loss.detach())

    a_cfg = AsyncConfig(local_steps=2)
    c_cfg = ClockConfig(**ASYNC_CLOCK)
    coord = AsyncCoordinator(params, a_cfg, c_cfg, device=device)
    pods = coord.add_pods(list(range(a_cfg.n_pods)), c_cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=ASYNC_SEQ,
                                  global_batch=ASYNC_BATCH))

    def data_fn(pod_id, step):
        return data.batch(step * 10 + pod_id, device=device)

    decisions, outer_ms, stale = [], [], None
    for rnd, base in enumerate((0, 50)):
        deltas = {}
        for pod in pods:
            deltas[pod.pod_id], _ = run_pod_round(pod, sgd_step, data_fn,
                                                  a_cfg, base)
            if pod.pod_id == 2 and rnd == 0:
                stale = pod.clock.clock   # pod 2's pre-commit clock
        sync(device)
        t0 = time.perf_counter()
        decisions.append(coord.outer_step(pods, deltas))
        sync(device)
        outer_ms.append((time.perf_counter() - t0) * 1e3)
        if rnd == 0:
            pods[2].clock.clock = stale
        del deltas
    out = {"decisions": decisions, "outer_ms": outer_ms}
    for key, p in coord.params.items():
        check(bool(torch.isfinite(p).all()), f"[train] async param {key}")
    r1, r2 = decisions
    check(all(d[0] for d in r1.values()), f"[train] async round 1: {r1}")
    check(r2[2][:2] == (False, "forked")
          and all(r2[p][0] for p in (0, 1, 3)), f"[train] async round 2: {r2}")
    return out


def drive_async(dev, cfg) -> dict:
    """Phase 11 (c): the sequence at ``cfg`` on the card with the launch
    counts reset just before and read just after.  Its card-vs-CPU
    comparison is cut for the script's time limit (at 2 layers of the
    full widths the CPU's run took ~50 s, at batch 4 and 1 alike); the
    ``gpu`` case ``test_cuda_async_coordinator_matches_cpu`` holds the
    sequence card vs CPU at the smoke config."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params

    params = init_params(torch.Generator(dev).manual_seed(SEED), cfg, dev)
    ops.reset_launches()
    full = async_run(dev, params, cfg)
    launches = {k: ops.LAUNCHES[k] for k in ASYNC_KERNELS}
    for kname, n in launches.items():
        check(n > 0, f"kernel {kname} was not launched on the async path")
    del params
    return {"launches": launches, "outer_ms": full["outer_ms"],
            "decisions": [{p: [d[0], d[1], d[2]] for p, d in r.items()}
                          for r in full["decisions"]]}


def train_phase(dev, rate: float) -> dict:
    """Phase 11: (a) in-process and through the launcher in a child
    process, (b) card against CPU, (c) the async coordinator.  Returns
    the training path's launches."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config

    cfg = get_config(MODEL_ARCH)
    check(cfg.n_params() == MODEL_PARAMS,
          f"{MODEL_ARCH}: {cfg.n_params()} params, not {MODEL_PARAMS}")
    run = drive_train(dev)
    tokens = run["batch"] * run["seq"]
    flop_ms = 6 * MODEL_PARAMS * tokens / BF16_FLOPS * 1e3
    adamw_ms = ADAMW_BYTES * MODEL_PARAMS / rate * 1e3
    for ln in run["lines"]:
        print(ln)
    print(f"[train] {MODEL_ARCH} full config ({MODEL_PARAMS} params, "
          f"bfloat16 compute, float32 masters and AdamW moments), batch "
          f"{run['batch']}, seq {run['seq']}: the launcher's loop of {TRAIN_STEPS} "
          f"steps (checkpoints every {TRAIN_CKPT_EVERY}, failure at "
          f"{TRAIN_FAIL_AT}, restart) and admit_restore_latest in "
          f"{run['wall_s']:.2f} s; latest safe step {run['latest']} "
          f"({run['lineage']}); loss {run['losses'][0]} -> "
          f"{run['losses'][-1]}; state clock sum {run['clock_sum']}")
    print(f"[train] launches on the training path: {json.dumps(run['launches'])}")
    for kname, n in run["launches"].items():
        check(n > 0, f"kernel {kname} was not launched on the training path")
    print(f"[train] step (host clock to a synchronise): median of steps "
          f"2-{TRAIN_TIMED_STEPS} {run['step_ms']} ms, all "
          f"{json.dumps(run['step_ms_all'])}; {tokens / run['step_ms'] * 1e3} "
          f"tokens/s; least times: {flop_ms} ms of bfloat16 FLOPs (6 x "
          f"{MODEL_PARAMS} x {tokens} at {BF16_FLOPS / 1e12} TFLOP/s), "
          f"{adamw_ms} ms of AdamW bytes ({ADAMW_BYTES} a param at "
          f"{rate / 1e12} TB/s): the step at "
          f"{run['step_ms'] / max(flop_ms, adamw_ms):.1f}x the larger")
    prof = run["profile"]
    print(f"[train] one step under the profiler: wall {prof['wall_ms']} ms, "
          f"kernels {prof['kernel_ms']} ms ({prof['device_events']} device "
          f"events), copies {prof['copy_ms']} ms, idle share "
          f"{prof['idle_share']} ({prof['idle_share_with_copies']} with "
          f"copies), top {json.dumps(prof['top_device_ms'])}")
    print(f"[train] peak memory {run['peak_gb']} GB over the run (the "
          f"restart holds the failed run's state, a fresh one and the "
          f"restored one), {run['step_peak_gb']} GB over the timed steps; "
          f"checkpoint "
          f"({run['ckpt_bytes']} bytes): host snapshot {run['snapshot_ms']} "
          f"ms, write {run['write_ms']} ms")
    if not CHILDREN_BATCHED:
        with tempfile.TemporaryDirectory() as d:
            run_launchers([train_launcher(d)])
    del run["profile"]
    torch.cuda.empty_cache()
    small = train_cpu_check(dev, dataclasses.replace(
        cfg, n_layers=TRAIN_CMP_LAYERS))
    print(f"[train] card and CPU agree at the full widths, {TRAIN_CMP_LAYERS} "
          f"layers, batch {TRAIN_CMP_BATCH}, seq {TRAIN_CMP_SEQ}, "
          f"{TRAIN_CMP_STEPS} steps from one state: clock cells identical, "
          f"losses and grad norms within {TRAIN_LOSS_RTOL}, params within "
          f"the AdamW bound, checkpoint keys/shapes/dtypes identical, the "
          f"card's checkpoint restored on the CPU: {json.dumps(small)}")
    torch.cuda.empty_cache()
    asy = drive_async(dev, cfg)
    print(f"[train] async coordinator at the full config (4 pods, 2 local "
          f"SGD steps, 2 rounds, pod 2 restored from its pre-commit clock): "
          f"decisions {json.dumps(asy['decisions'])}; outer_step ms "
          f"{json.dumps(asy['outer_ms'])}; launches {json.dumps(asy['launches'])}")
    torch.cuda.empty_cache()
    launches = dict(run["launches"])
    launches["one_vs_many_packed"] = asy["launches"]["one_vs_many_packed"]
    launches["bloom_tick"] += asy["launches"]["bloom_tick"]
    return launches


# ---------------------------------------------------------------------------
# phase 12: the MoE family (grok-1, DeepSeek-V2 with MLA)
# ---------------------------------------------------------------------------

MOE_ARCHS = ("grok_1_314b", "deepseek_v2_236b")
#: serving at the full widths: depth 64 (grok) and 60 (DeepSeek) cut to
#: 4 layers, so the bfloat16 weights (21.29 B and 16.94 B params, 42.6
#: and 33.9 GB) fit on one card; built unstacked (``scan_layers=False``,
#: the same math) so that ``init_params`` draws one layer's expert leaf
#: at a time in float32 (grok: 1.61 B elements, 12.9 GB of transients,
#: against 51.5 GB for the 4-layer stacked leaf)
MOE_SERVE_LAYERS = 4
#: training at the full widths and depth 1, bfloat16 masters and int8
#: AdamW moments (the configs' own memory policy).  Reckoned peak: the
#: old and new params and moments and the grads, 10.06 bytes a param,
#: plus three float32 copies of the largest leaf while AdamW updates it:
#: DeepSeek 5.02 B params, largest leaf 1.26 B: ~66 GB; grok 6.53 B,
#: 1.61 B: ~85 GB, past the card's 80, so grok trains with its expert
#: width cut 32,768 -> 16,384 (4.12 B params, ~51 GB)
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_CUTS = {"grok_1_314b": {"moe_d_ff": 16384}, "deepseek_v2_236b": {}}
#: ``launch.train``'s batch and sequence, a few steps (the median leaves
#: out the first)
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 8, 128, 4
#: card against CPU: the full widths at depth 1; the CPU's bare decode
#: and the engines' generate cut to 4 tokens (a CPU decode step reads
#: every expert's weights, 13 GB for grok)
MOE_CMP_GEN = 4


def moe_cfg(arch: str, layers: int, **cuts):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=layers, **cuts)


@contextlib.contextmanager
def route_log(model):
    """While active, every MoE layer's routing of every forward call:
    (top-k expert ids [T, k], kept [T, k] token-major) on the host, in
    call and layer order, recomputed from the layer's input with the
    port's own routing functions."""
    import torch
    from repro_torch.models import moe

    log = []

    def hook(module, args, _out):
        cfg = module.cfg
        x2d = args[0].reshape(-1, cfg.d_model)
        T, k = x2d.shape[0], cfg.top_k
        _, idx = moe._top_k_gates(x2d @ module.weights["router"], k)
        E_phys = cfg.n_experts * cfg.moe_replicas
        phys = moe._phys_idx(idx, cfg.moe_replicas)
        _, _, _, keep_s, order = moe._dispatch_indices(
            phys, T, k, E_phys, moe._capacity(cfg, T, E_phys))
        keep = torch.empty_like(keep_s)
        keep[order] = keep_s
        log.append((idx.cpu().numpy(), keep.view(T, k).cpu().numpy()))

    handles = [layer.moe.register_forward_hook(hook) for layer in model.layers]
    try:
        yield log
    finally:
        for h in handles:
            h.remove()


def serve_figures(a, cfg, prompts, tag: str) -> tuple:
    """Engine ``a`` (warmed up) serves ``prompts`` under
    ``guarded_serve``; then the bare model's prefill and decode steps
    timed and one more decode step profiled.  Returns the figures phases
    12 and 13 print, and the timed run's caches.  ``weight_bytes``: every
    weight a decode step reads once, but of an untied embedding table
    only the batch's rows."""
    from repro_torch.models import transformer as T

    dev = a.device
    run = guarded_serve(a, cfg, prompts, tag)
    timed = decode_steps(a.model, cfg, prompts.to(dev), timed=True)
    nxt, caches = timed["next"], timed["caches"]
    prof = profiled(lambda: T.decode_step(a.model, cfg, caches, nxt,
                                          MODEL_PROMPT + MODEL_GEN))
    gen_s = run["generate_s"]
    weight_bytes = sum(b.numel() * b.element_size()
                       for n, b in a.model.named_buffers()
                       if not (n == "embed.tokens" and not cfg.tie_embeddings))
    return {
        "params": cfg.n_params(), "admit_ms": run["admit_s"] * 1e3,
        "generate_ms": gen_s * 1e3, "tok_s": MODEL_BATCH * MODEL_GEN / gen_s,
        "decode_ms": float(np.median(timed["ms"][1:])),
        "decode_ms_all": timed["ms"], "prefill_bare_ms": timed["prefill_ms"],
        "profile": prof, "weight_bytes": weight_bytes,
        "launches": run["launches"], "migration": run["migration"],
        "sample": run["toks"][:, :8].tolist()}, caches


def drive_moe(dev, arch: str) -> dict:
    """Phase 12 (a) for one config at ``MOE_SERVE_LAYERS`` layers: engine
    A serves ``launch.serve``'s defaults and B and C guard a migration,
    the bare model is timed (``serve_figures``; each expert holds C = 1
    slot of a decode step, so every expert's GEMMs run and its weights
    count), the share of slots capacity dropped."""
    import torch
    from repro_torch.models.params import init_params

    cfg = moe_cfg(arch, MOE_SERVE_LAYERS, scan_layers=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(dev).manual_seed(SEED), cfg, dev)
    init_peak = torch.cuda.max_memory_allocated()
    a = model_engine(params, cfg, dev, "A")
    del params
    sync(dev)
    setup_s = time.perf_counter() - t0
    prompts = model_prompts(cfg.vocab)
    # cuBLAS set-up; the routes of the same greedy run the engine makes
    with route_log(a.model) as log:
        warm = decode_steps(a.model, cfg, prompts.to(dev))
    del warm
    L = cfg.n_layers
    drop = {"prefill": 1 - float(np.mean([k.mean() for _, k in log[:L]])),
            "decode": 1 - float(np.mean([k.mean() for _, k in log[L:]]))}
    fig, _ = serve_figures(a, cfg, prompts, f"[moe] {arch}:")
    return {"arch": arch, "layers": L, "setup_s": setup_s, **fig,
            "init_peak_gb": init_peak / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "dropped": drop}


def drive_moe_train(dev, arch: str) -> dict:
    """Phase 12 (b): ``MOE_TRAIN_STEPS`` steps of ``make_train_step`` at
    the full widths (less ``MOE_TRAIN_CUTS``), depth 1, bfloat16 masters
    and int8 moments, ``launch.train``'s batch and sequence, the launch
    counts reset just before and read just after; one more step
    profiled."""
    import torch
    from repro_torch.causal import CausalPolicy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import init_train_state, make_train_step

    cfg = moe_cfg(arch, MOE_TRAIN_LAYERS, **MOE_TRAIN_CUTS[arch])
    check(cfg.param_dtype == "bfloat16", f"[moe] {arch}: masters {cfg.param_dtype}")
    opt_cfg = train_opt(MOE_TRAIN_STEPS, "int8")
    clock_cfg = ClockConfig(policy=CausalPolicy(fp_threshold=1e-4))
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(torch.Generator(dev).manual_seed(SEED), cfg,
                             opt_cfg, clock_cfg, device=dev)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=MOE_TRAIN_SEQ,
                                  global_batch=MOE_TRAIN_BATCH))
    step = make_train_step(cfg, opt_cfg, clock_cfg)
    ops.reset_launches()
    ms, metrics = [], []
    for s in range(MOE_TRAIN_STEPS):
        batch = data.batch(s, device=dev)
        batch["ev_hi"], batch["ev_lo"] = data.event_id(s)
        sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {k: ops.LAUNCHES[k] for k in MODEL_KERNELS}
    for i, m in enumerate(metrics):
        check(np.isfinite(m["loss"]) and np.isfinite(m["aux"]) and m["aux"] > 0,
              f"[moe] {arch} train step {i}: loss {m['loss']} aux {m['aux']}")
        check(m["clock_sum"] == clock_cfg.k * (i + 1),
              f"[moe] {arch} train step {i}: clock_sum {m['clock_sum']}")
    check(launches["bloom_tick"] == MOE_TRAIN_STEPS,
          f"[moe] {arch}: {launches} launches in {MOE_TRAIN_STEPS} steps")
    prof = profiled(lambda: step(state, batch))
    return {"arch": arch, "params": cfg.n_params(),
            "cuts": MOE_TRAIN_CUTS[arch], "step_ms": float(np.median(ms[1:])),
            "step_ms_all": ms, "metrics": metrics, "profile": prof,
            "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def moe_routes(gl: list, cl: list, n_layers: int, n_gen: int) -> dict:
    """The bare runs' routes on the card (``gl``) and the CPU (``cl``),
    ``route_log`` entries of the prefill and ``n_gen`` decode calls:
    per (row, position), whether every layer gave the token the same
    expert set and kept the same slots on both devices."""
    S = MODEL_PROMPT
    ids_same = np.ones((MODEL_BATCH, S + n_gen), bool)
    kept_same = ids_same.copy()
    for call in range(1 + n_gen):
        cols = slice(0, S) if call == 0 else slice(S + call - 1, S + call)
        for layer in range(n_layers):
            (gi, gk), (ci, ck) = (gl[call * n_layers + layer],
                                  cl[call * n_layers + layer])
            og, oc = np.argsort(gi, -1), np.argsort(ci, -1)
            ids = (np.take_along_axis(gi, og, -1)
                   == np.take_along_axis(ci, oc, -1)).all(-1)
            kept = (np.take_along_axis(gk, og, -1)
                    == np.take_along_axis(ck, oc, -1)).all(-1)
            ids_same[:, cols] &= ids.reshape(MODEL_BATCH, -1)
            kept_same[:, cols] &= kept.reshape(MODEL_BATCH, -1)
    return {"ids_same": ids_same, "agree": ids_same & kept_same}


def moe_cpu_check(dev, arch: str) -> dict:
    """Phase 12 (c) for one config at the full widths, depth 1: the
    weights drawn once on the card and copied to the CPU, ``model_run``
    on both (the CPU's bare decode fed the card's tokens) under
    ``route_log``.  A token's routes agree when every layer gave it the
    same experts and kept slots on both devices; a row's logits are held
    up to its first position whose routes (or an earlier one's) differ,
    since a different expert set is a different function of the input."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = moe_cfg(arch, 1, scan_layers=False)
    params = init_params(torch.Generator(dev).manual_seed(SEED), cfg, dev)
    model = T.build(params, cfg, dev)
    t0 = time.perf_counter()
    with route_log(model) as glog:
        g = model_run(dev, model, cfg, n_gen=MOE_CMP_GEN)
    t_card = time.perf_counter() - t0
    del model
    model = T.build({k: v.cpu() for k, v in params.items()}, cfg, "cpu")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with card_blocks(), route_log(model) as clog:
        c = model_run("cpu", model, cfg, feed=g["steps"]["fed"],
                      n_gen=MOE_CMP_GEN)
    t_cpu = time.perf_counter() - t0
    del model
    n_bare = (1 + MOE_CMP_GEN) * cfg.n_layers
    r = moe_routes(glog[:n_bare], clog[:n_bare], cfg.n_layers, MOE_CMP_GEN)
    S = MODEL_PROMPT
    held_pos = np.logical_and.accumulate(r["agree"], axis=1)
    held = held_pos[:, S - 1:]              # logits of positions S-1, S, ...
    max_gap, excused, diverged, fp_gap = compare_model_runs(
        g, c, f"[moe] {arch}", held=held)
    return {"arch": arch, "layers": cfg.n_layers, "tokens": int(r["agree"].size),
            "route_differs_share": float(1 - r["ids_same"].mean()),
            "route_or_kept_differs_share": float(1 - r["agree"].mean()),
            "logit_steps_held": int(held.sum()), "logit_steps": int(held.size),
            "max_logit_gap": max_gap, "near_tie_or_unheld_steps": int(excused.sum()),
            "rows_diverged": diverged,
            "tokens_identical": bool((g["tokens"] == c["tokens"]).all()),
            "fp_abs_gap": fp_gap, "card_s": t_card, "cpu_s": t_cpu}


def moe_phase(dev, rate: float) -> dict:
    """Phase 12: (a) serving each config at ``MOE_SERVE_LAYERS`` layers,
    and through the launcher's smoke in a child process, (b) training,
    (c) card against CPU.  Returns the phase's launches (serving and
    training summed)."""
    import torch

    launches = dict.fromkeys(MODEL_KERNELS, 0)
    for arch in MOE_ARCHS:
        run = drive_moe(dev, arch)
        bound_ms = run["weight_bytes"] / rate * 1e3
        prof = run["profile"]
        print(f"[moe] {arch} full widths, depth cut to {run['layers']} layers "
              f"({run['params']} bfloat16 params), serving launch.serve's "
              f"defaults on the card: weights and engine set up in "
              f"{run['setup_s']:.2f} s; admit (prefill {MODEL_BATCH}x"
              f"{MODEL_PROMPT}) {run['admit_ms']} ms, the bare prefill "
              f"{run['prefill_bare_ms']} ms; generate {MODEL_GEN} tokens "
              f"{run['generate_ms']} ms ({run['tok_s']} tok/s)")
        print(f"[moe] {arch} decode step (bare model, host clock to a "
              f"synchronise): median over steps 2-{MODEL_GEN} "
              f"{run['decode_ms']} ms, all {json.dumps(run['decode_ms_all'])}; "
              f"bound {bound_ms} ms ({run['weight_bytes']} bytes of weights a "
              f"step reads at {rate / 1e12} TB/s): the step at "
              f"{run['decode_ms'] / bound_ms:.2f}x it")
        print(f"[moe] {arch} one decode step under the profiler: wall "
              f"{prof['wall_ms']} ms, kernels {prof['kernel_ms']} ms "
              f"({prof['device_events']} device events), copies "
              f"{prof['copy_ms']} ms, idle share {prof['idle_share']} "
              f"({prof['idle_share_with_copies']} with copies), top "
              f"{json.dumps(prof['top_device_ms'])}")
        print(f"[moe] {arch} peak memory {run['peak_gb']} GB (while drawing "
              f"the weights {run['init_peak_gb']} GB); slots dropped by "
              f"capacity {json.dumps(run['dropped'])}; launches "
              f"{json.dumps(run['launches'])}; migration B "
              f"{run['migration']['B']}, C {run['migration']['C']}; sample "
              f"{run['sample']}")
        for kname, n in run["launches"].items():
            check(n > 0, f"kernel {kname} was not launched on the {arch} "
                         f"serving path")
            launches[kname] += n
        del run
        torch.cuda.empty_cache()
    if not CHILDREN_BATCHED:
        run_launchers([serve_launcher("moe", a) for a in MOE_ARCHS])
    for arch in ("deepseek_v2_236b", "grok_1_314b"):
        tr = drive_moe_train(dev, arch)
        tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
        prof = tr["profile"]
        print(f"[moe] {arch} training at the full widths"
              + (f" but {json.dumps(tr['cuts'])}" if tr["cuts"] else "")
              + f", depth {MOE_TRAIN_LAYERS} ({tr['params']} params, bfloat16 "
              f"masters, int8 moments), batch {MOE_TRAIN_BATCH}, seq "
              f"{MOE_TRAIN_SEQ}: step median of 2-{MOE_TRAIN_STEPS} "
              f"{tr['step_ms']} ms, all {json.dumps(tr['step_ms_all'])}; "
              f"{tokens / tr['step_ms'] * 1e3} tokens/s; loss and aux "
              f"{json.dumps([[m['loss'], m['aux']] for m in tr['metrics']])}; "
              f"peak memory {tr['peak_gb']} GB; launches "
              f"{json.dumps(tr['launches'])}")
        print(f"[moe] {arch} one train step under the profiler: wall "
              f"{prof['wall_ms']} ms, kernels {prof['kernel_ms']} ms "
              f"({prof['device_events']} device events), copies "
              f"{prof['copy_ms']} ms, idle share {prof['idle_share']}, top "
              f"{json.dumps(prof['top_device_ms'])}")
        for kname, n in tr["launches"].items():
            launches[kname] += n
        del tr
        torch.cuda.empty_cache()
    for arch in MOE_ARCHS:
        small = moe_cpu_check(dev, arch)
        print(f"[moe] {arch} card and CPU at the full widths, depth 1: "
              f"clocks, registry rows and adopt_many masks identical; logits "
              f"within {LOGIT_ATOL} + {LOGIT_RTOL}|x| and greedy tokens "
              f"identical outside near ties, on the rows whose routes agree "
              f"so far: {json.dumps(small)}")
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 13: the SSM and hybrid families (mamba2-130m, hymba-1.5b)
# ---------------------------------------------------------------------------

SSM_ARCHS = ("mamba2_130m", "hymba_1_5b")
#: the full configs, nothing cut (src/repro/configs/mamba2_130m.py,
#: hymba_1_5b.py): mamba2 24 layers, d 768, 24 SSM heads x 64, N 128,
#: Q 128, V 50,280, tied; hymba 32 layers, d 1,600, 25 heads / 5 kv,
#: window 2,048 but in layers 0, 15, 31, 50 SSM heads x 64, N 16, d_ff
#: 5,504, V 32,001
SSM_PARAMS = {"mamba2_130m": 129_001_920, "hymba_1_5b": 1_641_381_120}
#: ``launch.train``'s batch and sequence (seq 128 = the configs' chunk,
#: where the reference's SSD gradient overflows), 4 steps (the median
#: leaves out the first)
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 8, 128, 4
#: card against CPU: the full widths at depth 2; the bare decode and the
#: engines' generate cut to 4 tokens; one train step at batch
#: ``TRAIN_CMP_BATCH``, seq 128
SSM_CMP_LAYERS, SSM_CMP_GEN = 2, 4


def drive_ssm(dev, arch: str) -> dict:
    """Phase 13 (a) for one full config: engine A serves
    ``launch.serve``'s defaults and B and C guard a migration, the bare
    model is timed (``serve_figures``).  Besides the weights, a decode
    step reads and writes the SSM caches and reads the K/V of its
    position (counted at the median timed step's)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params

    cfg = get_config(arch)
    check(cfg.n_params() == SSM_PARAMS[arch],
          f"[ssm] {arch}: {cfg.n_params()} params, not {SSM_PARAMS[arch]}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(dev).manual_seed(SEED), cfg, dev)
    a = model_engine(params, cfg, dev, "A")
    del params
    sync(dev)
    setup_s = time.perf_counter() - t0
    prompts = model_prompts(cfg.vocab)
    warm = decode_steps(a.model, cfg, prompts.to(dev))    # cuBLAS set-up
    del warm
    fig, caches = serve_figures(a, cfg, prompts, f"[ssm] {arch}:")
    state_bytes = 2 * sum(t.numel() * t.element_size()
                          for t in (caches["ssm"].conv, caches["ssm"].state))
    kv_bytes = 0
    if "attn" in caches:
        k = caches["attn"].k            # [L, B, buf, KV, Dh]
        per_pos = 2 * k[:, :, 0].numel() * k.element_size()
        kv_bytes = per_pos * (MODEL_PROMPT + MODEL_GEN // 2 + 1)
    return {"arch": arch, "setup_s": setup_s, **fig,
            "state_bytes": state_bytes, "kv_bytes": kv_bytes,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def drive_ssm_train(dev, arch: str) -> dict:
    """Phase 13 (b): ``SSM_TRAIN_STEPS`` steps of ``make_train_step`` at
    the full config, float32 masters and moments, ``launch.train``'s
    batch and sequence, the launch counts reset just before and read
    just after: every step's loss and grad norm finite (a non-finite
    gradient entry makes the norm non-finite), the params finite after
    the run; one more step profiled."""
    import torch
    from repro_torch.causal import CausalPolicy
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import init_train_state, make_train_step

    cfg = get_config(arch)
    check(cfg.param_dtype == "float32" and cfg.ssm_chunk == SSM_TRAIN_SEQ,
          f"[ssm] {arch}: masters {cfg.param_dtype}, chunk {cfg.ssm_chunk}")
    opt_cfg = train_opt(SSM_TRAIN_STEPS)
    clock_cfg = ClockConfig(policy=CausalPolicy(fp_threshold=1e-4))
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(torch.Generator(dev).manual_seed(SEED), cfg,
                             opt_cfg, clock_cfg, device=dev)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SSM_TRAIN_SEQ,
                                  global_batch=SSM_TRAIN_BATCH))
    step = make_train_step(cfg, opt_cfg, clock_cfg)
    ops.reset_launches()
    ms, metrics = [], []
    for s in range(SSM_TRAIN_STEPS):
        batch = data.batch(s, device=dev)
        batch["ev_hi"], batch["ev_lo"] = data.event_id(s)
        sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {k: ops.LAUNCHES[k] for k in MODEL_KERNELS}
    for i, m in enumerate(metrics):
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"[ssm] {arch} train step {i}: loss {m['loss']} grad norm "
              f"{m['grad_norm']}")
        check(m["clock_sum"] == clock_cfg.k * (i + 1),
              f"[ssm] {arch} train step {i}: clock_sum {m['clock_sum']}")
    for k, p in state.params.items():
        check(bool(p.isfinite().all()), f"[ssm] {arch} param {k} not finite")
    check(launches["bloom_tick"] == SSM_TRAIN_STEPS,
          f"[ssm] {arch}: {launches} launches in {SSM_TRAIN_STEPS} steps")
    prof = profiled(lambda: step(state, batch))
    return {"arch": arch, "params": cfg.n_params(),
            "step_ms": float(np.median(ms[1:])), "step_ms_all": ms,
            "metrics": metrics, "profile": prof, "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def cache_gap_of(g, c, what: str) -> float:
    """A cache tensor on the card ``g`` and the CPU ``c``: finite and
    within ``LOGIT_ATOL + LOGIT_RTOL |x|``.  Returns the largest gap."""
    a, b = host(g.float()), host(c.float())
    gap = np.abs(a - b)
    check(bool(np.isfinite(a).all()
               and (gap <= LOGIT_ATOL + LOGIT_RTOL * np.abs(b)).all()),
          f"{what} differs by {gap.max()} across devices")
    return float(gap.max())


def one_step_cpu_check(dev, cfg, seq: int, tag: str) -> dict:
    """One train step at ``cfg``, batch ``TRAIN_CMP_BATCH``, seq ``seq``
    on the card and the CPU from one state drawn on the card: clock
    cells identical, loss and grad norm within ``TRAIN_LOSS_RTOL``,
    every param within the most two AdamW steps can part
    (``train_cpu_check``'s bound)."""
    import torch
    from repro_torch.causal import CausalPolicy
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import init_train_state

    opt_cfg = train_opt(1)
    clock_cfg = ClockConfig(policy=CausalPolicy(fp_threshold=1e-4))
    state = init_train_state(torch.Generator(dev).manual_seed(SEED), cfg,
                             opt_cfg, clock_cfg, device=dev)
    t0 = time.perf_counter()
    gt = train_run(dev, state, cfg, opt_cfg, clock_cfg, 1, seq=seq)
    t_card = time.perf_counter() - t0
    start = move_state(state, "cpu")
    del state
    t0 = time.perf_counter()
    ct = train_run("cpu", start, cfg, opt_cfg, clock_cfg, 1, seq=seq)
    t_cpu = time.perf_counter() - t0
    gs, cs = gt["state"], ct["state"]
    check_equal(host(gs.clock_cells), host(cs.clock_cells),
                f"{tag} train card vs CPU clock cells")
    (mg,), (mc,) = gt["metrics"], ct["metrics"]
    gaps = {}
    for key in ("loss", "grad_norm"):
        check(np.isfinite(mg[key]), f"{tag} train {key} {mg[key]}")
        gaps[key] = abs(mg[key] - mc[key]) / abs(mc[key])
        check(gaps[key] <= TRAIN_LOSS_RTOL,
              f"{tag} train {key}: card {mg[key]} CPU {mc[key]}")
    lr = mc["lr"]
    p_max = max(float(p.abs().max()) for p in cs.params.values())
    bound = 2 * 1.0003 * lr + 2 * lr * opt_cfg.weight_decay * p_max + 1e-6
    worst = 0.0
    for k, p in cs.params.items():
        d = float((gs.params[k].cpu() - p).abs().max())
        worst = max(worst, d)
        check(d <= bound, f"{tag} train param {k}: card and CPU {d} "
                          f"apart, past the AdamW bound {bound}")
    return {"batch": TRAIN_CMP_BATCH, "seq": seq, "metrics": [mg, mc],
            "rel_gaps": gaps, "max_param_gap": worst, "param_bound": bound,
            "card_s": t_card, "cpu_s": t_cpu}


def ssm_cpu_check(dev, arch: str) -> dict:
    """Phase 13 (c) for one config at the full widths, depth
    ``SSM_CMP_LAYERS``: the weights drawn once on the card and copied to
    the CPU; ``model_run`` on both (the CPU's bare decode fed the card's
    tokens), held by ``compare_model_runs``, and the bare runs' SSM
    caches after the decode within ``LOGIT_ATOL + LOGIT_RTOL |x|``; then
    one train step at seq ``SSM_TRAIN_SEQ`` (``one_step_cpu_check``)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_config(arch), n_layers=SSM_CMP_LAYERS)
    params = init_params(torch.Generator(dev).manual_seed(SEED), cfg, dev)
    t0 = time.perf_counter()
    g = model_run(dev, params, cfg, n_gen=SSM_CMP_GEN)
    t_card = time.perf_counter() - t0
    params = {k: v.cpu() for k, v in params.items()}
    t0 = time.perf_counter()
    with card_blocks():
        c = model_run("cpu", params, cfg, feed=g["steps"]["fed"],
                      n_gen=SSM_CMP_GEN)
    t_cpu = time.perf_counter() - t0
    max_gap, excused, diverged, fp_gap = compare_model_runs(
        g, c, f"[ssm] {arch}")
    cache_gap = {name: cache_gap_of(
        getattr(g["steps"]["caches"]["ssm"], name),
        getattr(c["steps"]["caches"]["ssm"], name),
        f"[ssm] {arch} SSM {name} cache") for name in ("conv", "state")}

    train = one_step_cpu_check(dev, cfg, SSM_TRAIN_SEQ, f"[ssm] {arch}")
    return {"arch": arch, "layers": SSM_CMP_LAYERS, "params": cfg.n_params(),
            "max_logit_gap": max_gap, "near_tie_steps": int(excused.sum()),
            "rows_diverged_at_near_ties": diverged,
            "tokens_identical": bool((g["tokens"] == c["tokens"]).all()),
            "ssm_cache_max_gap": cache_gap, "fp_abs_gap": fp_gap,
            "train": train, "card_s": t_card, "cpu_s": t_cpu}


def ssm_phase(dev, rate: float) -> dict:
    """Phase 13: (a) serving each full config, and through the
    launcher's smoke in a child process, (b) training each full config,
    (c) card against CPU.  Returns the phase's launches (serving and
    training summed)."""
    import torch

    launches = dict.fromkeys(MODEL_KERNELS, 0)
    for arch in SSM_ARCHS:
        run = drive_ssm(dev, arch)
        step_bytes = run["weight_bytes"] + run["state_bytes"] + run["kv_bytes"]
        bound_ms = step_bytes / rate * 1e3
        prof = run["profile"]
        print(f"[ssm] {arch} full config ({run['params']} float32 masters, "
              f"bfloat16 compute), serving launch.serve's defaults on the "
              f"card: weights and engine set up in {run['setup_s']:.2f} s; "
              f"admit (prefill {MODEL_BATCH}x{MODEL_PROMPT}) "
              f"{run['admit_ms']} ms, the bare prefill "
              f"{run['prefill_bare_ms']} ms; generate {MODEL_GEN} tokens "
              f"{run['generate_ms']} ms ({run['tok_s']} tok/s)")
        print(f"[ssm] {arch} decode step (bare model, host clock to a "
              f"synchronise): median over steps 2-{MODEL_GEN} "
              f"{run['decode_ms']} ms, all {json.dumps(run['decode_ms_all'])}; "
              f"bound {bound_ms} ms ({run['weight_bytes']} bytes of weights, "
              f"{run['state_bytes']} of SSM caches read and written, "
              f"{run['kv_bytes']} of K/V at {rate / 1e12} TB/s): the step at "
              f"{run['decode_ms'] / bound_ms:.2f}x it")
        print(f"[ssm] {arch} one decode step under the profiler: wall "
              f"{prof['wall_ms']} ms, kernels {prof['kernel_ms']} ms "
              f"({prof['device_events']} device events), copies "
              f"{prof['copy_ms']} ms, idle share {prof['idle_share']} "
              f"({prof['idle_share_with_copies']} with copies), top "
              f"{json.dumps(prof['top_device_ms'])}")
        print(f"[ssm] {arch} peak memory {run['peak_gb']} GB; launches "
              f"{json.dumps(run['launches'])}; migration B "
              f"{run['migration']['B']}, C {run['migration']['C']}; sample "
              f"{run['sample']}")
        for kname, n in run["launches"].items():
            check(n > 0, f"kernel {kname} was not launched on the {arch} "
                         f"serving path")
            launches[kname] += n
        del run
        torch.cuda.empty_cache()
    if not CHILDREN_BATCHED:
        run_launchers([serve_launcher("ssm", a) for a in SSM_ARCHS])
    for arch in SSM_ARCHS:
        tr = drive_ssm_train(dev, arch)
        tokens = SSM_TRAIN_BATCH * SSM_TRAIN_SEQ
        flop_ms = 6 * tr["params"] * tokens / BF16_FLOPS * 1e3
        adamw_ms = ADAMW_BYTES * tr["params"] / rate * 1e3
        prof = tr["profile"]
        print(f"[ssm] {arch} training at the full config ({tr['params']} "
              f"params, float32 masters and moments), batch {SSM_TRAIN_BATCH}, "
              f"seq {SSM_TRAIN_SEQ}: step median of 2-{SSM_TRAIN_STEPS} "
              f"{tr['step_ms']} ms, all {json.dumps(tr['step_ms_all'])}; "
              f"{tokens / tr['step_ms'] * 1e3} tokens/s; least times: "
              f"{flop_ms} ms of bfloat16 FLOPs (6 x {tr['params']} x {tokens} "
              f"at {BF16_FLOPS / 1e12} TFLOP/s), {adamw_ms} ms of AdamW bytes "
              f"({ADAMW_BYTES} a param at {rate / 1e12} TB/s): the step at "
              f"{tr['step_ms'] / max(flop_ms, adamw_ms):.1f}x the larger; "
              f"loss and grad norm, all finite "
              f"{json.dumps([[m['loss'], m['grad_norm']] for m in tr['metrics']])}; "
              f"peak memory {tr['peak_gb']} GB; launches "
              f"{json.dumps(tr['launches'])}")
        print(f"[ssm] {arch} one train step under the profiler: wall "
              f"{prof['wall_ms']} ms, kernels {prof['kernel_ms']} ms "
              f"({prof['device_events']} device events), copies "
              f"{prof['copy_ms']} ms, idle share {prof['idle_share']}, top "
              f"{json.dumps(prof['top_device_ms'])}")
        for kname, n in tr["launches"].items():
            launches[kname] += n
        del tr
        torch.cuda.empty_cache()
    for arch in SSM_ARCHS:
        small = ssm_cpu_check(dev, arch)
        print(f"[ssm] {arch} card and CPU at the full widths, depth "
              f"{SSM_CMP_LAYERS} (reduced: depth only): clocks, registry rows "
              f"and adopt_many masks identical; logits and SSM caches within "
              f"{LOGIT_ATOL} + {LOGIT_RTOL}|x|, greedy tokens identical outside "
              f"near ties; one train step within {TRAIN_LOSS_RTOL} (loss, grad "
              f"norm) and the AdamW bound (params): {json.dumps(small)}")
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 14: the enc-dec family (whisper-large-v3)
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "whisper_large_v3"
#: the full config, nothing cut (src/repro/configs/whisper_large_v3.py):
#: 32 encoder and 32 decoder layers, d 1,280, 20 heads x 64, d_ff 5,120,
#: 1,500 frames, V 51,866 padded to 51,968, untied, learned positions
ENCDEC_PARAMS = 1_656_586_240
#: the train step: ``launch.train``'s seq 128, lr 3e-3, float32 AdamW, 4
#: steps; the batch the largest of these whose step stays under
#: ``ENCDEC_PEAK_GB`` on the card (the encoder keeps its activations: it
#: runs without remat, as the reference runs it)
ENCDEC_BATCHES, ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_STEPS = (8, 4, 2, 1), 128, 4
ENCDEC_PEAK_GB = 76.0
#: card against CPU: the full widths at depth 1 (decoder and encoder; cut
#: from 2 for the script's time limit: the CPU's encoder over 4 x 1,500
#: frames takes most of it), the frames at the full 1,500; 4 decode
#: steps; one train step at batch ``TRAIN_CMP_BATCH``, seq ``TRAIN_CMP_SEQ``
ENCDEC_CMP_LAYERS, ENCDEC_CMP_GEN = 1, 4


def encdec_frames(batch: int, cfg, step: int = 0):
    """The encoder's input, frame embeddings [batch, enc_seq, d_model]
    (the conv frontend is a stub), from a CPU generator seeded by the
    step."""
    import torch
    return torch.randn((batch, cfg.enc_seq, cfg.d_model),
                       generator=torch.Generator().manual_seed(SEED + 2 + step))


def encdec_step_flops(cfg, batch: int, seq: int) -> float:
    """The matrix FLOPs of a train step (forward and backward: 6 a
    parameter and a row it multiplies): the encoder's layers and the
    cross K/V projections over ``batch`` x enc_seq frames, the rest of
    the decoder and the head over ``batch`` x ``seq`` tokens; the
    attention's scores and values at 12 Sq Skv d a layer and a sample
    (the decoder's causal self-attention at half of seq^2)."""
    from repro_torch.models.params import param_table

    frames, enc, dec = batch * cfg.enc_seq, 0, 0
    for k, info in param_table(cfg).items():
        n = int(np.prod(info.shape))
        if k.startswith(("enc_layers", "encoder/norm_f")) or re.fullmatch(
                r"layers/cross/[wb][kv]", k):
            enc += n
        elif not k.startswith(("embed/", "encoder/pos")):
            dec += n
    se, d = cfg.enc_seq, cfg.d_model
    attn = 12 * d * batch * (cfg.n_enc_layers * se * se
                             + cfg.n_layers * (seq * seq / 2 + seq * se))
    return 6 * (enc * frames + dec * batch * seq) + attn


def drive_encdec(dev) -> dict:
    """Phase 14 (a): the full config serving ``launch.serve``'s batch,
    prompt and tokens through the functional entry points (the engine
    passes no frames, as the reference's does not): the encoder alone,
    then ``prefill`` with the frames and ``MODEL_GEN`` greedy
    ``decode_step``s timed (``decode_steps``), one more decode step
    profiled.  A decode step reads the decoder's weights but the cross
    K/V projections (and of the embedding tables one row a token), the
    cross K/V and the self-attention K/V of its position (counted at the
    median timed step's)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = get_config(ENCDEC_ARCH)
    check(cfg.n_params() == ENCDEC_PARAMS,
          f"[encdec] {cfg.n_params()} params, not {ENCDEC_PARAMS}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(dev).manual_seed(SEED), cfg, dev)
    model = T.build(params, cfg, dev)
    del params
    sync(dev)
    setup_s = time.perf_counter() - t0
    prompts = model_prompts(cfg.vocab).to(dev)
    frames = encdec_frames(MODEL_BATCH, cfg).to(dev)
    warm = decode_steps(model, cfg, prompts, frames=frames)   # cuBLAS set-up
    del warm
    sync(dev)
    t0 = time.perf_counter()
    enc = T.encode(model, cfg, frames)
    sync(dev)
    encode_ms = (time.perf_counter() - t0) * 1e3
    check(tuple(enc.shape) == (MODEL_BATCH, cfg.enc_seq, cfg.d_model)
          and bool(enc.isfinite().all()),
          f"[encdec] encoder output {tuple(enc.shape)} or not finite")
    del enc
    timed = decode_steps(model, cfg, prompts, frames=frames, timed=True)
    caches, nxt = timed["caches"], timed["next"]
    toks = torch.stack(timed["fed"], 1)
    check(tuple(toks.shape) == (MODEL_BATCH, MODEL_GEN)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"[encdec] generated tokens {tuple(toks.shape)} out of range")
    check(all(bool(lo.isfinite().all()) for lo in timed["logits"]),
          "[encdec] non-finite logits")
    prof = profiled(lambda: T.decode_step(model, cfg, caches, nxt,
                                          MODEL_PROMPT + MODEL_GEN))
    weight_bytes = sum(
        b.numel() * b.element_size() for n, b in model.named_buffers()
        if not n.startswith(("encoder.", "embed."))
        and not re.search(r"\.cross\.[wb][kv]$", n))
    ck = caches["cross"].k
    cross_bytes = 2 * ck.numel() * ck.element_size()
    k = caches["attn"].k                 # [L, B, buf, KV, Dh]
    kv_bytes = (2 * k[:, :, 0].numel() * k.element_size()
                * (MODEL_PROMPT + MODEL_GEN // 2 + 1))
    decode_s = sum(timed["ms"]) / 1e3
    return {"params": cfg.n_params(), "frames": list(frames.shape),
            "setup_s": setup_s,
            "encode_ms": encode_ms, "prefill_ms": timed["prefill_ms"],
            "decode_ms": float(np.median(timed["ms"][1:])),
            "decode_ms_all": timed["ms"],
            "tok_s": MODEL_BATCH * MODEL_GEN / decode_s, "profile": prof,
            "weight_bytes": weight_bytes, "cross_bytes": cross_bytes,
            "kv_bytes": kv_bytes, "sample": toks[:, :8].tolist(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def drive_encdec_train(dev) -> dict:
    """Phase 14 (b): ``ENCDEC_TRAIN_STEPS`` steps of ``make_train_step``
    at the full config, float32 masters and moments, seq
    ``ENCDEC_TRAIN_SEQ``, each batch with its frames, the launch counts
    reset just before and read just after.  The first step is tried at
    each of ``ENCDEC_BATCHES`` in turn from the fresh state: a batch
    that runs out of memory or peaks at ``ENCDEC_PEAK_GB`` or more is
    dropped, and the first that fits is the run's (its first step the
    run's first).  Every loss and grad norm finite, the params finite
    after the run, one tick a step; one more step profiled."""
    import torch
    from repro_torch.causal import CausalPolicy
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.runtime.training import init_train_state, make_train_step

    cfg = get_config(ENCDEC_ARCH)
    check(cfg.param_dtype == "float32", f"[encdec] masters {cfg.param_dtype}")
    opt_cfg = train_opt(ENCDEC_TRAIN_STEPS)
    clock_cfg = ClockConfig(policy=CausalPolicy(fp_threshold=1e-4))
    state = init_train_state(torch.Generator(dev).manual_seed(SEED), cfg,
                             opt_cfg, clock_cfg, device=dev)
    step = make_train_step(cfg, opt_cfg, clock_cfg)

    def batch_of(s: int, b: int) -> dict:
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=ENCDEC_TRAIN_SEQ,
                                      global_batch=b))
        batch = data.batch(s, device=dev)
        batch["ev_hi"], batch["ev_lo"] = data.event_id(s)
        batch["enc_frames"] = encdec_frames(b, cfg, s).to(dev)
        return batch

    ops.reset_launches()
    tried, dropped = {}, 0
    for b in ENCDEC_BATCHES:
        batch = batch_of(0, b)
        gc.collect()                 # what a failed attempt left behind
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sync(dev)
        t0 = time.perf_counter()
        try:
            new, m = step(state, batch)
            sync(dev)
        except torch.OutOfMemoryError:
            tried[b] = "out of memory"
            continue
        first_ms = (time.perf_counter() - t0) * 1e3
        tried[b] = torch.cuda.max_memory_allocated() / 1e9
        if tried[b] < ENCDEC_PEAK_GB:
            state = new
            break
        dropped += 1                 # a step that ran: its tick launched
        del new, m
    else:
        raise SmokeFailure(f"[encdec] no train batch fits: {tried}")
    del new, batch                   # the fresh state goes with them
    print(f"[encdec] train batch {b}: first steps tried at {json.dumps(tried)} "
          f"(peak GB)", flush=True)
    ms, metrics = [first_ms], [{k: float(v) for k, v in m.items()}]
    for s in range(1, ENCDEC_TRAIN_STEPS):
        batch = batch_of(s, b)
        sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {k: ops.LAUNCHES[k] for k in MODEL_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, m in enumerate(metrics):
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"[encdec] train step {i}: loss {m['loss']} grad norm "
              f"{m['grad_norm']}")
        check(m["clock_sum"] == clock_cfg.k * (i + 1),
              f"[encdec] train step {i}: clock_sum {m['clock_sum']}")
    for k, p in state.params.items():
        check(bool(p.isfinite().all()), f"[encdec] param {k} not finite")
    check(launches["bloom_tick"] == ENCDEC_TRAIN_STEPS + dropped,
          f"[encdec] {launches} launches in {ENCDEC_TRAIN_STEPS} steps "
          f"(+{dropped} dropped)")
    check(peak_gb < ENCDEC_PEAK_GB, f"[encdec] train peak {peak_gb} GB")
    launches["bloom_tick"] -= dropped
    prof = profiled(lambda: step(state, batch))
    return {"params": cfg.n_params(), "batch": b, "tried": tried,
            "enc_seq": cfg.enc_seq,
            "step_ms": float(np.median(ms[1:])), "step_ms_all": ms,
            "flops": encdec_step_flops(cfg, b, ENCDEC_TRAIN_SEQ),
            "metrics": metrics, "profile": prof, "launches": launches,
            "peak_gb": peak_gb}


def encdec_cpu_check(dev) -> dict:
    """Phase 14 (c): the full widths at depth ``ENCDEC_CMP_LAYERS``
    (decoder and encoder), the weights drawn once on the card and copied
    to the CPU, the same prompts and full-length frames on both: prefill
    and ``ENCDEC_CMP_GEN`` decode steps (the CPU fed the card's tokens)
    held by ``compare_logit_steps``, the cross and self K/V after them
    within ``LOGIT_ATOL + LOGIT_RTOL |x|``; one train step
    (``one_step_cpu_check``)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_config(ENCDEC_ARCH),
                              n_layers=ENCDEC_CMP_LAYERS,
                              n_enc_layers=ENCDEC_CMP_LAYERS)
    params = init_params(torch.Generator(dev).manual_seed(SEED), cfg, dev)
    prompts, frames = model_prompts(cfg.vocab), encdec_frames(MODEL_BATCH, cfg)
    t0 = time.perf_counter()
    g = decode_steps(T.build(params, cfg, dev), cfg, prompts.to(dev),
                     frames=frames.to(dev), n_gen=ENCDEC_CMP_GEN)
    t_card = time.perf_counter() - t0
    params = {k: v.cpu() for k, v in params.items()}
    t0 = time.perf_counter()
    c = decode_steps(T.build(params, cfg, "cpu"), cfg, prompts, feed=g["fed"],
                     frames=frames, n_gen=ENCDEC_CMP_GEN)
    t_cpu = time.perf_counter() - t0
    del params
    max_gap, excused = compare_logit_steps(g["logits"], c["logits"],
                                           "[encdec]")
    gc, cc = g["caches"], c["caches"]
    cache_gap = {name: cache_gap_of(getattr(gc[key], n), getattr(cc[key], n),
                                    f"[encdec] {name}")
                 for name, key, n in (("cross k", "cross", "k"),
                                      ("cross v", "cross", "v"),
                                      ("self k", "attn", "k"),
                                      ("self v", "attn", "v"))}
    train = one_step_cpu_check(dev, cfg, TRAIN_CMP_SEQ, "[encdec]")
    return {"layers": ENCDEC_CMP_LAYERS, "params": cfg.n_params(),
            "max_logit_gap": max_gap, "near_tie_steps": int(excused.sum()),
            "tokens_identical": all(
                bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                for a, b in zip(g["logits"], c["logits"])),
            "cache_max_gap": cache_gap, "train": train,
            "card_s": t_card, "cpu_s": t_cpu}


def encdec_phase(dev, rate: float) -> dict:
    """Phase 14: (a) serving the full config, (b) training it, (c) card
    against CPU at depth ``ENCDEC_CMP_LAYERS``.  Returns the phase's
    launches (the train steps' ticks)."""
    import torch

    run = drive_encdec(dev)
    step_bytes = run["weight_bytes"] + run["cross_bytes"] + run["kv_bytes"]
    bound_ms = step_bytes / rate * 1e3
    prof = run["profile"]
    print(f"[encdec] {ENCDEC_ARCH} full config ({run['params']} float32 "
          f"masters, bfloat16 compute) on the card, {MODEL_BATCH} prompts of "
          f"{MODEL_PROMPT} tokens, frames {run['frames']}: "
          f"weights set up in {run['setup_s']:.2f} s; encode "
          f"{run['encode_ms']} ms; prefill (encode, the decoder over the "
          f"prompts, the cross K/V) {run['prefill_ms']} ms; {MODEL_GEN} greedy "
          f"tokens {run['tok_s']} tok/s; sample {run['sample']}")
    print(f"[encdec] decode step (bare model, host clock to a synchronise): "
          f"median over steps 2-{MODEL_GEN} {run['decode_ms']} ms, all "
          f"{json.dumps(run['decode_ms_all'])}; bound {bound_ms} ms "
          f"({run['weight_bytes']} bytes of decoder weights and head, "
          f"{run['cross_bytes']} of cross K/V, {run['kv_bytes']} of self K/V "
          f"at {rate / 1e12} TB/s): the step at "
          f"{run['decode_ms'] / bound_ms:.2f}x it")
    print(f"[encdec] one decode step under the profiler: wall "
          f"{prof['wall_ms']} ms, kernels {prof['kernel_ms']} ms "
          f"({prof['device_events']} device events), copies "
          f"{prof['copy_ms']} ms, idle share {prof['idle_share']} "
          f"({prof['idle_share_with_copies']} with copies), top "
          f"{json.dumps(prof['top_device_ms'])}; peak memory "
          f"{run['peak_gb']} GB")
    del run
    torch.cuda.empty_cache()
    tr = drive_encdec_train(dev)
    b = tr["batch"]
    tokens = b * ENCDEC_TRAIN_SEQ
    flop_ms = tr["flops"] / BF16_FLOPS * 1e3
    adamw_ms = ADAMW_BYTES * tr["params"] / rate * 1e3
    prof = tr["profile"]
    print(f"[encdec] training at the full config ({tr['params']} params, "
          f"float32 masters and moments), seq {ENCDEC_TRAIN_SEQ}, batch {b} "
          f"(first steps tried, peak GB: {json.dumps(tr['tried'])}; reduced "
          f"from 8 under {ENCDEC_PEAK_GB} GB): step median of "
          f"2-{ENCDEC_TRAIN_STEPS} {tr['step_ms']} ms, all "
          f"{json.dumps(tr['step_ms_all'])}; {tokens / tr['step_ms'] * 1e3} "
          f"tokens/s ({b * tr['enc_seq'] / tr['step_ms'] * 1e3} frames/s); least "
          f"times: {flop_ms} ms of bfloat16 FLOPs ({tr['flops']} at "
          f"{BF16_FLOPS / 1e12} TFLOP/s), {adamw_ms} ms of AdamW bytes "
          f"({ADAMW_BYTES} a param at {rate / 1e12} TB/s): the step at "
          f"{tr['step_ms'] / max(flop_ms, adamw_ms):.1f}x the larger; loss and "
          f"grad norm, all finite "
          f"{json.dumps([[m['loss'], m['grad_norm']] for m in tr['metrics']])}; "
          f"peak memory {tr['peak_gb']} GB; launches "
          f"{json.dumps(tr['launches'])}")
    print(f"[encdec] one train step under the profiler: wall "
          f"{prof['wall_ms']} ms, kernels {prof['kernel_ms']} ms "
          f"({prof['device_events']} device events), copies "
          f"{prof['copy_ms']} ms, idle share {prof['idle_share']}, top "
          f"{json.dumps(prof['top_device_ms'])}")
    launches = tr["launches"]
    check(launches["bloom_tick"] > 0,
          "kernel bloom_tick was not launched on the enc-dec path")
    del tr
    torch.cuda.empty_cache()
    small = encdec_cpu_check(dev)
    print(f"[encdec] card and CPU at the full widths, depth "
          f"{ENCDEC_CMP_LAYERS} + {ENCDEC_CMP_LAYERS} (reduced: depth only): "
          f"logits, cross and self K/V within {LOGIT_ATOL} + {LOGIT_RTOL}|x|, "
          f"greedy tokens identical outside near ties; one train step within "
          f"{TRAIN_LOSS_RTOL} (loss, grad norm) and the AdamW bound (params): "
          f"{json.dumps(small)}")
    torch.cuda.empty_cache()
    return launches


_SOURCES = {
    "bloom_tick": ("src/repro_torch/kernels/csrc/bloom_tick.cu",
                   "src/repro/kernels/bloom_tick.py:32"),
    "bloom_merge_compare": ("src/repro_torch/kernels/csrc/bloom_compare.cu",
                            "src/repro/kernels/bloom_compare.py:30"),
    "one_vs_many_packed": ("src/repro_torch/kernels/csrc/one_vs_many.cu",
                           "src/repro/kernels/template.py:578"),
    "one_vs_many_i32": ("src/repro_torch/kernels/csrc/one_vs_many.cu",
                        "src/repro/kernels/template.py:578"),
    "hybrid": ("src/repro_torch/kernels/csrc/one_vs_many.cu",
               "src/repro/kernels/template.py:639"),
    "matrix_tri": ("src/repro_torch/kernels/csrc/bloom_matrix.cu",
                   "src/repro/kernels/template.py:316"),
    "matrix_rect_u8": ("src/repro_torch/kernels/csrc/bloom_matrix.cu",
                       "src/repro/kernels/template.py:375"),
    "matrix_rect_i32": ("src/repro_torch/kernels/csrc/bloom_matrix.cu",
                        "src/repro/kernels/template.py:425"),
    "matrix_mxu": ("src/repro_torch/kernels/csrc/bloom_mxu.cu",
                   "src/repro/kernels/template.py:506"),
}

# ---------------------------------------------------------------------------
# phase 15: the model mesh (DTensor)
# ---------------------------------------------------------------------------

#: the mesh phase's train steps at ``launch.train``'s defaults
MESH_TRAIN_STEPS = 2


def mesh_group():
    """A one-rank NCCL process group in this process, from an in-memory
    store (no network), and the (1, 1) local mesh over it."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    return make_local_mesh(1, 1)


def mesh_serve(params, cfg, prompts, mesh=None, timed_step: bool = False):
    """Prefill and ``MODEL_GEN`` greedy decode steps of the model built
    from ``params`` (DTensors under ``mesh``, plain without): each step's
    logits as float32 on the host, the greedy tokens, each decode step's
    host-clock ms to a synchronise, and with ``timed_step`` one more
    decode step under the profiler."""
    import torch
    from repro_torch import sharding as SH
    from repro_torch.models import transformer as T

    ctx = SH.use_mesh_rules(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx, torch.no_grad():
        model = T.build(params, cfg)
        dev = model.device
        logits, caches = T.prefill(model, cfg, prompts.to(dev),
                                   buf_len=MODEL_PROMPT + MODEL_GEN + 8)
        logits = SH.to_local(logits)
        out, toks, ms = [logits.float().cpu()], [], []
        for i in range(MODEL_GEN):
            tok = logits.argmax(-1).to(torch.int32)
            toks.append(tok.cpu())
            sync(dev)
            t0 = time.perf_counter()
            logits, caches = T.decode_step(model, cfg, caches, tok,
                                           MODEL_PROMPT + i)
            logits = SH.to_local(logits)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(logits.float().cpu())
        tok = logits.argmax(-1).to(torch.int32)
        prof = (profiled(lambda: T.decode_step(
            model, cfg, caches, tok, MODEL_PROMPT + MODEL_GEN))
            if timed_step else None)
    return {"logits": out, "tokens": torch.stack(toks), "ms": ms,
            "profile": prof}


def mesh_train(dev, state, cfg, opt_cfg, clock_cfg, data, mesh=None) -> dict:
    """``MESH_TRAIN_STEPS`` train steps from ``state`` on ``launch.train``'s
    data stream (under ``mesh`` when given): the final state, each
    step's metrics and host-clock ms to a synchronise."""
    from repro_torch import sharding as SH
    from repro_torch.runtime.training import make_train_step

    ctx = SH.use_mesh_rules(mesh) if mesh is not None else contextlib.nullcontext()
    step = make_train_step(cfg, opt_cfg, clock_cfg)
    metrics, ms = [], []
    with ctx:
        for s in range(MESH_TRAIN_STEPS):
            batch = data.batch(s, device=dev)
            batch["ev_hi"], batch["ev_lo"] = data.event_id(s)
            sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
    return {"state": state, "metrics": metrics, "ms": ms}


def same_tensor(got, want, what: str, held: list) -> None:
    """``got`` (a DTensor's full value) bit-identical to ``want``; where
    not, the difference is named in ``held`` and must stay within the
    port's card-vs-CPU bfloat16 tolerance."""
    import torch
    from repro_torch import sharding as SH

    g, w = SH.to_local(got).float().cpu(), want.float().cpu()
    if torch.equal(g, w):
        return
    gap = float((g - w).abs().max())
    held.append([what, gap])
    check(bool(((g - w).abs() <= LOGIT_ATOL + LOGIT_RTOL * w.abs()).all()),
          f"[mesh] {what}: the DTensor run is {gap} from the plain run")


def mesh_phase(dev, rate: float) -> dict:
    """Phase 15: Qwen1.5-0.5B's full config with DTensor parameters on a
    one-rank NCCL mesh, against the plain path on the same card: serving
    (prefill and ``MODEL_GEN`` greedy steps) and ``MESH_TRAIN_STEPS``
    train steps at ``launch.train``'s defaults.  Returns the mesh train
    steps' launches."""
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as SH
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import specs as S
    from repro_torch.launch import train as launch
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import Moment
    from repro_torch.runtime.training import init_train_state

    t0 = time.perf_counter()
    mesh = mesh_group()
    try:
        cfg = get_config(MODEL_ARCH)
        rules = SH.DEFAULT_RULES
        params = init_params(torch.Generator(dev).manual_seed(SEED), cfg, dev)
        dparams = S.place(params, S.params_shardings(mesh, rules, cfg))
        prompts = model_prompts(cfg.vocab)
        mesh_serve(params, cfg, prompts)          # cuBLAS and NCCL set-up
        plain = mesh_serve(params, cfg, prompts)
        dt = mesh_serve(dparams, cfg, prompts, mesh, timed_step=True)
        check_equal(dt["tokens"].numpy(), plain["tokens"].numpy(),
                    "[mesh] greedy tokens, DTensor vs plain")
        held: list = []
        for i, (g, w) in enumerate(zip(dt["logits"], plain["logits"])):
            same_tensor(g, w, f"logits of step {i}", held)
        serve_ms = (float(np.median(dt["ms"][1:])),
                    float(np.median(plain["ms"][1:])))
        del params, dparams

        args = launch.parse_args([])
        cfg, opt_cfg, clock_cfg, data = launch.build(args)
        state = init_train_state(torch.Generator(dev).manual_seed(SEED), cfg,
                                 opt_cfg, clock_cfg, device=dev)
        dstate = S.place(state, S.state_shardings(
            mesh, rules, cfg, S.abstract_state(cfg, opt_cfg, clock_cfg)))
        want = mesh_train(dev, state, cfg, opt_cfg, clock_cfg, data)
        ops.reset_launches()
        got = mesh_train(dev, dstate, cfg, opt_cfg, clock_cfg, data, mesh)
        launches = {"bloom_tick": ops.LAUNCHES["bloom_tick"]}
        check(launches["bloom_tick"] == MESH_TRAIN_STEPS,
              f"[mesh] {launches['bloom_tick']} tick launches in "
              f"{MESH_TRAIN_STEPS} DTensor train steps")
        for s, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            for k in ("loss", "grad_norm", "clock_sum"):
                check(g[k] == w[k] or abs(g[k] - w[k]) <= TRAIN_LOSS_RTOL
                      * abs(w[k]), f"[mesh] step {s} {k}: {g[k]} vs {w[k]}")
                if g[k] != w[k]:
                    held.append([f"step {s} {k}", abs(g[k] - w[k])])
        gs, ws = got["state"], want["state"]
        check_equal(SH.to_local(gs.clock_cells).cpu().numpy(),
                    ws.clock_cells.cpu().numpy(), "[mesh] clock cells")
        for k in ws.params:
            same_tensor(gs.params[k], ws.params[k], f"param {k}", held)
            for mom in ("m", "v"):
                g, w = gs.opt[mom][k], ws.opt[mom][k]
                if isinstance(w, Moment):
                    g, w = g.codes, w.codes
                same_tensor(g, w, f"{mom} {k}", held)
        train_ms = (float(np.median(got["ms"])), float(np.median(want["ms"])))
        losses = [m["loss"] for m in got["metrics"]]
        del state, dstate, want, got, gs, ws
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    prof = dt["profile"]
    print(f"[mesh] {MODEL_ARCH} full config on a one-rank NCCL mesh (1, 1) "
          f"(\"data\", \"model\"), DTensor parameters from param_pspecs: "
          f"greedy tokens of prefill + {MODEL_GEN} decode steps identical to "
          f"the plain path; {MESH_TRAIN_STEPS} train steps at launch.train's "
          f"defaults (batch {args.batch}, seq {args.seq}): losses "
          f"{losses}")
    print(f"[mesh] bit-identical to the plain path: logits, losses, grad "
          f"norms, clock cells, params and moments, except "
          f"{json.dumps(held) if held else 'nothing'}")
    print(f"[mesh] decode step (host clock to a synchronise, median of steps "
          f"2-{MODEL_GEN}): DTensor {serve_ms[0]} ms, plain {serve_ms[1]} ms; "
          f"train step (median of {MESH_TRAIN_STEPS}): DTensor {train_ms[0]} "
          f"ms, plain {train_ms[1]} ms; one DTensor decode step under the "
          f"profiler: wall {prof['wall_ms']} ms, kernels {prof['kernel_ms']} "
          f"ms ({prof['device_events']} device events), idle share "
          f"{prof['idle_share']}; launches {json.dumps(launches)}; the phase "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    args = sys.argv[1:]
    phases = {"model": model_phase, "train": train_phase, "moe": moe_phase,
              "ssm": ssm_phase, "encdec": encdec_phase, "mesh": mesh_phase}
    if args not in ([], ["--shard-only"],
                    *([f"--{name}-only"] for name in phases)):
        print("usage: chip_smoke.py [--shard-only | --model-only | "
              "--train-only | --moe-only | --ssm-only | --encdec-only | "
              "--mesh-only]",
              file=sys.stderr)
        return 2
    shard_only = args == ["--shard-only"]
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card only",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import ops
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"[card] {card} | torch: {name} x{count} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    print(f"[build] all kernels built in {build():.1f} s")
    if shard_only:
        shard_phase(sim_check())
        print(card)
        print(json.dumps({"ok": True, "phase": "shard",
                          "device": {"platform": "gpu", "kind": name,
                                     "count": count}}))
        return 0
    if args:
        phase = args[0][2:-5]
        t_phase = time.perf_counter()
        phases[phase](dev, hbm_rate(name))
        print(f"[time] {phase} phase {time.perf_counter() - t_phase:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "phase": phase,
                          "device": {"platform": "gpu", "kind": name,
                                     "count": count}}))
        return 0
    global CHILDREN_BATCHED
    CHILDREN_BATCHED = True
    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:
        """``[time] <what> phase`` seconds since the last lap."""
        now = time.perf_counter()
        print(f"[time] {what} phase {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    sass = sass_counts()
    for kname, c in sass.items():
        unit = "cell" if kname in _SASS_ROWS else "(pair, lane)"
        print(f"[sass] {kname}: hot loop, instructions per {unit}: "
              f"{json.dumps(c)}")

    errs = check_kernels(dev)
    errs.update(check_pair_kernels(dev))
    errs.update(check_hybrid_kernel(dev))
    lap("sass and kernel check")

    ops.reset_launches()
    gpu = drive("cuda")
    launches = {k: ops.LAUNCHES[k] for k in MAIN_KERNELS}
    print(f"[main] launches on the main path: {json.dumps(launches)}")
    for kname, n in launches.items():
        check(n > 0, f"kernel {kname} was not launched on the main path")
    print(f"[main] cuda: counts={gpu['counts']} promoted={gpu['n_wide']} "
          f"times={json.dumps(gpu['times'])}")
    with card_blocks():
        cpu = drive("cpu")
    print(f"[main] cpu: counts={cpu['counts']} "
          f"times={json.dumps(cpu['times'])}")
    compare_runs(gpu, cpu)
    print("[main] card and CPU runs agree: statuses, clocks, slab rows, "
          "wire bytes identical; fp within tolerance")
    lap("main")
    sim = sim_check()
    print(f"[sim] fn=0 on both devices, same counts: {json.dumps(sim)}")
    print(f"[trace] one more gossip round on the card, under the profiler: "
          f"{json.dumps(profile_round(gpu['rt'], gpu['reg']))}")
    del gpu["rt"], gpu["reg"], cpu
    lap("sim and trace")

    shard_phase(sim)
    lap("shard")
    socket_phase()
    lap("socket")

    health = drive_health(dev)
    print(f"[pairs] fleet_health at {N_SLOTS} slots on the card: "
          f"{json.dumps(health)}")
    engines = engines_check(dev)
    print(f"[pairs] tri, full, mxu and i32 engines at {N_SLOTS} slots: "
          f"identical flags and row sums: {json.dumps(engines)}")
    small = health_cpu_check()
    print(f"[pairs] fleet_health at {N_SLOTS_CPU} slots: card and CPU agree "
          f"(flags, sums, components, stragglers; fp within tolerance): "
          f"{json.dumps(small)}")
    launches.update({k: health["launches"][k] for k in HEALTH_KERNELS})
    launches.update({k: engines["launches"][k] for k in ENGINE_KERNELS
                     if k not in HEALTH_KERNELS})

    lap("pairs")
    hyb = drive_hybrid("cuda")
    hyb_launches = {k: hyb["launches"][k] for k in HYBRID_KERNELS}
    for kname, n in hyb_launches.items():
        check(n > 0, f"kernel {kname} was not launched on the hybrid path")
    print(f"[hybrid] cuda: {hyb['hot_rows']} hot + {hyb['tail_rows']} tail "
          f"rows, m {hyb['m0']} -> {hyb['m']} ({hyb['resizes']} resize, "
          f"{hyb['replay']}), launches {json.dumps(hyb_launches)} over "
          f"{hyb['n_classify']} classifies, checks {json.dumps(hyb['acc'])}, "
          f"times {json.dumps(hyb['times'])}")
    print(f"[hybrid] tail rows bit-identical to a flat packed slab; one more "
          f"classify under the profiler: "
          f"{json.dumps(profiled(hyb['eng'].classify))}")
    del hyb["eng"]
    with card_blocks():
        hyb_cpu = drive_hybrid("cpu")
    del hyb_cpu["eng"]
    print(f"[hybrid] cpu: checks {json.dumps(hyb_cpu['acc'])}, times "
          f"{json.dumps(hyb_cpu['times'])}")
    compare_hybrid(hyb, hyb_cpu)
    print("[hybrid] card and CPU runs agree: sid order, hot and tail flags, "
          "sums, post-resize m and tail rows identical; fp within tolerance")
    del hyb_cpu
    n_big, head_big = HYB_PAIRS[0]
    big = hybrid_pairs("cuda", n_big, head_big)
    for kname in HEALTH_KERNELS:
        check(big["launches"][kname] > 0,
              f"kernel {kname} was not launched by HybridEngine.pairs")
    print(f"[hybrid] pairs at {n_big} sessions ({head_big} hot) on the card: "
          f"{big['ms']} ms, engine {big['engine']}, launches "
          f"{json.dumps({k: big['launches'][k] for k in HEALTH_KERNELS})}; "
          f"hot-hot block exact, fp 0")
    del big
    n_small, head_small = HYB_PAIRS[1]
    gp = hybrid_pairs("cuda", n_small, head_small)
    with card_blocks():
        cp = hybrid_pairs("cpu", n_small, head_small)
    check(gp["order"] == cp["order"] and gp["engine"] == cp["engine"],
          "hybrid pairs order or engine differs between devices")
    gres, cres = gp["res"].to_host(), cp["res"].to_host()
    for key in ("a_le_b", "b_le_a", "concurrent", "row_sums"):
        check_equal(gres[key], cres[key], f"hybrid pairs {key} at {n_small}")
    check_fp(gres.fp, cres.fp, f"hybrid pairs fp at {n_small}")
    print(f"[hybrid] pairs at {n_small} sessions: card ({gp['ms']} ms) and "
          f"CPU ({cp['ms']} ms) agree: flags and sums identical, fp within "
          f"tolerance")
    del gp, cp, gres, cres
    launches["hybrid"] = hyb_launches["hybrid"]

    lap("hybrid")
    tuned = drive_autotune(dev)
    dispatch = dispatch_lines(gpu, hyb["hot_rows"], hyb["tail_rows"])

    lap("autotune")
    serve_errs = check_serve_kernels(dev)
    for kname, e in serve_errs.items():
        errs[kname] = max(errs[kname], e)
    srv = drive_serve()
    r = srv["report"]
    print(f"[serve] churn on the card ({r['sessions']} sessions, m={SERVE_M}): "
          f"wall {r['wall_s']} s (process {srv['process_s']} s), p50 "
          f"{r['p50_ms']} ms, p95 {r['p95_ms']} ms, p99 {r['p99_ms']} ms, qps "
          f"{r['qps']}, tiers {json.dumps(r['tier_counts'])}, cache hits "
          f"{r['cache_hits']} misses {r['cache_misses']}, promotions "
          f"{r['promotions']}, demotions {r['demotions']}, spills {r['spills']}, "
          f"fn {r['fn_violations']}, admitted {r['admitted']}, rejected "
          f"{r['rejected']}, measured fp {r['measured_fp']}")
    serve_launches = srv["launches"]
    print(f"[serve] launches on the serving path: {json.dumps(serve_launches)}")
    print(f"[serve] spans of the churn: {json.dumps(srv['spans'])}")
    fl = srv["flat"]
    print(f"[serve] TieredRegistry.classify over {fl['sessions']} sessions "
          f"{json.dumps(fl['tiers'])} bit-identical to a flat card slab "
          f"(statuses, sums, fp bits): {json.dumps(fl['counts'])}; tiered "
          f"{fl['tiered_classify_ms']} ms, flat {fl['flat_classify_ms']} ms, "
          f"flat slab built in {fl['flat_build_s']} s; spans "
          f"{json.dumps(fl['spans'])}")
    print(f"[serve] quick churn: card and CPU agree on "
          f"{json.dumps(serve_quick())}")
    from repro_torch.serve import ChurnConfig, run_churn
    step = ChurnConfig().sessions // ChurnConfig().steps
    print(f"[serve] one churn step ({step} arrivals, one step's queries and "
          f"migrations) under the profiler: "
          f"{json.dumps(profiled(lambda: run_churn(ChurnConfig(sessions=step, steps=1), device='cuda')))}")
    del srv

    lap("serve")
    rate = hbm_rate(name)
    model_launches = model_phase(dev, rate)
    torch.cuda.empty_cache()
    lap("model")
    with tempfile.TemporaryDirectory() as d:
        run_launchers([serve_launcher("model"), train_launcher(d),
                       *(serve_launcher("moe", a) for a in MOE_ARCHS),
                       *(serve_launcher("ssm", a) for a in SSM_ARCHS),
                       chaos_launcher()])
    lap("launchers")
    train_launches = train_phase(dev, rate)
    lap("train")
    moe_launches = moe_phase(dev, rate)
    lap("moe")
    ssm_launches = ssm_phase(dev, rate)
    lap("ssm")
    encdec_launches = encdec_phase(dev, rate)
    lap("encdec")
    mesh_launches = mesh_phase(dev, rate)
    lap("mesh")

    timed = time_kernels(dev, gpu["n_wide"])
    timed["hybrid"] = time_hybrid(dev, hyb["hot_rows"], hyb["tail_rows"])
    timed.update(time_pair_kernels(dev, sass))
    records = []
    for kname, t in timed.items():
        t_bytes = t["bytes"] / rate * 1e3
        t_ops = t["ops"] / INT_OPS * 1e3
        ops_by = "issue"
        if t.get("tensor_ops") and t["tensor_ops"] / INT8_OPS * 1e3 < t_ops:
            t_ops, ops_by = t["tensor_ops"] / INT8_OPS * 1e3, "int8 tensor cores"
        src, replaces = _SOURCES[kname]
        records.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t["library_ms"]})
        if kname in model_launches:
            records[-1]["model_serving_launches"] = model_launches[kname]
        if kname in train_launches:
            records[-1]["training_launches"] = train_launches[kname]
        if kname in moe_launches:
            records[-1]["moe_launches"] = moe_launches[kname]
        if kname in ssm_launches:
            records[-1]["ssm_launches"] = ssm_launches[kname]
        if encdec_launches.get(kname):
            records[-1]["encdec_launches"] = encdec_launches[kname]
        if mesh_launches.get(kname):
            records[-1]["mesh_launches"] = mesh_launches[kname]
        print(f"[time] {kname}: kernel {t['ms']} ms (wrapper call "
              f"{t['call_ms']} ms), plain {t['plain_ms']} ms (call "
              f"{t['plain_call_ms']} ms), library {t['library_ms']} ms"
              + (f" {json.dumps(t['libraries'])}" if t.get("libraries") else "")
              + ", "
              f"{t['bytes']} bytes, {t['ops']} ops"
              + (f" ({t['ops_per_pair']} per pair and lane)"
                 if "ops_per_pair" in t else "")
              + f", bound {max(t_bytes, t_ops)} ms (bytes {t_bytes} at "
              f"{rate / 1e12} TB/s, ops {t_ops} at the {ops_by} rate)"
              + (f", tensor-core ops {t['tensor_ops']}" if t.get("tensor_ops") else "")
              + (f", rows={t['rows']}" if "rows" in t else ""))
    tk = timed["bloom_tick"]
    for r in (tk, tk["main_shape"]):
        t_bytes = r["bytes"] / rate * 1e3
        print(f"[time] bloom_tick B={r['B']} P={r['P']} m={M} int32: kernel "
              f"{r['ms']} ms (call {r['call_ms']} ms), plain {r['plain_ms']} ms, "
              f"scatter_add_ in place {r['scatter_add_ms']} ms, torch.scatter_add "
              f"to new cells {r['scatter_add_out_ms']} ms, bound {t_bytes} ms "
              f"(bytes): the kernel at {t_bytes / r['ms']} of it")
    mc = timed["bloom_merge_compare"]["main_shape"]
    t_bytes = mc["bytes"] / rate * 1e3
    print(f"[time] bloom_merge_compare B={mc['B']} m={M} int32: kernel {mc['ms']} ms "
          f"(call {mc['call_ms']} ms), plain {mc['plain_ms']} ms (call "
          f"{mc['plain_call_ms']} ms), {mc['bytes']} bytes, bound {t_bytes} ms "
          f"(bytes): the kernel at {t_bytes / mc['ms']} of it")
    tr = timed["matrix_tri"]
    t_tri = max(tr["bytes"] / rate, tr["ops"] / INT_OPS) * 1e3
    print(f"[time] matrix_tri bt=32 at N={N_SLOTS} m={M}: kernel {tr['bt32']['ms']} ms "
          f"(call {tr['bt32']['call_ms']} ms), bt=64 {tr['ms']} ms, bound {t_tri} ms")
    w = timed["matrix_mxu"]["wide_t"]
    t_bytes, t_ops = w["bytes"] / rate * 1e3, w["ops"] / INT_OPS * 1e3
    print(f"[time] matrix_mxu above MXU_T_MAX (32-bit lanes) at N=M={w['N']} "
          f"m={w['m']} T={w['T']}: kernel {w['ms']} ms (call {w['call_ms']} ms), "
          f"plain {w['plain_ms']} ms, {w['bytes']} bytes, {w['ops']} ops "
          f"({w['ops_per_pair']} per pair and lane), bound {max(t_bytes, t_ops)} ms (bytes {t_bytes}, "
          f"ops {t_ops} at the instruction rate)")
    l2 = timed["matrix_rect_i32"]["l2_resident"]
    print(f"[time] matrix_rect_i32 on slabs inside L2 (N={l2['N']}, M={l2['M']}, "
          f"{l2['slab_bytes']} bytes): {l2['ms']} ms, {l2['ps_per_pair_lane']} ps "
          f"of the card per pair and lane against {l2['full_ps_per_pair_lane']} "
          f"at {N_SLOTS} x {N_SLOTS}")
    th = timed["hybrid"]
    print(f"[time] hybrid at H={th['hot']} T={th['tail']} m={M}: kernel "
          f"{th['ms']} ms, one_vs_many_packed on the same tail "
          f"{th['packed_ms']} ms (call {th['packed_call_ms']} ms), "
          f"{launches['hybrid'] / hyb['n_classify']} launches per classify; "
          f"fused classify end to end at m={hyb['m0']} "
          f"{hyb['times']['classify_m1024_ms']} ms, at m={hyb['m']} "
          f"{hyb['times']['classify_m512_ms']} ms")
    ov = timed["one_vs_many_packed"]
    print(f"[time] tuned vs default blocks: one_vs_many_packed N={N_PEERS} "
          f"m={M} at (bn, bm) {ov['blocks']} {ov['ms']} ms, at {ops.OVM_BLOCKS} "
          f"{ov['default_ms']} ms; hybrid H={th['hot']} T={th['tail']} at "
          f"{th['blocks']} {th['ms']} ms, at {ops.OVM_BLOCKS} {th['default_ms']} "
          f"ms; matrix_tri at N={N_SLOTS}: the table's tiles "
          f"{json.dumps(dispatch[f'all-pairs N={N_SLOTS} m={M} (symmetric)'])}, "
          f"bt=64 {tr['ms']} ms, bt=32 {tr['bt32']['ms']} ms; sweep (one call "
          f"each, us): " + json.dumps({k: [v["us"], v["default_us"]]
                                        for k, v in tuned.items()}))
    print(f"[time] classify_all {gpu['times']['classify_all_ms']} ms, "
          f"gossip rounds {gpu['times']['gossip_round_ms']} ms (end to end, "
          f"65,536 peers); fleet_health {health['wall_ms']} ms ({N_SLOTS} "
          f"slots: all_pairs {health['all_pairs_ms']} ms, transfer "
          f"{health['to_host_ms']} ms, host "
          f"{health['spans_ms'].get('fleet.health.host')} ms)")
    st = time_serve(dev)
    for key, r in st.items():
        t_bytes = r["bytes"] / rate * 1e3
        t_ops = r["ops"] / INT_OPS * 1e3
        what = (f"bloom_tick B={r['B']} P={r['P']} probes" if key == "tick"
                else f"one_vs_many_packed N={r['N']} (bn, bm) {r['blocks']}")
        print(f"[time] serve {what} m={SERVE_M}: kernel {r['ms']} ms (call "
              f"{r['call_ms']} ms), plain {r['plain_ms']} ms, library "
              f"{r['library_ms']} ms"
              + (f" (scatter_add_ in place {r['scatter_add_ms']}, torch.scatter_add "
                 f"{r['scatter_add_out_ms']})" if key == "tick" else "")
              + f", {r['bytes']} bytes, bound {max(t_bytes, t_ops)} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}), launches in "
              f"the churn {serve_launches['bloom_tick' if key == 'tick' else 'one_vs_many_packed']}")
    lap("timing")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
