#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failure:

1. the card: ``nvidia-smi`` name and power limit, torch's device name
   and count;
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel);
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged and near-wrap ones: integers
   identical, Eq. 3 fp within a relative 5e-2;
4. the main path at full size: a ``ClockRuntime`` (m=1024, k=4) ticks,
   65,536 peers are admitted to a registry in batches of 4096,
   ``classify_fleet``, ``lineage``/``admit_merge`` and three loopback
   ``gossip`` rounds — once on the card with the launch counts reset
   just before and read just after, once on the CPU (plain versions);
   verdicts, clocks, registry rows and wire bytes must be identical,
   fp within tolerance; then ``run_gossip_sim`` on both devices must
   report fn == 0 and the same verdict counts;
5. kernel times with CUDA events over many launches, with rotating
   input buffers larger than the L2 cache, beside the plain version,
   ``scatter_add_`` for the tick, and the least time the card needs;
6. one JSON line of kernel records, the card line, then the verdict line.

No JAX and nothing of the JAX package is imported.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

FP_RTOL = 5e-2      # Eq. 3 across math libraries (see ROADMAP queue 3)
FP_FLOOR = 1e-30    # the Eq. 3 clip: values at or below it are all "zero"
M, K = 1024, 4
N_PEERS, BATCH = 65536, 4096
SEED = 0
L2_BYTES = 50e6

# data-sheet HBM rates (bytes/s), by the card's name
_HBM = (("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H200", 4.8e12),
        ("H100", 3.35e12))
# int32 operations/s outside the tensor cores: 64 INT32 lanes per SM,
# 132 SMs, 1.98 GHz boost (Hopper architecture white paper)
INT32_OPS = 64 * 132 * 1.98e9


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def fp_max_rel(x, y) -> float:
    """Largest relative gap between two fp arrays: 0 where they are
    equal (wrapped negative sums give inf on both sides), where both are
    NaN, or where both are at or below the Eq. 3 clip floor."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    same = (x == y) | (np.isnan(x) & np.isnan(y))
    both_tiny = (np.abs(x) <= FP_FLOOR) & (np.abs(y) <= FP_FLOOR)
    with np.errstate(invalid="ignore"):
        den = np.maximum(np.maximum(np.abs(x), np.abs(y)), 1e-300)
        rel = np.where(same | both_tiny, 0.0, np.abs(x - y) / den)
    rel = np.where(np.isnan(rel), np.inf, rel)
    return float(rel.max(initial=0.0))


def check_fp(x, y, what: str) -> float:
    rel = fp_max_rel(x, y)
    check(rel <= FP_RTOL, f"{what}: fp relative gap {rel:.3g} > {FP_RTOL}")
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    finite = np.isfinite(x) & np.isfinite(y)
    return float(np.abs(x[finite] - y[finite]).max(initial=0.0))


def check_equal(x, y, what: str) -> None:
    x, y = np.asarray(x), np.asarray(y)
    check(x.shape == y.shape and np.array_equal(x, y),
          f"{what}: not identical")


def host(t):
    return t.cpu().numpy()


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


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

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
    print("[kernels] tick: identical to the plain version")

    # merge_compare: main shape, ragged m, rows near INT32_MAX
    cases = []
    for B, m in ((4096, 1024), (4096, 1000)):
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
        got = ops.merge_compare(a, b)
        merged, flags, sums, fp = ref.bloom_merge_compare_ref(
            a, b, bm=ops.tile_width(m, 512))
        check_equal(host(got["merged"]), host(merged), f"merged m={m}")
        check_equal(host(got["a_le_b"]), host(flags[:, 0].bool()), "a_le_b")
        check_equal(host(got["b_le_a"]), host(flags[:, 1].bool()), "b_le_a")
        check_equal(host(got["sum_a"]), host(sums[:, 0]), "sum_a")
        check_equal(host(got["sum_b"]), host(sums[:, 1]), "sum_b")
        err["bloom_merge_compare"] = max(
            err["bloom_merge_compare"],
            check_fp(host(got["fp_a_before_b"]), host(fp[:, 0]), "fp a->b"),
            check_fp(host(got["fp_b_before_a"]), host(fp[:, 1]), "fp b->a"))
    print("[kernels] merge_compare: identical, fp within tolerance")

    def compare_ovm(name, out, q, peers, base):
        m = q.shape[0]
        flags, sums, fp = ref.one_vs_many_ref(q, peers, base,
                                              bm=ops.tile_width(m, 512))
        check_equal(host(out["q_le_p"]), host(flags[:, 0].bool()), name)
        check_equal(host(out["p_le_q"]), host(flags[:, 1].bool()), name)
        check_equal(host(out["sum_p"]), host(sums[:, 1]), name + " sum_p")
        check_equal(host(out["sum_q"]), host(sums[0, 0]), name + " sum_q")
        return max(check_fp(host(out["fp_q_before_p"]), host(fp[:, 0]), name),
                   check_fp(host(out["fp_p_before_q"]), host(fp[:, 1]), name))

    # packed: N=65,536 at m=1024 with random bases, then ragged shapes
    for N, m in ((N_PEERS, M), (1000, 1000), (300, 1008), (77, 520)):
        q_res = g.integers(0, 200, m)
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
        out = ops._classify_vs_many_packed(q, peers, base_t)
        err["one_vs_many_packed"] = max(
            err["one_vs_many_packed"],
            compare_ovm(f"packed N={N} m={m}", out, q, peers, base_t))
    print("[kernels] one_vs_many packed: identical, fp within tolerance")

    # i32: N=256 at m=1024 across the int32 wrap point, then ragged
    for N, m in ((256, M), (77, 1000)):
        q_np = 2 ** 31 - 1 - g.integers(0, 100, m)
        step = g.integers(0, 300, (N, 1)) * g.integers(-1, 2, (N, 1))
        noise = g.integers(-1, 2, (N, m)) * (g.random((N, m)) < 0.01)
        p_np = ((q_np + step + noise) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        q = torch.as_tensor(q_np.astype(np.int64), device=dev).to(torch.int32)
        peers = torch.as_tensor(p_np, device=dev)
        out = ops._classify_vs_many(q, peers)
        err["one_vs_many_i32"] = max(
            err["one_vs_many_i32"],
            compare_ovm(f"i32 N={N} m={m}", out, q, peers, None))
    print("[kernels] one_vs_many i32: identical, fp within tolerance")
    return err


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
    res = {d: run_gossip_sim(cfg, device=d) for d in ("cuda", "cpu")}
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
# phase 5: times
# ---------------------------------------------------------------------------

def call_ms(fn, n_buf: int, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call of ``fn(i)`` on the card's clock (CUDA events
    around ``iters`` calls, cycling ``n_buf`` input buffers, after a
    warm-up): the cost to a caller, host gaps between kernels included."""
    import torch
    for i in range(warmup):
        fn(i % n_buf)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_buf)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, n_buf: int, kernel: str | None = None,
              iters: int = 20) -> float | None:
    """Mean device ms per call of ``fn(i)`` from ``torch.profiler``: the
    summed time of the CUDA kernels whose name contains ``kernel`` (all
    of the call's kernels when None).  None when the profiler recorded
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i % n_buf)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (kernel is None or kernel in e.key))
    return us / iters / 1e3 if us > 0 else None


def measure(fn, n_buf: int, kernel: str | None = None,
            iters: int = 50) -> dict:
    """Device time (profiler; CUDA events when the profiler sees no
    device time) and call time (CUDA events) of one function."""
    call = call_ms(fn, n_buf, iters=iters)
    dev = device_ms(fn, n_buf, kernel, iters=min(iters, 20))
    return {"ms": dev if dev is not None else call, "call_ms": call,
            "method": "profiler" if dev is not None else "cuda-events"}


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

    def entry(kernel_fn, kernel_name, plain_fn, nb, nbytes, n_ops,
              library_fn=None, **extra):
        k = measure(kernel_fn, nb, kernel_name)
        p = measure(plain_fn, nb, iters=10)
        lib = measure(library_fn, nb) if library_fn is not None else None
        return dict(ms=k["ms"], call_ms=k["call_ms"], method=k["method"],
                    plain_ms=p["ms"], plain_call_ms=p["call_ms"],
                    library_ms=lib["ms"] if lib else None,
                    bytes=nbytes, ops=n_ops, **extra)

    # tick: B=4096 clocks, E=16 events, k=4 -> P=64 probes per clock
    B, P = 4096, 16 * K
    nbytes = B * M * 4 * 2 + B * P * 4
    nb = n_buffers(nbytes)
    cells = [torch.as_tensor(g.integers(0, 1000, (B, M)), dtype=torch.int32,
                             device=dev) for _ in range(nb)]
    ev = g.integers(0, 2 ** 32, (2, B, 16), dtype=np.uint64).astype(np.int64)
    probes = [bloom_indices(ev[0], ev[1], K, M, device=dev)
              .reshape(B, -1).to(torch.int32).contiguous() for _ in range(nb)]
    probes64 = [p.to(torch.int64) for p in probes]
    ones = torch.ones((B, P), dtype=torch.int32, device=dev)
    rec["bloom_tick"] = entry(
        lambda i: ops.tick_probes(cells[i], probes[i]), "bloom_tick_kernel",
        lambda i: ref.bloom_tick_ref(cells[i], probes[i]), nb, nbytes,
        B * M + B * P,
        library_fn=lambda i: cells[i].scatter_add_(1, probes64[i], ones))
    del cells, probes, probes64

    # merge_compare: B=4096 pairs of m=1024 int32 rows
    B = 4096
    nbytes = B * M * 4 * 3 + B * 2 * 4 * 3
    nb = n_buffers(nbytes)
    ab = [(torch.as_tensor(g.integers(0, 400, (B, M)), dtype=torch.int32, device=dev),
           torch.as_tensor(g.integers(0, 400, (B, M)), dtype=torch.int32, device=dev))
          for _ in range(nb)]
    rec["bloom_merge_compare"] = entry(
        lambda i: ops.merge_compare(*ab[i]), "bloom_compare_kernel",
        lambda i: ref.bloom_merge_compare_ref(*ab[i], bm=bm), nb, nbytes,
        B * M * 5)
    del ab

    # one-vs-many packed: the registry slab, N=65,536 rows of m=1024
    N = N_PEERS
    nbytes = N * M + N * 4 + M * 4 + N * 2 * 4 * 3
    nb = n_buffers(nbytes)
    q = torch.as_tensor(g.integers(0, 200, M) + 5000, dtype=torch.int32, device=dev)
    slabs = [(torch.as_tensor(g.integers(0, 256, (N, M)), dtype=torch.uint8, device=dev),
              torch.full((N,), 5000, dtype=torch.int32, device=dev))
             for _ in range(nb)]
    rec["one_vs_many_packed"] = entry(
        lambda i: ops._classify_vs_many_packed(q, *slabs[i]),
        "one_vs_many_kernel<unsigned char",
        lambda i: ref.one_vs_many_ref(q, *slabs[i], bm=bm), nb, nbytes,
        N * M * 5)
    del slabs

    # one-vs-many i32: the promoted-row overlay, at the main path's
    # count of promoted rows
    N = max(n_wide, 1)
    nbytes = N * M * 4 + M * 4 + N * 2 * 4 * 3
    rows = torch.as_tensor(g.integers(0, 400, (N, M)), dtype=torch.int32, device=dev)
    rec["one_vs_many_i32"] = entry(
        lambda i: ops._classify_vs_many(q, rows), "one_vs_many_kernel<int",
        lambda i: ref.one_vs_many_ref(q, rows, bm=bm), 1, nbytes, N * M * 4,
        rows=N)
    return rec


_SOURCES = {
    "bloom_tick": ("src/repro_torch/kernels/csrc/bloom_tick.cu",
                   "src/repro/kernels/bloom_tick.py:32"),
    "bloom_merge_compare": ("src/repro_torch/kernels/csrc/bloom_compare.cu",
                            "src/repro/kernels/bloom_compare.py:30"),
    "one_vs_many_packed": ("src/repro_torch/kernels/csrc/one_vs_many.cu",
                           "src/repro/kernels/template.py:578"),
    "one_vs_many_i32": ("src/repro_torch/kernels/csrc/one_vs_many.cu",
                        "src/repro/kernels/template.py:578"),
}


def main() -> int:
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

    errs = check_kernels(dev)

    ops.reset_launches()
    gpu = drive("cuda")
    launches = dict(ops.LAUNCHES)
    print(f"[main] launches on the main path: {json.dumps(launches)}")
    for kname, n in launches.items():
        check(n > 0, f"kernel {kname} was not launched on the main path")
    print(f"[main] cuda: counts={gpu['counts']} promoted={gpu['n_wide']} "
          f"times={json.dumps(gpu['times'])}")
    cpu = drive("cpu")
    print(f"[main] cpu: counts={cpu['counts']} "
          f"times={json.dumps(cpu['times'])}")
    compare_runs(gpu, cpu)
    print("[main] card and CPU runs agree: statuses, clocks, slab rows, "
          "wire bytes identical; fp within tolerance")
    sim = sim_check()
    print(f"[sim] fn=0 on both devices, same counts: {json.dumps(sim)}")
    print(f"[trace] one more gossip round on the card, under the profiler: "
          f"{json.dumps(profile_round(gpu['rt'], gpu['reg']))}")
    del gpu["rt"], gpu["reg"], cpu

    rate = hbm_rate(name)
    timed = time_kernels(dev, gpu["n_wide"])
    records = []
    for kname, t in timed.items():
        t_bytes = t["bytes"] / rate * 1e3
        t_ops = t["ops"] / INT32_OPS * 1e3
        src, replaces = _SOURCES[kname]
        records.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t["library_ms"]})
        print(f"[time] {kname}: kernel {t['ms']} ms ({t['method']}; "
              f"wrapper call {t['call_ms']} ms), plain {t['plain_ms']} ms "
              f"(call {t['plain_call_ms']} ms), library {t['library_ms']} ms, "
              f"{t['bytes']} bytes, bound {max(t_bytes, t_ops)} ms "
              f"(bytes {t_bytes}, ops {t_ops}) at {rate / 1e12} TB/s"
              + (f", rows={t['rows']}" if "rows" in t else ""))
    print(f"[time] classify_all {gpu['times']['classify_all_ms']} ms, "
          f"gossip rounds {gpu['times']['gossip_round_ms']} ms (end to end, "
          f"65,536 peers)")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
