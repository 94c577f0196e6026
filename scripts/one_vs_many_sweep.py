#!/usr/bin/env python3
"""Times the packed one-vs-many and hybrid wrappers of a checkout on a
CUDA card; one JSON line per measurement, the card's name and power
limit first.  Times are ``chip_smoke.measure``'s (CUDA events around a
loop queued behind a sleep kernel, input buffers rotated past the L2).

    python3 scripts/one_vs_many_sweep.py tree DIR
        the wrappers of the checkout at DIR (its ``src/repro_torch``):
        packed one-vs-many (N = 65,536, m = 1024) and the hybrid sweep
        (H = 4,089, T = 65,539) at bn = 4, 8, 16, 32 and bm = 512 (the
        blocks are given, so no checkout's autotune table picks them);
        then the packed
        kernel's row loop in the built code (``chip_smoke.sass_row_loop``
        over ``cuobjdump -sass``)
    python3 scripts/one_vs_many_sweep.py slope
        this checkout's packed one-vs-many (bn = 8, bm = 512) at
        N = 8,192 .. 262,144 beside
        one-pass PyTorch reads of the same slab (amax, clone)

Only the public wrappers are called, so any checkout since the hybrid
engine's can be timed; its packed kernel is one of ``PACKED_LOOPS``.
Run from the root of a checkout with a card; to compare two checkouts,
run ``tree`` on each in turn on the same card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 1024


#: the packed one-vs-many kernel of each design, as its row loop is
#: read: symbol, ops the loop must hold, cells a lane takes an iteration
PACKED_LOOPS = (
    ("one_vs_many_kernelIhLb1E", (("LDG", "128"),), 16),  # a 16-byte load a lane
    ("ovm_kernelIhLb1E", (("LDGSTS", ""), ("VIMNMX3", "")), 32),  # 2 cp.async chunks a lane
)


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def setup(tree: str):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # puts this checkout's src first: the tree goes before it
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    from repro_torch.kernels import _build, ops
    emit(card=cs.card_line(), tree=os.path.abspath(tree))
    return cs, ops, _build


def packed_slabs(torch, cs, N, dev, g):
    nb = cs.n_buffers(N * M)
    return nb, [(torch.as_tensor(g.integers(0, 256, (N, M)), dtype=torch.uint8, device=dev),
                 torch.full((N,), 5000, dtype=torch.int32, device=dev)) for _ in range(nb)]


def sweep_tree(tree: str) -> None:
    import torch
    cs, ops, _build = setup(tree)
    dev = torch.device("cuda")
    g = np.random.default_rng(1)
    N, H, T = 65536, 4089, 65539
    q = torch.as_tensor(g.integers(0, 200, M) + 5000, dtype=torch.int32, device=dev)
    nb, slabs = packed_slabs(torch, cs, N, dev, g)
    for bn in (4, 8, 16, 32):
        emit(kernel="one_vs_many_packed", N=N, m=M, bn=bn, ms=cs.measure(
            lambda i: ops._classify_vs_many_packed(q, *slabs[i], bn=bn, bm=512),
            nb)["ms"])
    del slabs
    hyb = [cs.hybrid_inputs(g, H, T, M, dev) for _ in range(nb)]
    for bn in (4, 8, 16, 32):
        emit(kernel="hybrid", H=H, T=T, m=M, bn=bn,
             ms=cs.measure(lambda i: ops.hybrid(*hyb[i], bn=bn), nb)["ms"])
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(_build._lib_path("one_vs_many"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    sym, need, cells = next(k for k in PACKED_LOOPS if k[0] in text)
    emit(sass="one_vs_many_packed", symbol=sym, **cs.sass_row_loop(text, sym, need, cells))


def sweep_slope() -> None:
    import torch
    cs, ops, _ = setup(ROOT)
    dev = torch.device("cuda")
    g = np.random.default_rng(1)
    q = torch.as_tensor(g.integers(0, 200, M) + 5000, dtype=torch.int32, device=dev)
    for N in (8192, 16384, 32768, 65536, 131072, 262144):
        nb, slabs = packed_slabs(torch, cs, N, dev, g)
        emit(kernel="one_vs_many_packed", N=N, m=M,
             ms=cs.measure(lambda i: ops._classify_vs_many_packed(
                 q, *slabs[i], bn=8, bm=512), nb)["ms"],
             amax_ms=cs.measure(lambda i: torch.amax(slabs[i][0]), nb)["ms"],
             clone_ms=cs.measure(lambda i: slabs[i][0].clone(), nb)["ms"])
        del slabs


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode == "tree" and len(sys.argv) == 3:
        sweep_tree(sys.argv[2])
    elif mode == "slope" and len(sys.argv) == 2:
        sweep_slope()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
