"""Quickstart on the PyTorch port: the bloom clock as a library, in five
minutes (``examples/quickstart.py`` over ``repro_torch``).

Run:  python examples/torch_quickstart.py [--device cpu]

Without ``--device`` the clocks live on the CUDA card and every kernel
call (tick, the fused merge+compare, one-vs-many, all-pairs) launches
its hand-written kernel; ``--device cpu`` runs their plain versions.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch import causal  # noqa: E402
from repro_torch.core import clock as bc  # noqa: E402
from repro_torch.core.hashing import stable_event_id  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def ev(*parts):
    return stable_event_id(*parts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    dev = resolve_device(ap.parse_args().device)

    # two nodes, each with a 64-cell clock, 4 hash probes per event
    a = bc.zeros(m=64, k=4, device=dev)
    b = bc.zeros(m=64, k=4, device=dev)

    # node A records three local events
    for i in range(3):
        a = bc.tick(a, *ev("A", i))

    # A broadcasts; B receives -> element-wise max (paper §3 step 3)
    b = bc.merge(b, a)
    # B records its own event
    b = bc.tick(b, *ev("B", 0))

    # the public causality API: typed results + the uniform Eq. 3 gate
    o = causal.compare(a, b)
    print(f"A -> B?   {bool(o.before())}  (fp rate {float(o.fp_ab):.4f})")
    print(f"B -> A?   {bool(o.after())}")
    print(f"confident at 1e-3? {bool(o.confident(1e-3))}")
    print(f"concurrent? {bool(o.concurrent())}  (exact — no false negatives)")

    # now a third node C that never talked to anyone
    c = bc.tick(bc.zeros(64, 4, device=dev), *ev("C", 0))
    print(f"A vs C concurrent? {bool(causal.compare(a, c).concurrent())}")

    # paper §4 compression: (base)[residuals]
    for i in range(200):
        b = bc.tick(b, *ev("B", i + 1))
    z = bc.compress(b)
    print(f"compressed: base={int(z.base)}, max residual={int(z.cells.max())} "
          f"(vs raw max {int(b.logical_cells().max())})")

    # the kernel path: batched receive, one fused launch on the card
    batch_a = a.cells[None].repeat(8, 1)
    batch_b = b.logical_cells()[None].repeat(8, 1)
    out = ops.merge_compare(batch_a, batch_b)
    print(f"kernel fused merge+compare over batch of 8: "
          f"a_le_b={out['a_le_b'].tolist()}")

    # bulk comparisons go through the CausalEngine front-door: one
    # dispatch surface over every kernel (packed u8 / mxu / i32)
    engine = causal.CausalEngine(causal.CausalPolicy(fp_threshold=1e-3))
    clocks = torch.stack([a.logical_cells(), b.logical_cells(),
                          c.logical_cells()])
    mats = engine.pairs(clocks)                  # all-pairs, one call
    print(f"pairs (engine={mats.engine}): concurrent=\n"
          f"{mats.concurrent().int().cpu().numpy()}")
    res = engine.classify(a, clocks)             # one-vs-many, one call
    print(f"classify A vs [A,B,C]: before={res.before().tolist()} "
          f"confident={res.confident(1e-3).tolist()}")

    # the paper's worked fp example: m=6, ΣB=10, ΣA=7 -> 0.29
    print(f"Eq.3 paper example: {float(bc.fp_rate(7, 10, 6)):.2f} (paper: 0.29)")


if __name__ == "__main__":
    main()
