#!/usr/bin/env python3
"""Times the bare plain-path decode step of two checkouts in turn on one
card: Qwen1.5-0.5B's full config (``--arch``; ``--layers`` cuts its
depth), random weights from a seed, batch 4, a 32-token prompt, then
greedy decode steps, each on the host clock to a synchronise.  One JSON
line a run, the card's name and power limit first.

    python3 scripts/decode_step_ab.py A B [--rounds 2] [--steps 64]
        [--arch deepseek_v2_236b --layers 4]
        runs A, B, B, A (``--rounds`` times), each in a process of its
        own that imports ``repro_torch`` from that checkout's ``src``;
        a run's line holds its median, 10th and 90th percentile step ms
        over steps 2..``--steps``, and the aten ops and the Python and
        C function calls of a step (each counted on one more step,
        untimed, under ``sys.setprofile`` and a dispatch mode)
    ... --device cpu --smoke
        the same on the CPU at the smoke config (a rehearsal)

Only the checkouts' public model entry points are called
(``models.params.init_params``, ``models.transformer.build``,
``prefill``, ``decode_step``), so any checkout since model serving was
ported can be timed.  Run from the root of a checkout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ARCH = "qwen1_5_0_5b"
BATCH, PROMPT, SEED = 4, 32, 0


def child(args) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(args.child), "src"))
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    dev = torch.device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            Count.n += 1
            return func(*a, **(kw or {}))

    params = init_params(torch.Generator(dev).manual_seed(SEED), cfg, dev)
    with torch.no_grad():
        model = T.build(params, cfg)
        prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                                generator=torch.Generator().manual_seed(1),
                                dtype=torch.int32).to(dev)
        logits, caches = T.prefill(model, cfg, prompts,
                                   buf_len=PROMPT + args.steps + 10)
        ms = []
        for i in range(args.steps):
            tok = logits.argmax(-1).to(torch.int32)
            sync()
            t0 = time.perf_counter()
            logits, caches = T.decode_step(model, cfg, caches, tok,
                                           PROMPT + i)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        calls = [0]

        def count_calls(frame, event, arg):
            calls[0] += event in ("call", "c_call")

        tok = logits.argmax(-1).to(torch.int32)
        sys.setprofile(count_calls)
        logits, caches = T.decode_step(model, cfg, caches, tok,
                                       PROMPT + args.steps)
        sys.setprofile(None)
        tok = logits.argmax(-1).to(torch.int32)
        with Count():
            T.decode_step(model, cfg, caches, tok, PROMPT + args.steps + 1)
        sync()
    tail = np.asarray(ms[1:])
    print(json.dumps({
        "tree": os.path.abspath(args.child), "config": cfg.name,
        "device": str(dev), "steps": len(tail),
        "median_ms": float(np.median(tail)),
        "p10_ms": float(np.percentile(tail, 10)),
        "p90_ms": float(np.percentile(tail, 90)),
        "aten_ops_a_step": Count.n, "python_calls_a_step": calls[0],
        "ms": ms}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this depth (0: its own)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            sys.exit("no CUDA device (pass --device cpu to rehearse)")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.splitlines()[0]
        print(json.dumps({"card": card}), flush=True)
    a, b = args.trees
    extra = ["--steps", str(args.steps), "--device", args.device,
             "--arch", args.arch, "--layers", str(args.layers)] + (
        ["--smoke"] if args.smoke else [])
    for _ in range(args.rounds):
        for tree in (a, b, b, a):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", tree] + extra, check=True)


if __name__ == "__main__":
    main()
