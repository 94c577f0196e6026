#!/usr/bin/env python3
"""The dry run of two cells at their full configs, each with and without
the model mesh's explicit collectives, on the 16 x 16 production mesh
over a fake 512-rank group (meta tensors, no device):

- qwen1_5_0_5b x decode_32k, ``decode_attn`` "xla" and "split_kv"
  (owner-writes cache update, split-KV decode);
- deepseek_v2_236b x train_4k, ``moe_impl`` "gather" and "alltoall".

One JSON line a run: the cell, the override, the per-device argument
bytes, the local TFLOPs, each collective's bytes and count, and the
gathers ``sharding.to_local`` made by site (``replicated_fallback``).

    python3 scripts/dryrun_collectives.py [--out reports/collectives.jsonl]

Run from the root of a checkout, on the CPU (it sets up the fake group
itself; a few minutes).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

RUNS = [("qwen1_5_0_5b", "decode_32k", {}),
        ("qwen1_5_0_5b", "decode_32k", {"decode_attn": "split_kv"}),
        ("deepseek_v2_236b", "train_4k", {}),
        ("deepseek_v2_236b", "train_4k", {"moe_impl": "alltoall"})]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="reports/collectives.jsonl")
    args = ap.parse_args()
    dryrun.init_fake_group(512)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for arch, shape, over in RUNS:
            cfg = dataclasses.replace(get_config(arch), **over)
            rec = dryrun.run_cell(arch, shape, cfg_override=cfg, quiet=True)
            line = {"arch": arch, "shape": shape, "override": over,
                    "status": rec["status"], "trace_s": rec["trace_s"],
                    "argument_bytes": rec["bytes_per_device"]["argument"],
                    "tflop": rec["cost"]["flops"] / 1e12,
                    "collectives": rec["collectives"],
                    "gathers": rec["replicated_fallback"]["gathers"]}
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
