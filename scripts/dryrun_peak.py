#!/usr/bin/env python3
"""What holds a dry-run cell's peak: the port's dry run of one (arch x
shape) cell on the 16 x 16 mesh of a fake 512-rank group
(``repro_torch.launch.dryrun.run_cell``), traced with a ``_LocalCounter``
that keeps, at each new high of the live bytes, the storages then live
and the op that made each.  Prints the cell's temp and peak, the op at
the high, and the live bytes at the high grouped by the op that made
them, largest first.

    PYTHONPATH=src python3 scripts/dryrun_peak.py deepseek_v2_236b \\
        prefill_32k [--layers 1] [--top 8]

Runs on the CPU (meta tensors, no storage); ``--layers`` cuts the
config's depth (the enc-dec encoder's too).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses

from repro_torch.configs import get_config
from repro_torch.launch import dryrun


class _PeakCounter(dryrun._LocalCounter):
    """``_LocalCounter`` that keeps the live storages at each new high,
    each with the op (name, index) that made it."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.made = {}
        self.ops = 0
        self.at_high, self.high_op = {}, None

    def _created(self, st) -> None:
        if st._cdata not in self._sizes:     # a freed storage's key reused
            self.made[st._cdata] = self._op
        super()._created(st)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = (func._overloadpacket.__name__, self.ops)
        self.ops += 1
        before = self.high
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.high > before:
            self.at_high = {k: (n, self.made.get(k))
                            for k, n in self._sizes.items()}
            self.high_op = self._op
        return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this depth (0: its own)")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    dryrun.init_fake_group(512)
    cfg = get_config(args.arch)
    if args.layers:
        cut = {"n_layers": args.layers}
        if cfg.is_encdec:
            cut["n_enc_layers"] = args.layers
        cfg = dataclasses.replace(cfg, **cut)
    dryrun._LocalCounter = _PeakCounter
    counters = []
    traced = dryrun._traced

    def keep(*a, **k):
        out = traced(*a, **k)
        counters.append(out[1])
        return out
    dryrun._traced = keep
    rec = dryrun.run_cell(args.arch, args.shape, quiet=True,
                          cfg_override=cfg)
    b = rec["bytes_per_device"]
    print(f"{args.arch} {args.shape} (depth {cfg.n_layers}): {rec['status']}, "
          f"temp {b['temp']} bytes, peak {b['peak']} bytes")
    if not counters:
        return
    c = counters[-1]
    total, count = collections.Counter(), collections.Counter()
    for n, op in c.at_high.values():
        name = op[0] if op else "?"
        total[name] += n
        count[name] += 1
    print(f"the high at op {c.high_op[1]} ({c.high_op[0]}) of {c.ops}; "
          f"live then, by the op that made it:")
    for name, n in total.most_common(args.top):
        print(f"  {name:32s} {n / 1e9:10.3f} GB  ({count[name]} storages)")


if __name__ == "__main__":
    main()
