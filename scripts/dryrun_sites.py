#!/usr/bin/env python3
"""Where a dry-run cell's collectives come from: the port's dry run of
one (arch x shape) cell on the 16 x 16 mesh of a fake 512-rank group
(``repro_torch.launch.dryrun.run_cell``), traced with a ``_LocalCounter``
that files each functional collective's output bytes under the call
site that issued it: the innermost frame of ``repro_torch``'s model code
(``models/``, ``runtime/``), with the ``sharding.py`` frame below it
where there is one.  Prints the cell's bytes of the kind asked for, then
the sites, largest first.

    PYTHONPATH=src python3 scripts/dryrun_sites.py deepseek_v2_236b \\
        decode_32k [--kind all-gather] [--layers 1] [--top 12]

Runs on the CPU (meta tensors, no storage); ``--layers`` cuts the
config's depth (the enc-dec encoder's too).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import traceback

from repro_torch.configs import get_config
from repro_torch.launch import dryrun


def _site() -> str:
    """The issuing frames, outermost first: the innermost model frame and
    the ``sharding.py`` frame under it (paths from ``repro_torch``)."""
    frames = [f for f in traceback.extract_stack()
              if f"{os.sep}repro_torch{os.sep}" in f.filename]
    name = [f"{f.filename.split(os.sep + 'repro_torch' + os.sep)[1]}:"
            f"{f.lineno}" for f in frames]
    model = [i for i, f in enumerate(frames)
             if f"{os.sep}models{os.sep}" in f.filename
             or f"{os.sep}runtime{os.sep}" in f.filename]
    if not model:
        return name[-1] if name else "?"
    i = model[-1]
    below = [n for n in name[i + 1:] if n.startswith("sharding.py")]
    return " > ".join([name[i]] + below[:1])


class _SiteCounter(dryrun._LocalCounter):
    """``_LocalCounter`` that also sums each collective kind's output
    bytes by call site (``sites[kind][site]``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.sites = collections.defaultdict(collections.Counter)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = dict(self.coll)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for kind, n in self.coll.items():
            if n != before[kind]:
                self.sites[kind][_site()] += n - before[kind]
        return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--kind", default="all-gather",
                    choices=list(dryrun._COLLECTIVES))
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this depth (0: its own)")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    dryrun.init_fake_group(512)
    cfg = get_config(args.arch)
    if args.layers:
        cut = {"n_layers": args.layers}
        if cfg.is_encdec:
            cut["n_enc_layers"] = args.layers
        cfg = dataclasses.replace(cfg, **cut)
    dryrun._LocalCounter = _SiteCounter
    counters = []
    traced = dryrun._traced

    def keep(*a, **k):
        out = traced(*a, **k)
        counters.append(out[1])
        return out
    dryrun._traced = keep
    rec = dryrun.run_cell(args.arch, args.shape, quiet=True,
                          cfg_override=cfg)
    print(f"{args.arch} {args.shape} (depth {cfg.n_layers}): {rec['status']}, "
          f"{args.kind} {rec['collectives'][args.kind]} bytes a device")
    if not counters:
        return
    for site, n in counters[-1].sites[args.kind].most_common(args.top):
        print(f"  {n:16d}  {site}")


if __name__ == "__main__":
    main()
