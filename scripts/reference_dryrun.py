#!/usr/bin/env python3
"""The JAX package's own dry run (``repro.launch.dryrun``), on an
Auto-axis production mesh: the per-device argument, output, ``temp``
and ``peak`` bytes XLA reports for each cell, the figures the port's
dry run (``python -m repro_torch.launch.dryrun``) is held against.

Under JAX 0.9 the package's ``make_production_mesh`` gives Explicit
axes, on which its first ``with_sharding_constraint`` raises ("can only
refer to Auto axes").  This script patches in ``jax.make_mesh(shape,
axes, axis_types=(AxisType.Auto,) * n)`` with the same shapes and axis
names (16 x 16 ("data", "model"); 2 x 16 x 16 with "pod") and then runs
the package's own ``main``, which takes the same flags; nothing under
``src/repro`` changes.  The 512 host devices are the package's own
``XLA_FLAGS`` setting, so an ``XLA_FLAGS`` from the environment is
dropped first.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/reference_dryrun.py \\
        --arch qwen1_5_0_5b --shape train_4k --out reports/ref_dryrun.jsonl
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/reference_dryrun.py \\
        --all --out reports/ref_dryrun.jsonl

Run from the root of a checkout, on the CPU: each cell lowers and
compiles the full config's step for 512 devices (tens of seconds to a
few minutes a cell, a few GB of host memory).  Cells already in
``--out`` are skipped, as in the package's ``main``.
"""
from __future__ import annotations

import os

os.environ.pop("XLA_FLAGS", None)

from repro.launch import dryrun  # noqa: E402  (sets the 512 devices)

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


dryrun.make_production_mesh = make_production_mesh

if __name__ == "__main__":
    dryrun.main()
