"""The port's dry run beside the reference's, on the CPU:
``launch.dryrun.run_cell``'s per-device argument bytes on the fake
16 x 16 group against the reference's ``run_cell`` on its 16 x 16 mesh
of forced host devices, one smoke arch per family.

Tolerance: none, the byte counts are exact, but for the one named
exception: a decode step's position and a decode cache's ``length`` and
``pos``, scalars the reference keeps on the device and the port on the
host (``host_scalars``, leaf by leaf).  The port's ``temp``, ``peak``
and ``cost.bytes_accessed`` count its eager steps (the unfused ops and
the live storages of ``launch.dryrun._traced``), not the reference's
compiled ones, so they are held to invariants: integers, ``temp >= 0``,
``peak >= argument + temp``, ``bytes_accessed >= argument``; the
reference's figures are printed beside them.

Both dry runs run in subprocesses, side by side: the port's sets up its
fake group there, and the reference's 512 forced host devices must be
set before JAX starts, which this process has started with 8.  The
reference's production mesh there has Auto axes: its ``jax.make_mesh``
gives Explicit axes under JAX 0.9, on which its first ``shard`` raises,
so the subprocess patches in ``jax.make_mesh(shape, axes,
axis_types=(AxisType.Auto,) * n)`` with the reference's shapes and
names (nothing under ``src/repro`` changes).  Both take the smoke
configs with ``attn_chunk`` 2,048 and ``ssm_chunk`` 256, which change
no input's shape and keep the eager trace of the port short.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


#: one smoke arch per family, at each cell where the reference's dry run
#: completes (whisper's learned positions stop at its smoke max_seq of
#: 256, below train_4k's and prefill_32k's lengths, so only its decode)
DRY_CELLS = [(a, s) for a in ("qwen1_5_0_5b", "grok_1_314b", "mamba2_130m",
                              "hymba_1_5b", "pixtral_12b")
             for s in SHAPES] + [("whisper_large_v3", "decode_32k")]
#: the chunk sizes both dry runs take (no input shape depends on them)
DRY_CHUNKS = dict(attn_chunk=2048, ssm_chunk=256)
#: qwen1.5-0.5b's smoke figures, per device on 16x16, of the reference
QWEN_SMOKE_BYTES = {"train_4k": 542_224, "prefill_32k": 266_752,
                    "decode_32k": 8_393_268}

_REF_DRY = """
    import dataclasses, json, sys
    from repro.launch import dryrun
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_smoke_config

    def mesh(multi_pod=False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(axes))

    dryrun.make_production_mesh = mesh
    for a, s in {cells!r}:
        cfg = dataclasses.replace(get_smoke_config(a), **{chunks!r})
        rec = dryrun.run_cell(a, s, cfg_override=cfg, quiet=True)
        b = rec["bytes_per_device"]
        print(json.dumps([a, s, rec["status"], b["argument"], b["temp"],
                          b["peak"], rec["cost"]["bytes_accessed"]]),
              flush=True)
"""

_PORT_DRY = """
    import dataclasses, json, sys
    from repro_torch.launch import dryrun
    from repro_torch.configs import get_smoke_config
    dryrun.init_fake_group(512)
    for a, s in {cells!r}:
        cfg = dataclasses.replace(get_smoke_config(a), **{chunks!r})
        rec = dryrun.run_cell(a, s, cfg_override=cfg, quiet=True)
        b = rec["bytes_per_device"]
        print(json.dumps([a, s, rec["status"], b["argument"], b["output"],
                          rec["cost"]["flops"], b["temp"], b["peak"],
                          rec["cost"]["bytes_accessed"],
                          rec["collectives"]["counts"]]), flush=True)
"""


def _start(code: str, cells: list) -> subprocess.Popen:
    e = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
             OMP_NUM_THREADS="2")
    e.pop("XLA_FLAGS", None)
    src = textwrap.dedent(code.format(cells=cells, chunks=DRY_CHUNKS))
    return subprocess.Popen([sys.executable, "-c", src], cwd=ROOT, env=e,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def dry_runs():
    """Both dry runs over ``DRY_CELLS``, the reference's in three
    processes and the port's in two, all side by side: {side: {(arch,
    shape): record}}."""
    groups = [[c for c in DRY_CELLS if c[0] in archs]
              for archs in (("mamba2_130m", "hymba_1_5b"),
                            ("qwen1_5_0_5b", "grok_1_314b"),
                            ("pixtral_12b", "whisper_large_v3"))]
    procs = {"ref": [_start(_REF_DRY, g) for g in groups],
             "port": [_start(_PORT_DRY, groups[0]),
                      _start(_PORT_DRY, groups[1] + groups[2])]}
    out = {}
    for side, ps in procs.items():
        out[side] = {}
        for p in ps:
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, stderr[-4000:]
            for line in stdout.splitlines():
                if line.startswith("["):
                    rec = json.loads(line)
                    out[side][tuple(rec[:2])] = rec[2:]
    return out


def host_scalars(arch: str) -> dict:
    """The decode inputs the reference holds on the device and the port
    on the host, leaf by leaf, in bytes a device (replicated int32): the
    attention cache's ``length`` and ``pos`` (one a layer) and the
    step's ``pos``.  A stack without attention reads no position."""
    cfg = get_smoke_config(arch)
    if not cfg.attends:
        return {}
    return {"caches.attn.length": 4 * cfg.n_layers,
            "caches.attn.pos": 4 * cfg.n_layers, "pos": 4}


@pytest.mark.parametrize("arch,shape", DRY_CELLS)
def test_dryrun_argument_bytes_match_reference(dry_runs, arch, shape):
    ref = dry_runs["ref"][(arch, shape)]
    port = dry_runs["port"][(arch, shape)]
    assert ref[0] == "ok" and port[0] == "ok"
    gap = sum(host_scalars(arch).values()) if shape == "decode_32k" else 0
    assert port[1] == ref[1] - gap, (port[1], ref[1], host_scalars(arch))
    if arch == "qwen1_5_0_5b":
        assert ref[1] == QWEN_SMOKE_BYTES[shape]
    out_bytes, flops, temp, peak, accessed, counts = port[2:]
    # the reference's XLA figures beside the port's eager counts, for
    # information only: XLA fuses, reuses buffers and donates the state
    print(f"{arch} {shape}: temp/peak/bytes_accessed port {temp}/{peak}/"
          f"{accessed}, reference {ref[2]}/{ref[3]}/{ref[4]}")
    assert out_bytes > 0 and flops > 0
    assert all(type(v) is int for v in (temp, peak, accessed))
    assert temp >= 0 and peak >= port[1] and peak >= port[1] + temp
    assert accessed >= port[1]
    assert set(counts) == {"all-gather", "all-reduce", "reduce-scatter",
                           "all-to-all", "collective-permute"}
