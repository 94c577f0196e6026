"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta tensors.

For each cell:
  - build the step function (train / prefill / serve per the shape kind),
  - meta-tensor inputs (no storage) placed on the production mesh as
    DTensors by the shardings of the logical rule table (16x16
    single-pod; 2x16x16 multi-pod),
  - run the step once on them, and record what one rank holds and does.

The mesh spans a process group on the ``"fake"`` backend of 512 ranks,
set up by ``main`` before anything else (the counterpart of the
reference's 512 forced host devices); this process is rank 0, and the
fake group's collectives move nothing.  The step runs once, eagerly,
under a dispatch mode that counts rank 0's local ops (``_traced``):

  - ``bytes_per_device.argument`` / ``.output``: exact sums of rank 0's
    local shards of the inputs (those the step reads) and of the
    outputs;
  - ``bytes_per_device.peak``: argument + the most bytes that storages
    the step created held at once (each storage counted once, however
    many views share it, until its last reference dies: autograd's
    saved tensors, remat's recompute, collectives' outputs; views,
    in-place and ``out=`` ops create none).  The caller holds the
    inputs throughout: the port's train step is functional, so its new
    state is created beside the old one, where the reference's ``jit``
    donates it;
  - ``bytes_per_device.temp``: peak - argument - the bytes of the
    output's storages the step created (a cache written in place adds
    0), as XLA's peak = argument + output + temp;
  - ``bytes_per_device.generated_code``: null: eager PyTorch builds no
    executable for a cell, and the CUDA kernels are built once for
    every cell;
  - ``cost.flops``: the FLOPs of the local ops rank 0 runs
    (``torch.utils.flop_counter``'s formulas, forward and backward);
  - ``cost.bytes_accessed``: every tensor input and output of each local
    op but the views and ``_NO_TRAFFIC``, at numel x element size: the
    unfused eager traffic the port issues, not comparable to XLA's count
    after fusion;
  - ``collectives``: the functional collectives the DTensor ops issue,
    under the reference's five kind names, each the sum of the output
    bytes of its local ops, plus ``counts`` (``CommDebugMode``'s);
  - ``replicated_fallback``: the parameters whose named dims fell back
    to replication (a dim that does not divide its axis), and the
    sharded tensors the step gathered to run an op on replicated
    operands (``sharding.to_local``).

The card's caching allocator is the check on ``peak``: ``chip_smoke.py``
traces a meta copy of three full-config steps with ``_traced`` and
holds each transient (peak - argument) against ``max_memory_allocated``
above the step's start (``[dryrun-mem]``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1_5_0_5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out reports/dryrun.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import sharding as SH
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.params import param_table
from repro_torch.optim.adamw import Moment, OptConfig
from repro_torch.runtime.clock_runtime import ClockConfig
from repro_torch.runtime.training import TrainState
from repro_torch.shapes import SHAPES, runnable

__all__ = ["init_fake_group", "run_cell", "main"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
#: functional collective op name -> the reference's kind
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}


def init_fake_group(world_size: int = 512) -> None:
    """A default process group of ``world_size`` ranks on the fake
    backend, this process rank 0 (nothing when one is set up)."""
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


#: functional collectives' wrappers: on the card each returns its input
#: (wrapped), while its meta kernel allocates a new tensor, so the
#: output takes over the input's live bytes
_PASS_THROUGH = frozenset({"wait_tensor", "_wrap_tensor_autograd"})
#: local ops whose bytes are not counted (besides the views that create
#: no storage): they rename, synchronise, read metadata or read one
#: value to the host
_NO_TRAFFIC = _PASS_THROUGH | {"_unsafe_view", "_reshape_alias", "sym_size",
                               "sym_stride", "sym_numel",
                               "sym_storage_offset", "is_same_size",
                               "_local_scalar_dense"}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _LocalCounter(TorchDispatchMode):
    """FLOPs, collective bytes, live bytes and bytes accessed of the local
    ops of one rank on ``device`` (the traced device: ``meta`` in the dry
    run): a DTensor op is passed on to DTensor (which runs it as local
    ops, counted here), and the fake tensors of DTensor's shape
    propagation are not counted.

    Live bytes: each storage an op creates on ``device`` (a result on
    no input's storage: views, in-place and ``out=`` ops create none),
    once however many views share it, from that op until its last
    reference dies (``weakref.finalize`` on the storage); ``high`` is
    the most live at any op boundary.  Bytes accessed: every tensor
    input and output on ``device`` of each op that creates a storage or
    is not a view, and is not in ``_NO_TRAFFIC``, at its numel x element
    size."""

    def __init__(self, device="meta"):
        super().__init__()
        self.device = torch.device(device).type
        self.flops = 0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.bytes_accessed = 0
        self.live = 0
        self.high = 0
        self._sizes = {}                    # live storage key -> nbytes

    def _on_device(self, tree) -> list:
        return [t for t in _tensors(tree) if t.device.type == self.device]

    def _created(self, st) -> None:
        key = st._cdata
        if key in self._sizes:
            return
        self._sizes[key] = n = st.nbytes()
        self.live += n
        weakref.finalize(st, self._freed, key).atexit = False

    def _freed(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _handed_over(self, src, dst) -> None:
        """``dst`` takes over ``src``'s live bytes (nothing when the step
        did not create ``src``)."""
        n = self._sizes.pop(src._cdata, None)
        if n is not None:
            self.live -= n
            self._created(dst)

    def created_bytes(self, tree) -> int:
        """Bytes of the storages under ``tree`` (DTensors: their local
        shards) that the counted ops created and that are still live."""
        keys = {(t.to_local() if isinstance(t, DTensor) else t)
                .untyped_storage()._cdata for t in _leaves(tree)}
        return sum(self._sizes.get(k, 0) for k in keys)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, torch._subclasses.FakeTensor) for t in types):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        kind = _KIND.get(packet.__name__)
        if kind is not None:
            self.coll[kind] += sum(t.numel() * t.element_size()
                                   for t in _tensors(out))
        ins, outs = self._on_device((args, kwargs)), self._on_device(out)
        fresh = []
        if packet.__name__ in _PASS_THROUGH:
            for i, o in zip(ins, outs):
                self._handed_over(i.untyped_storage(), o.untyped_storage())
        else:
            read = {t.untyped_storage()._cdata for t in ins}
            fresh = [t for t in outs if t.untyped_storage()._cdata not in read]
            for t in fresh:
                self._created(t.untyped_storage())
        # a view's schema may also copy (``contiguous`` of a strided
        # shard): it moves bytes when it creates a storage
        if (fresh or not func.is_view) and packet.__name__ not in _NO_TRAFFIC:
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in ins + outs)
        self.high = max(self.high, self.live)
        return out


def _traced(step, args: tuple, argument: int, device="meta",
            grad: bool = True):
    """``step(*args)`` once under a ``_LocalCounter`` on ``device``
    (under ``torch.no_grad()`` unless ``grad``), the step's inputs of
    ``argument`` bytes held by the caller throughout.  Returns (out,
    counter, memory): ``peak`` = argument + the most bytes the step's
    own storages held at once, ``temp`` = peak - argument - the bytes of
    the output's storages the step created (an output aliasing an
    input, such as a cache written in place, adds 0)."""
    with _LocalCounter(device) as count:
        if grad:
            out = step(*args)
        else:
            with torch.no_grad():
                out = step(*args)
    return out, count, {"temp": count.high - count.created_bytes(out),
                        "peak": argument + count.high}


def _leaves(tree) -> list:
    """Every tensor of a step's inputs or outputs (state, dicts, tuples,
    decode caches); host integers are not counted."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, TrainState):
        return _leaves([tree.params, tree.opt, tree.clock_cells, tree.step])
    if isinstance(tree, Moment):
        return [tree.codes, tree.scale]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):       # a decode cache
        return _leaves([getattr(tree, f) for f in tree.__dataclass_fields__])
    return []


def _local_bytes(tree) -> int:
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in _leaves(tree))


def _param_fallbacks(mesh, rules: dict, cfg) -> list:
    """Paths of parameters with a named dim left replicated although its
    rule names axes of this mesh (a dim that does not divide, or an axis
    an earlier dim took)."""
    sizes = SH.axis_sizes(mesh)
    out = []
    for path, info in param_table(cfg).items():
        spec = SH.logical_to_pspec(mesh, rules, info.axes, info.shape)
        for name, entry in zip(info.axes, spec):
            rule = rules.get(name) if name and not name.endswith("_v") else None
            want = tuple(a for a in (rule if isinstance(rule, tuple)
                                     else (rule,)) if a in sizes)
            have = entry if isinstance(entry, tuple) else (
                () if entry is None else (entry,))
            if len(have) < len(want):
                out.append(path)
                break
    return out


#: leaves of an enc-dec decoder layer that decode does not read (it
#: attends over the cross cache)
_CROSS_KV = ("cross/wk", "cross/wv", "cross/bk", "cross/bv")


def _decode_params(params: dict, cfg) -> dict:
    """The parameters a decode step reads, the ones its argument bytes
    count: the reference's jit drops unused arguments from the
    executable, and an enc-dec decode step reads neither the encoder nor
    the cross K/V projections."""
    if not cfg.is_encdec:
        return params
    return {k: v for k, v in params.items()
            if not k.startswith(("encoder/", "enc_layers"))
            and not k.endswith(_CROSS_KV)}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             rules: dict | None = None, opt_override: dict | None = None,
             cfg_override=None, quiet: bool = False) -> dict:
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "kind": shape.kind}
    if not runnable(cfg.family, shape_name):
        rec["status"] = "skip"
        rec["reason"] = "full-attention arch; long_500k needs sub-quadratic path"
        return rec

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = rules or dict(SH.DEFAULT_RULES)
    opt_cfg = OptConfig(state_dtype="int8" if cfg.param_dtype == "bfloat16"
                        else "float32", **(opt_override or {}))
    clock_cfg = ClockConfig()

    with SH.use_mesh_rules(mesh, rules):
        step = S.build_step(cfg, shape, opt_cfg, clock_cfg)
        if shape.kind == "train":
            state = S.abstract_state(cfg, opt_cfg, clock_cfg)
            bspecs = S.batch_specs(cfg, shape)
            args = (S.place(state, S.state_shardings(mesh, rules, cfg, state)),
                    S.place(bspecs, S.batch_shardings(mesh, bspecs)))
        elif shape.kind == "prefill":
            # only what prefill reads: the reference's jit drops unused
            # arguments (labels, the event id) from the executable
            bspecs = {k: v for k, v in S.batch_specs(cfg, shape).items()
                      if k in ("tokens", "prefix_embeds", "enc_frames")}
            args = (S.place(S.abstract_params_dict(cfg),
                            S.params_shardings(mesh, rules, cfg)),
                    S.place(bspecs, S.batch_shardings(mesh, bspecs)))
        else:  # decode
            caches = S.cache_specs(cfg, shape,
                                   long_context=(shape_name == "long_500k"))
            tok = torch.empty((shape.global_batch,), dtype=torch.int32,
                              device="meta")
            args = (S.place(S.abstract_params_dict(cfg),
                            S.params_shardings(mesh, rules, cfg)),
                    S.place(caches, S.cache_shardings(mesh, rules, caches)),
                    S.place(tok, S.batch_shardings(mesh, {"t": tok})["t"]),
                    shape.seq_len - 1)
        read = ((_decode_params(args[0], cfg),) + args[1:]
                if shape.kind == "decode" else args)
        argument = _local_bytes(read)
        rec["bytes_per_device"] = {"argument": argument}
        SH.FALLBACKS.clear()
        with CommDebugMode() as comm:
            out, count, mem = _traced(step, args, argument,
                                      grad=shape.kind == "train")
        rec["trace_s"] = round(time.time() - t0, 1)
        rec["bytes_per_device"].update(output=_local_bytes(out), **mem,
                                       generated_code=None)
        rec["cost"] = {"flops": count.flops,
                       "bytes_accessed": count.bytes_accessed}
        counts = {k: 0 for k in _COLLECTIVES}
        for op, n in comm.get_comm_counts().items():
            kind = _KIND.get(getattr(op, "__name__", str(op)).split(".")[-1])
            if kind is not None:
                counts[kind] += n
        rec["collectives"] = {**count.coll, "counts": counts}
        rec["replicated_fallback"] = {
            "params": _param_fallbacks(mesh, rules, cfg),
            "gathers": dict(SH.FALLBACKS)}
        rec["status"] = "ok"
        if not quiet:
            print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: OK "
                  f"(trace {rec['trace_s']}s, flops={rec['cost']['flops']:.3e})")
            print("  memory:", rec["bytes_per_device"])
            print("  collectives:", {k: v for k, v in rec["collectives"].items()
                                     if k != "counts"})
    return rec


def main():
    init_fake_group(512)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=str, default="reports/dryrun.jsonl")
    args = ap.parse_args()

    cells = []
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") in ("ok", "skip"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    n_fail = 0
    with open(args.out, "a") as f:
        for a, s, mp in cells:
            key = (a, s, "2x16x16" if mp else "16x16")
            if key in done:
                print(f"[dryrun] {key}: cached, skipping")
                continue
            try:
                rec = run_cell(a, s, multi_pod=mp)
            except Exception as e:
                traceback.print_exc()
                rec = {"arch": a, "shape": s,
                       "mesh": "2x16x16" if mp else "16x16",
                       "status": "fail", "error": f"{type(e).__name__}: {e}"}
                n_fail += 1
            f.write(json.dumps(rec) + "\n")
            f.flush()
    print(f"[dryrun] finished, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
