"""Checkpointing with bloom-clock lineage, async writes, restore.

Layout per checkpoint, the JAX package's, so a checkpoint written by
either package restores in the other:  <dir>/step_<N>/
  - state.npz        the state's leaves under the reference's keys:
                     ``_flatten(TrainState)`` gives ``0/<param path>``,
                     ``1/m/<path>``, ``1/v/<path>``, ``1/step``, ``2``
                     (clock cells) and ``3`` (step); a quantized moment
                     is ``<path>/0`` (int8 codes) and ``<path>/1``
                     (float32 scales); dict keys in sorted order.
                     bfloat16 leaves are stored as the reference stores
                     them: their 16 bits as a 2-byte void dtype.
  - manifest.json    step, run_id, clock snapshot (compressed §4 form),
                     leaf count, the caller's extras

Fault-tolerance behaviors:
  - **async save**: the host snapshot happens synchronously — every leaf
    on the card is copied without blocking into pinned host memory, then
    the stream is synchronised once — and the file write runs on a
    background thread; ``wait()`` drains before the next save (double
    buffering) and re-raises the write's error, if any.
  - **atomic publish**: writes go to ``.tmp-step_<N>`` then os.rename.
  - **lineage-checked restore**: ``restore()`` hands back the stored
    clock; callers gate on ``ClockRuntime.admit_restore``.
  - **GC**: keep the newest ``keep`` checkpoints.

``restore`` places the leaves on one device, or, given ``shardings``,
on the model mesh as DTensors: the reference's elastic reshard, so a
checkpoint written on any mesh (or none) restores onto any other.  A
state of DTensors is saved by its full values, gathered on every rank.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.device import resolve_device
from repro_torch.optim.adamw import Moment
from repro_torch.runtime.training import TrainState

__all__ = ["CheckpointManager"]

#: numpy's form of a bfloat16 leaf in the reference's npz files
_BF16_NP = np.dtype("V2")


def _children(node):
    """(key, child) pairs of a container in the reference's flatten
    order, or None for a leaf."""
    if isinstance(node, TrainState):
        return list(enumerate((node.params, node.opt, node.clock_cells,
                               node.step)))
    if isinstance(node, Moment):
        return [(0, node.codes), (1, node.scale)]
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _leaves(tree, prefix: tuple = ()):
    """(key, leaf) of every leaf: the key is the path joined by "/"."""
    kids = _children(tree)
    if kids is None:
        yield "/".join(str(p) for p in prefix), tree
        return
    for k, child in kids:
        yield from _leaves(child, prefix + (k,))


def _rebuild(tree, leaf_of, prefix: tuple = ()):
    """``tree``'s structure with each leaf replaced by ``leaf_of(key,
    old_leaf)``."""
    kids = _children(tree)
    if kids is None:
        return leaf_of("/".join(str(p) for p in prefix), tree)
    new = {k: _rebuild(c, leaf_of, prefix + (k,)) for k, c in kids}
    if isinstance(tree, TrainState):
        return TrainState(*(new[i] for i in range(4)))
    if isinstance(tree, Moment):
        return Moment(new[0], new[1], d=tree.d)
    if isinstance(tree, dict):
        return {k: new[k] for k in tree}
    return type(tree)(new[i] for i in range(len(tree)))


def _host_snapshot(flat: dict) -> dict:
    """Every tensor leaf as a numpy array after one wait for the card:
    card tensors are copied without blocking into pinned host memory and
    the streams synchronised once; CPU tensors are cloned."""
    out, cuda_devs = {}, set()
    for key, x in flat.items():
        if isinstance(x, DTensor):
            x = x.full_tensor()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
                cuda_devs.add(x.device)
            else:
                host = x.detach().clone()
            out[key] = host
        else:
            out[key] = np.asarray(x)
    for dev in cuda_devs:
        torch.cuda.current_stream(dev).synchronize()
    return {key: _to_numpy(x) if isinstance(x, torch.Tensor) else x
            for key, x in out.items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_NP)
    return t.numpy()


def _sharding_leaves(tree, prefix: tuple = ()):
    """(key, sharding) of a tree of shardings shaped as the state: a
    leaf is a ``sharding.NamedSharding`` or a ``(DeviceMesh,
    placements)`` pair."""
    if (isinstance(tree, (tuple, list)) and len(tree) == 2
            and isinstance(tree[0], DeviceMesh)):
        yield "/".join(str(p) for p in prefix), tuple(tree)
        return
    kids = _children(tree)
    if kids is None:
        yield "/".join(str(p) for p in prefix), (tree.mesh, tree.placements)
        return
    for k, child in kids:
        yield from _sharding_leaves(child, prefix + (k,))


def _to_tensor(a: np.ndarray, like, device) -> torch.Tensor:
    """A stored leaf as a tensor on ``device``; a 2-byte void or uint16
    leaf whose target is bfloat16 comes back as bfloat16."""
    a = np.asarray(a)
    if isinstance(like, torch.Tensor) and like.dtype == torch.bfloat16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, run_id: str = "run0"):
        self.dir = directory
        self.keep = keep
        self.run_id = run_id
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: host-clock seconds of the last save: ``snapshot_s`` (the host
        #: copy) and, once written, ``write_s`` (the file write)
        self.last_save: dict = {}
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, clock_snapshot: dict,
             extra: Optional[dict] = None, block: bool = False) -> str:
        """Snapshot now, write async. Returns the final path."""
        self.wait()  # double buffer: at most one write in flight
        t0 = time.perf_counter()
        flat = _host_snapshot(dict(_leaves(state)))
        self.last_save = {"snapshot_s": time.perf_counter() - t0}
        manifest = {
            "step": int(step),
            "run_id": self.run_id,
            "clock": {
                "cells": [int(v) for v in clock_snapshot["cells"]],
                "base": int(clock_snapshot["base"]),
                "k": int(clock_snapshot["k"]),
            },
            "n_leaves": len(flat),
            **(extra or {}),
        }
        final = os.path.join(self.dir, f"step_{step}")
        tmp = os.path.join(self.dir, f".tmp-step_{step}")
        record = self.last_save

        def _write():
            t1 = time.perf_counter()
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "state.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
            record["write_s"] = time.perf_counter() - t1

        if block:
            _write()
        else:
            def _run():
                try:
                    _write()
                except BaseException as e:  # re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()
        return final

    def wait(self) -> None:
        """Drain the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def list_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def clock_manifests(self) -> list:
        """[(step, manifest)] for every checkpoint, sorted by step.

        Reads only the manifest.json files (clock snapshots are a few KB
        in §4 wire form) — what ``ClockRuntime.classify_checkpoints``
        feeds to one classify call to lineage-check a whole directory
        without touching state tensors.
        """
        self.wait()
        out = []
        for step in self.list_steps():
            path = os.path.join(self.dir, f"step_{step}", "manifest.json")
            with open(path) as f:
                out.append((step, json.load(f)))
        return out

    def restore(self, step: Optional[int] = None, target_structure=None,
                shardings=None, device=None):
        """Returns (state, manifest).  With ``target_structure`` (a
        ``TrainState``, or any dict/list/``Moment`` tree of the same
        keys) the leaves come back in its structure as tensors on
        ``device`` (None = the card); without it, the stored flat dict
        of numpy arrays, as the reference returns it.  With
        ``shardings`` (a tree of the target's structure whose leaves are
        ``sharding.NamedSharding``s, e.g. ``launch.specs
        .state_shardings``, or ``(DeviceMesh, placements)`` pairs) each
        leaf comes back as a DTensor placed by its sharding, every rank
        taking its shards of the stored value, on the mesh's device
        type (``device`` is not read): the elastic reshard."""
        if shardings is not None and target_structure is None:
            raise ValueError("restore(shardings=...) needs target_structure")
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "state.npz")) as npz:
            flat = dict(npz)
        if target_structure is None:
            return flat, manifest
        keys = [k for k, _ in _leaves(target_structure)]
        missing = [k for k in keys if k not in flat]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
        if shardings is None:
            dev = resolve_device(device)
            state = _rebuild(target_structure,
                             lambda key, like: _to_tensor(flat[key], like, dev))
            return state, manifest
        placed = dict(_sharding_leaves(shardings))

        def _placed(key, like):
            mesh, pl = placed[key]
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if mesh.device_type == "cuda" else torch.device("cpu"))
            return distribute_tensor(_to_tensor(flat[key], like, dev), mesh,
                                     pl, src_data_rank=None)

        return _rebuild(target_structure, _placed), manifest
