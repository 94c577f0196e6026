"""Dry-run plumbing: abstract inputs, state shardings, step functions.

The reference's module on meta tensors and DTensor placements:
``abstract_state`` and ``abstract_params_dict`` give meta tensors (the
reference's ``ShapeDtypeStruct``s: shapes and dtypes, no storage),
``batch_specs`` and ``cache_specs`` the inputs of the step a cell runs,
and the ``*_shardings`` functions a ``sharding.NamedSharding`` (a
``PartitionSpec`` on the mesh) for every tensor leaf, from the logical
rule table.  ``place`` puts a tree of tensors on the mesh by a tree of
shardings, as DTensors (no communication: every rank holds the same
global value, or a meta tensor).  ``build_step`` returns the step:

  train_4k    -> train_step(state, batch)
  prefill_32k -> prefill_step(params, batch)
  decode_32k / long_500k -> serve_step(params, caches, token, pos)

Where the reference keeps a scalar on the device the port keeps a host
integer: a decode cache's ``length`` and ``pos`` and the decode step's
``pos``.  Their shardings are None.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import abstract_params, param_table
from repro_torch.optim.adamw import Moment, OptConfig, init_opt_state
from repro_torch.runtime.clock_runtime import ClockConfig
from repro_torch.runtime.training import TrainState, make_train_step
from repro_torch.sharding import (P, NamedSharding, axis_sizes,
                                  logical_to_pspec, param_pspecs)
from repro_torch.shapes import Shape

__all__ = ["abstract_state", "abstract_params_dict", "params_shardings",
           "state_shardings", "batch_specs", "batch_shardings", "build_step",
           "cache_specs", "cache_shardings", "place"]


# --------------------------------------------------------------------------
# abstract state
# --------------------------------------------------------------------------

def abstract_state(cfg: ModelConfig, opt_cfg: OptConfig,
                   clock_cfg: ClockConfig) -> TrainState:
    """``init_train_state``'s state as meta tensors."""
    params = abstract_params(cfg)
    return TrainState(
        params=params,
        opt=init_opt_state(params, opt_cfg),
        clock_cells=torch.zeros((clock_cfg.m,), dtype=torch.int32,
                                device="meta"),
        step=torch.zeros((), dtype=torch.int32, device="meta"))


def abstract_params_dict(cfg: ModelConfig) -> dict:
    return abstract_params(cfg)


def params_shardings(mesh, rules: dict, cfg: ModelConfig) -> dict:
    return param_pspecs(mesh, rules, param_table(cfg))


def _dp_axes(mesh) -> tuple:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def state_shardings(mesh, rules: dict, cfg: ModelConfig,
                    abstract: TrainState) -> TrainState:
    """Mirror the param table's logical axes onto every state leaf.

    Optimizer moments (incl. int8 Moment codes/scales) reuse their param's
    axes — divisibility fallback handles the blocked scale dims.
    """
    table = param_table(cfg)

    def spec_for(path_key: str, leaf) -> NamedSharding:
        axes = None
        info = table.get(path_key)
        if info is not None and len(info.axes) == leaf.ndim:
            axes = info.axes
        if axes is None:
            axes = (None,) * leaf.ndim
        return NamedSharding(mesh, logical_to_pspec(mesh, rules, axes,
                                                    leaf.shape))

    def map_dict(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, Moment):
                out[k] = Moment(codes=spec_for(k, v.codes),
                                scale=spec_for(k, v.scale), d=v.d)
            else:
                out[k] = spec_for(k, v)
        return out

    repl = NamedSharding(mesh, P())
    return TrainState(
        params=map_dict(abstract.params),
        opt={
            "m": map_dict(abstract.opt["m"]),
            "v": map_dict(abstract.opt["v"]),
            "step": repl,
        },
        clock_cells=repl,
        step=repl,
    )


# --------------------------------------------------------------------------
# batch inputs
# --------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: Shape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    toks = S - cfg.n_prefix if cfg.n_prefix else S

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    specs = {
        "tokens": meta((B, toks), torch.int32),
        "labels": meta((B, toks), torch.int32),
        "ev_hi": meta((), torch.uint32),
        "ev_lo": meta((), torch.uint32),
    }
    if cfg.n_prefix:
        specs["prefix_embeds"] = meta((B, cfg.n_prefix, cfg.d_model),
                                      cfg.compute_dtype)
    if cfg.is_encdec:
        specs["enc_frames"] = meta((B, cfg.enc_seq, cfg.d_model),
                                   cfg.compute_dtype)
    return specs


def batch_shardings(mesh, specs: dict) -> dict:
    dp = _dp_axes(mesh)
    sizes = axis_sizes(mesh)
    out = {}
    for k, v in specs.items():
        if v.ndim == 0:
            out[k] = NamedSharding(mesh, P())
            continue
        B = v.shape[0]
        ext = 1
        for a in dp:
            ext *= sizes[a]
        lead = dp if B % ext == 0 else None
        out[k] = NamedSharding(mesh, P(lead, *([None] * (v.ndim - 1))))
    return out


# --------------------------------------------------------------------------
# decode caches
# --------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, shape: Shape, long_context: bool = False):
    """Abstract decode caches: ``init_decode_caches`` on meta tensors."""
    return T.init_decode_caches(cfg, shape.global_batch, shape.seq_len,
                                long_context=long_context, device="meta")


_CACHE_AXES = {
    # leaf-name suffix -> logical axes (leading "layers" implicit)
    "k": ("layers", "act_batch", "act_seq_cache", "act_kv_cache", None),
    "v": ("layers", "act_batch", "act_seq_cache", "act_kv_cache", None),
    "ckv": ("layers", "act_batch", "act_seq_cache", None),
    "krope": ("layers", "act_batch", "act_seq_cache", None),
    "conv": ("layers", "act_batch", None, "act_mlp"),
    "state": ("layers", "act_batch", "act_ssm_heads", None, None),
    # cross-attention cache (enc-dec): enc_seq (1500) rarely divides the
    # model axis -> rely on batch sharding
    "cross": ("layers", "act_batch", "act_seq_cache", "act_kv_cache", None),
}


def _map_caches(caches: dict, fn) -> dict:
    """``caches`` with every tensor field replaced by ``fn(path,
    tensor)``, ``path`` the (cache key, field name); host integers and
    flags stay."""
    out = {}
    for key, c in caches.items():
        fields = {}
        for f in dataclasses.fields(c):
            v = getattr(c, f.name)
            if isinstance(v, torch.Tensor):
                fields[f.name] = fn((key, f.name), v)
        out[key] = dataclasses.replace(c, **fields)
    return out


def cache_shardings(mesh, rules: dict, caches: dict) -> dict:
    rules = dict(rules)
    rules.setdefault("act_seq_cache", None)
    rules.setdefault("act_ssm_heads", "model")

    def spec(path, leaf):
        name = next((p for p in reversed(path) if p in _CACHE_AXES), None)
        if name is None or len(_CACHE_AXES[name]) != leaf.ndim:
            return NamedSharding(mesh, P(*([None] * leaf.ndim)))
        return NamedSharding(
            mesh, logical_to_pspec(mesh, rules, _CACHE_AXES[name], leaf.shape))

    return _map_caches(caches, spec)


# --------------------------------------------------------------------------
# placing a tree on the mesh
# --------------------------------------------------------------------------

def _place_leaf(t: torch.Tensor, sh) -> torch.Tensor:
    if isinstance(t, DTensor):
        return t.redistribute(sh.mesh, sh.placements)
    return distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None)


def place(tree, shardings):
    """``tree`` (a tensor, dict, ``TrainState``, ``Moment`` or a dict of
    decode caches) as DTensors placed by ``shardings``, the same tree of
    ``NamedSharding``s; every rank gives the same global values."""
    if isinstance(tree, torch.Tensor):
        return _place_leaf(tree, shardings)
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, TrainState):
        return TrainState(*(place(getattr(tree, f), getattr(shardings, f))
                            for f in ("params", "opt", "clock_cells", "step")))
    if isinstance(tree, Moment):
        return Moment(place(tree.codes, shardings.codes),
                      place(tree.scale, shardings.scale), tree.d)
    if dataclasses.is_dataclass(tree):     # a decode cache
        return dataclasses.replace(tree, **{
            f.name: place(getattr(tree, f.name), getattr(shardings, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------

def build_step(cfg: ModelConfig, shape: Shape, opt_cfg: OptConfig = None,
               clock_cfg: ClockConfig = None) -> Callable:
    opt_cfg = opt_cfg or OptConfig()
    clock_cfg = clock_cfg or ClockConfig()

    if shape.kind == "train":
        return make_train_step(cfg, opt_cfg, clock_cfg)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            logits, caches = T.prefill(
                params, cfg, batch["tokens"],
                prefix_embeds=batch.get("prefix_embeds"),
                enc_frames=batch.get("enc_frames"),
                buf_len=batch["tokens"].shape[1] + (cfg.n_prefix or 0))
            return logits, caches

        return prefill_step

    def serve_step(params, caches, token, pos):
        return T.decode_step(params, cfg, caches, token, pos)

    return serve_step
