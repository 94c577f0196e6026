"""Parameter table: the single source of truth for every weight.

``param_table(cfg)`` maps path -> ParamInfo(shape, dtype, logical axes,
init kind), entry for entry the JAX package's.  ``init_params``
materializes it from an explicit ``torch.Generator``: the same init
kinds, not the same values (those come across with
``convert.params_from_jax``).  ``abstract_params`` gives the table as
meta tensors (the reference's ``ShapeDtypeStruct``s): shapes and
dtypes, no storage, for the dry run.

Per-layer entries are stacked along a leading "layers" axis when
``cfg.scan_layers``, and named ``layers_{i}/...`` otherwise.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["ParamInfo", "param_table", "init_params", "abstract_params",
           "torch_dtype"]


@dataclasses.dataclass(frozen=True)
class ParamInfo:
    shape: tuple
    axes: tuple              # logical axis names, len == len(shape)
    init: str = "linear"     # linear | embed | zeros | ones | ssm_a | dt_bias
    dtype: str = "float32"


def _norm_entries(cfg: ModelConfig, prefix: str) -> "OrderedDict[str, ParamInfo]":
    t = OrderedDict()
    t[f"{prefix}/scale"] = ParamInfo((cfg.d_model,), ("embed_v",), "ones")
    if cfg.norm == "layernorm":
        t[f"{prefix}/bias"] = ParamInfo((cfg.d_model,), ("embed_v",), "zeros")
    return t


def _attn_entries(cfg: ModelConfig, prefix: str, cross: bool = False) -> "OrderedDict[str, ParamInfo]":
    t = OrderedDict()
    H, KV, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    t[f"{prefix}/wq"] = ParamInfo((D, H * Dh), ("embed", "q_heads"))
    t[f"{prefix}/wk"] = ParamInfo((D, KV * Dh), ("embed", "kv_heads"))
    t[f"{prefix}/wv"] = ParamInfo((D, KV * Dh), ("embed", "kv_heads"))
    t[f"{prefix}/wo"] = ParamInfo((H * Dh, D), ("q_heads", "embed"))
    if cfg.qkv_bias:
        t[f"{prefix}/bq"] = ParamInfo((H * Dh,), ("q_heads_v",), "zeros")
        t[f"{prefix}/bk"] = ParamInfo((KV * Dh,), ("kv_heads_v",), "zeros")
        t[f"{prefix}/bv"] = ParamInfo((KV * Dh,), ("kv_heads_v",), "zeros")
    return t


def _mla_entries(cfg: ModelConfig, prefix: str) -> "OrderedDict[str, ParamInfo]":
    t = OrderedDict()
    D = cfg.d_model
    H = cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    t[f"{prefix}/w_dq"] = ParamInfo((D, cfg.q_lora_rank), ("embed", "lora"))
    t[f"{prefix}/q_norm"] = ParamInfo((cfg.q_lora_rank,), ("lora_v",), "ones")
    t[f"{prefix}/w_uq"] = ParamInfo((cfg.q_lora_rank, H * qk), ("lora", "q_heads"))
    # down-proj emits the compressed kv (kv_lora) and the shared rope key
    t[f"{prefix}/w_dkv"] = ParamInfo(
        (D, cfg.kv_lora_rank + cfg.qk_rope_dim), ("embed", "lora")
    )
    t[f"{prefix}/kv_norm"] = ParamInfo((cfg.kv_lora_rank,), ("lora_v",), "ones")
    t[f"{prefix}/w_uk"] = ParamInfo(
        (cfg.kv_lora_rank, H * cfg.qk_nope_dim), ("lora", "q_heads")
    )
    t[f"{prefix}/w_uv"] = ParamInfo(
        (cfg.kv_lora_rank, H * cfg.v_head_dim), ("lora", "q_heads")
    )
    t[f"{prefix}/wo"] = ParamInfo((H * cfg.v_head_dim, D), ("q_heads", "embed"))
    return t


def _mlp_entries(cfg: ModelConfig, prefix: str, d_ff: int | None = None) -> "OrderedDict[str, ParamInfo]":
    t = OrderedDict()
    D, F = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu_glu":
        t[f"{prefix}/w_gate"] = ParamInfo((D, F), ("embed", "mlp"))
        t[f"{prefix}/w_up"] = ParamInfo((D, F), ("embed", "mlp"))
        t[f"{prefix}/w_down"] = ParamInfo((F, D), ("mlp", "embed"))
    else:  # gelu 2-matrix
        t[f"{prefix}/w_in"] = ParamInfo((D, F), ("embed", "mlp"))
        t[f"{prefix}/b_in"] = ParamInfo((F,), ("mlp_v",), "zeros")
        t[f"{prefix}/w_out"] = ParamInfo((F, D), ("mlp", "embed"))
        t[f"{prefix}/b_out"] = ParamInfo((D,), ("embed_v",), "zeros")
    return t


def _moe_entries(cfg: ModelConfig, prefix: str) -> "OrderedDict[str, ParamInfo]":
    t = OrderedDict()
    D, F = cfg.d_model, cfg.moe_d_ff
    E = cfg.n_experts * cfg.moe_replicas  # physical expert slots
    t[f"{prefix}/router"] = ParamInfo((D, cfg.n_experts), ("embed", "experts_r"))
    t[f"{prefix}/w_gate"] = ParamInfo((E, D, F), ("experts", "embed", "expert_mlp"))
    t[f"{prefix}/w_up"] = ParamInfo((E, D, F), ("experts", "embed", "expert_mlp"))
    t[f"{prefix}/w_down"] = ParamInfo((E, F, D), ("experts", "expert_mlp", "embed"))
    if cfg.n_shared_experts:
        t.update(_mlp_entries(cfg, f"{prefix}/shared", cfg.n_shared_experts * F))
    return t


def _ssm_entries(cfg: ModelConfig, prefix: str) -> "OrderedDict[str, ParamInfo]":
    t = OrderedDict()
    D = cfg.d_model
    di = cfg.d_inner_ssm
    H, N = cfg.ssm_heads, cfg.ssm_state
    g = 1  # single B/C group (mamba2 default n_groups=1)
    conv_ch = di + 2 * g * N
    # in_proj -> [z(di), x(di), B(g*N), C(g*N), dt(H)]
    t[f"{prefix}/in_proj"] = ParamInfo((D, 2 * di + 2 * g * N + H), ("embed", "ssm_inner"))
    t[f"{prefix}/conv_w"] = ParamInfo((cfg.ssm_conv, conv_ch), ("conv_v", "ssm_inner_v"))
    t[f"{prefix}/conv_b"] = ParamInfo((conv_ch,), ("ssm_inner_v",), "zeros")
    t[f"{prefix}/a_log"] = ParamInfo((H,), ("ssm_heads_v",), "ssm_a")
    t[f"{prefix}/d_skip"] = ParamInfo((H,), ("ssm_heads_v",), "ones")
    t[f"{prefix}/dt_bias"] = ParamInfo((H,), ("ssm_heads_v",), "dt_bias")
    t[f"{prefix}/norm"] = ParamInfo((di,), ("ssm_inner_v",), "ones")
    t[f"{prefix}/out_proj"] = ParamInfo((di, D), ("ssm_inner", "embed"))
    return t


def _layer_table(cfg: ModelConfig) -> "OrderedDict[str, ParamInfo]":
    """One decoder layer (the scanned unit)."""
    t = OrderedDict()
    fam = cfg.family
    if fam == "ssm":
        t.update(_norm_entries(cfg, "norm1"))
        t.update(_ssm_entries(cfg, "ssm"))
        return t
    t.update(_norm_entries(cfg, "norm1"))
    if cfg.use_mla:
        t.update(_mla_entries(cfg, "attn"))
    else:
        t.update(_attn_entries(cfg, "attn"))
    if fam == "hybrid":
        t.update(_ssm_entries(cfg, "ssm"))
        # per-path output gains (hymba-style normalized fusion)
        t["fuse/gain_attn"] = ParamInfo((cfg.d_model,), ("embed_v",), "ones")
        t["fuse/gain_ssm"] = ParamInfo((cfg.d_model,), ("embed_v",), "ones")
    if cfg.is_encdec:
        t.update(_norm_entries(cfg, "norm_cross"))
        t.update(_attn_entries(cfg, "cross", cross=True))
    t.update(_norm_entries(cfg, "norm2"))
    if fam == "moe":
        t.update(_moe_entries(cfg, "moe"))
    else:
        t.update(_mlp_entries(cfg, "mlp"))
    return t


def _enc_layer_table(cfg: ModelConfig) -> "OrderedDict[str, ParamInfo]":
    t = OrderedDict()
    t.update(_norm_entries(cfg, "norm1"))
    t.update(_attn_entries(cfg, "attn"))
    t.update(_norm_entries(cfg, "norm2"))
    t.update(_mlp_entries(cfg, "mlp"))
    return t


def _stack(layer_t: "OrderedDict[str, ParamInfo]", n: int, scan: bool, prefix: str):
    t = OrderedDict()
    if scan:
        for k, v in layer_t.items():
            t[f"{prefix}/{k}"] = ParamInfo((n,) + v.shape, ("layers",) + v.axes, v.init, v.dtype)
    else:
        for i in range(n):
            for k, v in layer_t.items():
                t[f"{prefix}_{i}/{k}"] = v
    return t


def param_table(cfg: ModelConfig) -> "OrderedDict[str, ParamInfo]":
    t = OrderedDict()
    V = cfg.vocab_pad or cfg.vocab
    t["embed/tokens"] = ParamInfo((V, cfg.d_model), ("vocab", "embed"), "embed")
    if cfg.pos == "learned":
        t["embed/pos"] = ParamInfo((cfg.max_seq, cfg.d_model), ("seq_tab", "embed"), "embed")
    if cfg.is_encdec:
        # encoder positional table over frame slots (frontend itself is a stub)
        t["encoder/pos"] = ParamInfo((cfg.enc_seq, cfg.d_model), ("seq_tab", "embed"), "embed")
        t.update(_stack(_enc_layer_table(cfg), cfg.n_enc_layers, cfg.scan_layers, "enc_layers"))
        t["encoder/norm_f/scale"] = ParamInfo((cfg.d_model,), ("embed_v",), "ones")
        if cfg.norm == "layernorm":
            t["encoder/norm_f/bias"] = ParamInfo((cfg.d_model,), ("embed_v",), "zeros")
    t.update(_stack(_layer_table(cfg), cfg.n_layers, cfg.scan_layers, "layers"))
    t.update(_norm_entries(cfg, "norm_f"))
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamInfo((cfg.d_model, V), ("embed", "vocab"))
    if cfg.param_dtype != "float32":
        t = OrderedDict(
            (k, dataclasses.replace(v, dtype=cfg.param_dtype)) for k, v in t.items()
        )
    return t


# ---------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``ParamInfo.dtype`` name."""
    return _DTYPES[name]


def _init_leaf(gen: torch.Generator, info: ParamInfo) -> torch.Tensor:
    """One leaf on the generator's device, drawn in float32 and cast."""
    shape, kind = info.shape, info.init
    dt = torch_dtype(info.dtype)
    dev = gen.device
    if kind == "zeros":
        return torch.zeros(shape, dtype=dt, device=dev)
    if kind == "ones":
        return torch.ones(shape, dtype=dt, device=dev)
    x = torch.empty(shape, dtype=torch.float32, device=dev)
    if kind == "embed":
        return (x.normal_(generator=gen) * 0.02).to(dt)
    if kind == "ssm_a":  # A in [-8, -1): a_log = log(-A)
        return torch.log(x.uniform_(1.0, 8.0, generator=gen)).to(dt)
    if kind == "dt_bias":  # softplus^-1 of dt ~ U[1e-3, 1e-1]
        u = x.uniform_(1e-3, 1e-1, generator=gen)
        return (u + torch.log(-torch.expm1(-u))).to(dt)
    # linear: truncated-normal fan-in scaling (lecun)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / np.sqrt(max(fan_in, 1))
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * std).to(dt)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> dict:
    """Flat path -> tensor dict of ``param_table(cfg)``, drawn in table
    order from ``generator`` on its own device, then placed on
    ``device`` (None = the card).  One seed gives the same weights."""
    dev = resolve_device(device)
    return {path: _init_leaf(generator, info).to(dev)
            for path, info in param_table(cfg).items()}


def abstract_params(cfg: ModelConfig) -> dict:
    """``{path: meta tensor}`` of ``param_table(cfg)``: each leaf's shape
    and dtype, without storage."""
    return {path: torch.empty(info.shape, dtype=torch_dtype(info.dtype),
                              device="meta")
            for path, info in param_table(cfg).items()}
