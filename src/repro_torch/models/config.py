"""Model configuration — one dataclass covers all 10 assigned families.

Field groups activate per family: dense (default), moe, mla, ssm, hybrid,
encdec, vlm/audio prefix stubs.  Configs are frozen; arch definitions live
in ``repro_torch.configs.<id>``.  Every field and default is the JAX
package's; ``compute_dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    family: str = "dense"        # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 16
    d_ff: int = 128
    vocab: int = 256
    vocab_pad: int = 0           # physical table size (0 = vocab); padding
                                 # keeps the vocab dim shardable by the mesh

    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "silu_glu"        # silu_glu | gelu (plain 2-matrix MLP)
    qkv_bias: bool = False
    pos: str = "rope"            # rope | learned | none
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0        # partial rotary (stablelm: 0.25)
    tie_embeddings: bool = False
    max_seq: int = 4096          # learned-pos table size / decode default

    # --- attention window (0 = full causal). hymba: SWA everywhere except
    # global_layers; long-context decode windows everything. ---
    window: int = 0
    global_layers: Tuple[int, ...] = ()

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0            # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "gather"     # gather (pjit baseline) | alltoall (shard_map)
    moe_replicas: int = 1        # physical copies per expert (load-balance /
                                 # EP-uniformity when n_experts < model axis)

    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # --- enc-dec (whisper) ---
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500          # precomputed frame embeddings (stub frontend)

    # --- vlm (pixtral): prefix patch embeddings (stub frontend) ---
    n_prefix: int = 0            # prefix embeddings prepended to tokens

    # --- numerics / structure ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"   # giants use bf16 masters + int8 opt state
    scan_layers: bool = True
    remat_policy: str = "nothing"  # nothing | dots | full(=save everything)
    attn_chunk: int = 1024         # kv-chunk for online-softmax attention
    attn_acc: str = "f32"          # f32 | bf16 accumulation inside attention
    decode_attn: str = "xla"       # xla | split_kv (shard_map flash-decode
                                   # over the seq-sharded cache)
    ce_chunk: int = 0              # seq-chunked CE loss (0 = monolithic)
    logit_cap: float = 0.0

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def d_q(self) -> int:
        if self.use_mla:
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.d_head

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def attends(self) -> bool:
        return self.family != "ssm"

    def n_params(self) -> int:
        """Total parameter count (matches param_table; used for 6ND)."""
        from repro_torch.models.params import param_table  # lazy, avoids cycle

        total = 0
        for info in param_table(self).values():
            n = 1
            for s in info.shape:
                n *= s
            total += n
        return total

    def n_active_params(self) -> int:
        """Active-per-token params (MoE: routed top_k + shared only)."""
        from repro_torch.models.params import param_table

        total = 0
        for path, info in param_table(self).items():
            n = 1
            for s in info.shape:
                n *= s
            if "experts" in info.axes:  # routed expert weights (maybe
                # behind a leading stacked-"layers" axis)
                n = (n // (self.n_experts * self.moe_replicas)
                     * min(self.top_k, self.n_experts))
            total += n
        return total


def validate(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` where the reference's asserts fail."""
    def need(cond: bool, what: str) -> None:
        if not cond:
            raise ValueError(f"{cfg.name}: {what}")

    need(cfg.family in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"),
         f"unknown family {cfg.family!r}")
    if cfg.family in ("dense", "encdec", "vlm", "hybrid"):
        need(cfg.n_heads % cfg.n_kv_heads == 0,
             "n_heads must be a multiple of n_kv_heads")
    if cfg.family == "moe":
        need(cfg.n_experts > 0 and cfg.top_k > 0 and cfg.moe_d_ff > 0,
             "moe needs n_experts, top_k and moe_d_ff")
    if cfg.family in ("ssm", "hybrid"):
        need(cfg.ssm_state > 0 and cfg.ssm_heads > 0,
             "ssm needs ssm_state and ssm_heads")
    if cfg.family == "encdec":
        need(cfg.is_encdec and cfg.n_enc_layers > 0,
             "encdec needs is_encdec and n_enc_layers")
