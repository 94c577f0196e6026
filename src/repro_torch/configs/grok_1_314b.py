"""grok-1-314b [moe] — 64L d=6144 48H (GQA kv=8) expert_ff=32768 V=131072,
MoE 8 experts top-2.

[hf:xai-org/grok-1; unverified]  RMSNorm, rope, logit softcap 30.
On a 16-wide model axis the 8 experts are replicated 2x (expert
replication, round-robin by token) so expert-parallel all_to_all stays
uniform; documented in DESIGN.md.  param_dtype bf16 + int8 opt state.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,              # reference; experts use moe_d_ff
    vocab=131072,
    norm="rmsnorm",
    rope_theta=10_000.0,
    n_experts=8,
    n_shared_experts=0,
    top_k=2,
    moe_d_ff=32768,
    capacity_factor=1.25,
    logit_cap=30.0,
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="grok-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    n_experts=4,
    n_shared_experts=0,
    top_k=2,
    moe_d_ff=64,
    logit_cap=30.0,
    attn_chunk=64,
)
