"""qwen1.5-110b [dense] — 80L d=8192 64H (GQA kv=8) ff=49152 V=152064.

[hf:Qwen/Qwen1.5-110B; hf]  RMSNorm, QKV bias, rope theta 1e6.
param_dtype bf16 + int8 optimizer state (giant-model memory policy).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=49152,
    vocab=152064,
    norm="rmsnorm",
    act="silu_glu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="qwen110b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=16,
    d_ff=192,
    vocab=512,
    qkv_bias=True,
    attn_chunk=64,
)
