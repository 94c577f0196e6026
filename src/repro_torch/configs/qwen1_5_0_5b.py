"""qwen1.5-0.5b [dense] — 24L d=1024 16H (GQA kv=16) ff=2816 V=151936.

[hf:Qwen/Qwen1.5-0.5B; hf]  RMSNorm, QKV bias, rope theta 1e6 (32k ctx),
tied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=2816,
    vocab=151936,
    norm="rmsnorm",
    act="silu_glu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen0.5-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=512,
    qkv_bias=True,
    tie_embeddings=True,
    attn_chunk=64,
)
