"""stablelm-2-1_6b [dense] — 24L d=2048 32H (GQA kv=32) ff=5632 V=100352.

[hf:stabilityai/stablelm-2-1_6b; unverified]  LayerNorm + partial rotary
(25%), QKV bias, gated-SiLU MLP.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=5632,
    vocab=100352,
    norm="layernorm",
    act="silu_glu",
    qkv_bias=True,
    rope_theta=10_000.0,
    rope_pct=0.25,
)

SMOKE = ModelConfig(
    name="stablelm-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=512,
    norm="layernorm",
    act="silu_glu",
    qkv_bias=True,
    rope_pct=0.25,
    attn_chunk=64,
)
