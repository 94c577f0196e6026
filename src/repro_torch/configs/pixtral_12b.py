"""pixtral-12b [vlm] — 40L d=5120 32H (GQA kv=8) ff=14336 V=131072.

[hf:mistralai/Pixtral-12B-2409; unverified]  Mistral-NeMo-style backbone
(head_dim 128 -> q width 4096 != d_model).  The pixtral ViT frontend is a
STUB: input_specs() provides 256 precomputed patch embeddings prepended to
the token stream (seq_len counts patches + text).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=131072,
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    n_prefix=256,
)

SMOKE = ModelConfig(
    name="pixtral-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    n_prefix=4,
    attn_chunk=64,
)
