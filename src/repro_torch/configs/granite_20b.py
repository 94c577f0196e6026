"""granite-20b [dense/code] — 52L d=6144 48H (MQA kv=1) ff=24576 V=49152.

[arXiv:2405.04324; hf]  GPT-BigCode style: LayerNorm, learned absolute
positions, GELU 2-matrix MLP, multi-query attention, biases.
max_seq raised to 40960 so the assigned decode_32k cell (learned-pos
table lookup at position 32768) is well-defined — the published model
stops at 8192; deviation noted in DESIGN.md.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_head=128,
    d_ff=24576,
    vocab=49152,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    pos="learned",
    max_seq=40_960,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab=512,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    pos="learned",
    max_seq=256,
    attn_chunk=64,
)
