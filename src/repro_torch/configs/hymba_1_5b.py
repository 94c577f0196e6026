"""hymba-1.5b [hybrid] — 32L d=1600 25H (GQA kv=5) ff=5504 V=32001,
parallel attn + mamba heads, ssm_state=16.

[arXiv:2411.13676; hf]  Sliding-window attention (2048) in all layers
except 3 global ones (first/middle/last); the SSM path runs in parallel
with attention in every layer, outputs fused with per-path RMS norms and
learned gains.  Deviations (DESIGN.md §5): no meta-tokens, no cross-layer
KV sharing.  Vocab padded 32001->32128.  Sub-quadratic (window + SSM):
runs long_500k with all attention layers windowed + ring KV buffers.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    vocab_pad=32128,
    norm="rmsnorm",
    rope_theta=10_000.0,
    window=2048,
    global_layers=(0, 15, 31),
    ssm_state=16,
    ssm_heads=50,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    ssm_conv=4,
)

SMOKE = ModelConfig(
    name="hymba-smoke",
    family="hybrid",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=512,
    window=16,
    global_layers=(0,),
    ssm_state=8,
    ssm_heads=4,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_chunk=16,
    ssm_conv=4,
    attn_chunk=32,
)
