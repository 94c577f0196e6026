"""mamba2-130m [ssm] — 24L d=768, attn-free, ssm_state=128, V=50280.

[arXiv:2405.21060; unverified]  Pure SSD stack (no MLP: d_ff=0), expand=2
-> d_inner=1536, head_dim=64 -> 24 ssm heads, conv width 4, tied
embeddings.  Vocab padded 50280->50304.  Sub-quadratic: runs long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,            # unused (attn-free)
    n_kv_heads=1,
    d_head=1,
    d_ff=0,
    vocab=50280,
    vocab_pad=50304,
    norm="rmsnorm",
    pos="none",
    tie_embeddings=True,
    ssm_state=128,
    ssm_heads=24,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    ssm_conv=4,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_head=1,
    d_ff=0,
    vocab=512,
    pos="none",
    tie_embeddings=True,
    ssm_state=16,
    ssm_heads=4,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_chunk=16,
    ssm_conv=4,
)
