"""deepseek-v2-236b [moe] — 60L d=5120 128H, MLA kv_lora=512, V=102400,
MoE 160 routed top-6 + 2 shared (expert ff=1536).

[arXiv:2405.04434; hf]  MLA: q_lora=1536, qk_nope=128, qk_rope=64,
v_head=128; decode uses the absorbed-matmul latent-cache path.
Deviation: the published model's layer 0 is dense (ff=12288); here all 60
layers are MoE so the stack scans homogeneously (DESIGN.md §5).
param_dtype bf16 + int8 optimizer state (giant-model memory policy).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_head=192,              # qk_nope + qk_rope (informational; MLA path)
    d_ff=12288,              # unused (all layers MoE); kept for reference
    vocab=102400,
    norm="rmsnorm",
    rope_theta=10_000.0,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    capacity_factor=1.25,
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=48,
    d_ff=128,
    vocab=512,
    use_mla=True,
    kv_lora_rank=32,
    q_lora_rank=48,
    qk_nope_dim=32,
    qk_rope_dim=16,
    v_head_dim=32,
    n_experts=4,
    n_shared_experts=1,
    top_k=2,
    moe_d_ff=32,
    attn_chunk=64,
)
