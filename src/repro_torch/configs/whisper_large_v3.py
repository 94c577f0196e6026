"""whisper-large-v3 [audio] — enc-dec, 32L+32L d=1280 20H ff=5120 V=51866.

[arXiv:2212.04356; unverified]  The conv frontend is a STUB: input_specs()
feeds precomputed (1500, d_model) frame embeddings to the encoder.
LayerNorm, GELU MLP, learned decoder positions.  Vocab padded 51866->51968
(mesh divisibility); decoder max_seq raised for the decode_32k cell
(published model decodes <=448 tokens; deviation noted in DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    is_encdec=True,
    n_layers=32,
    n_enc_layers=32,
    enc_seq=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_head=64,
    d_ff=5120,
    vocab=51866,
    vocab_pad=51968,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    pos="learned",
    max_seq=40_960,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    is_encdec=True,
    n_layers=2,
    n_enc_layers=2,
    enc_seq=16,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
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
