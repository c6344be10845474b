"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  24L d_model=768, d_inner=1536 (expand 2),
headdim=64 → 24 SSD heads, d_state=128, vocab=50280.  n_heads/n_kv_heads
fields are unused (attention-free).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    tie_embeddings=True,
)
