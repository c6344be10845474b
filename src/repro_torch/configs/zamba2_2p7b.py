"""zamba2-2.7b [hybrid] — Mamba2 trunk + shared attention blocks.

[arXiv:2411.15242; hf]  54L d_model=2560, 32H (kv=32 → MHA) d_ff=10240 for
the SHARED attention+MLP block (weights reused every 6 layers, each
occurrence with its own KV cache; block input is concat(hidden, embedding)
projected 2D→D, per the Zamba design), ssm_state=64.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    shared_attn_every=6,
    tie_embeddings=True,
)
