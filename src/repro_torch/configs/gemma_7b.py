"""gemma-7b [dense] — GeGLU, head_dim=256.

[arXiv:2403.08295; hf]  28L d_model=3072 16H (kv=16 → MHA) d_ff=24576
vocab=256000, head_dim=256 (q-dim 4096 ≠ d_model), embedding scaling.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    activation="geglu",
    tie_embeddings=True,
    scale_embed=True,
)
