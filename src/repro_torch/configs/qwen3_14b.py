"""qwen3-14b [dense] — qk_norm, GQA.

[hf:Qwen/Qwen3-8B; hf]  40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, per-head RMS qk-norm, head_dim=128.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    activation="silu",
)
