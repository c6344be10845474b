"""qwen2-vl-7b [vlm] — M-RoPE backbone; patch-embedding stub frontend.

[arXiv:2409.12191; hf]  28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE sections (t,h,w)=(16,24,24) over head_dim/2=64.
The vision tower is a STUB per the assignment: input_specs() provides
precomputed patch embeddings [B, S, 3584] + 3-stream positions.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    mrope_sections=(16, 24, 24),
    frontend="patch_stub",
    rope_theta=1e6,
    activation="silu",
)
