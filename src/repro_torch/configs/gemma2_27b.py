"""gemma2-27b [dense] — local+global alternating attention, logit softcap.

[arXiv:2408.00118; hf]  46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000.  head_dim=128, sliding window 4096 on Local layers (pattern
LG), attn softcap 50.0, final logit softcap 30.0, post-block norms,
query scale 1/sqrt(d_model/n_heads)=1/12^2 (gemma2 uses 144**-0.5? — we use
the released query_pre_attn_scalar=(4608/32)).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    sliding_window=4096,
    local_global_pattern="LG",
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_block_norm=True,
    attn_logit_scale=(4608 / 32) ** -0.5,
    activation="geglu",
    tie_embeddings=True,
    scale_embed=True,
)
