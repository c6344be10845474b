"""arctic-480b [moe] — 128 routed experts top-2 + dense residual FFN.

[hf:Snowflake/snowflake-arctic-base; hf]  35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2, dense FFN residual in parallel.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,                 # dense residual FFN
    vocab_size=32000,
    head_dim=128,
    n_experts=128,
    n_experts_padded=128,
    top_k=2,
    moe_d_ff=4864,
    dense_parallel_ff=True,
    activation="silu",
    moe_gather_weights=True,   # §Perf: token·D ≫ expert-slice bytes at 32k prefill
)
