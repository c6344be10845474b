"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (kv=16) d_ff=1408
vocab=151936, MoE 60e top-4.  60 routed experts are PADDED to 64 for EP
divisibility (padding experts get -inf router logits: never selected).
Shared experts are merged into one FFN of 4*1408=5632.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    head_dim=128,
    n_experts=60,
    n_experts_padded=64,
    top_k=4,
    moe_d_ff=1408,
    n_shared_experts=4,
    shared_d_ff=5632,
    router_norm_topk=False,
    activation="silu",
    prefer_pure_dp=True,   # §Perf: 2.7B-active MoE — TP-16 psums dominated
)
