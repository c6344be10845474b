"""FLOPs that useful tokens need, per model configuration (a
configuration file's dict).

A token that enters the model (a prompt token of a prefill chunk, or the
pending token of a decode row) needs 2 FLOPs per weight it is multiplied
by in the layers (attention projections, the feed-forward; of an MoE
layer the router, the shared expert and its ``num_experts_per_tok``
experts), plus attention at its depth: ``4 · heads · head_dim`` per key it
sees (scores and the weighted sum), per layer.  The head's ``2 · d · V``
is needed only where a token is emitted: a decode row, or the last row of
a prompt.
"""

from __future__ import annotations


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def layer_weights_per_token(cfg: dict) -> int:
    """Weights of one layer that each token is multiplied by."""
    d, h, g = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = head_dim(cfg)
    attn = d * (h * hd) * 2 + d * (g * hd) * 2
    if cfg["model_type"] == "qwen2_moe":
        f, sf = cfg["moe_intermediate_size"], cfg["shared_expert_intermediate_size"]
        ffn = d * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * d * f + 3 * d * sf
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return attn + ffn


def forward_flops(cfg: dict, q_len: int, cache_pos: int) -> float:
    """FLOPs of ``q_len`` new tokens of one sequence at depth ``cache_pos``
    (keys before them), without the head."""
    if q_len <= 0:
        return 0.0
    n_layers = cfg["num_hidden_layers"]
    keys = q_len * cache_pos + q_len * (q_len + 1) / 2      # Σ over the new tokens of keys seen
    attn = 4.0 * cfg["num_attention_heads"] * head_dim(cfg) * keys
    return n_layers * (2.0 * layer_weights_per_token(cfg) * q_len + attn)


def head_flops(cfg: dict, emitted: int) -> float:
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * emitted
