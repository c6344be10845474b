"""Plain forward of the Qwen3 dense decoder (``model_type`` ``qwen3``,
Hugging Face ``Qwen3ForCausalLM``), float32.

Per layer: ``x += o_proj(attn(rope(q_norm(q)), rope(k_norm(k)), v))`` on
``rmsnorm(x)``, GQA with ``num_key_value_heads`` groups, RMSNorm over each
head of q and k before RoPE; then ``x += down(silu(gate(h)) · up(h))`` on
``rmsnorm(x)``.  No biases, an untied head.  Departure, shared by the
program: norm weights are stored in offset form, ``(1 + w)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import KV, NORM_STD, Precision, decoder_forward, decoder_layout, mlp_layout, swiglu


def layout(cfg: dict) -> list:
    """The weights' leaves: the decoder's, each layer's per-head q and k
    norm weights (float32, ``head_dim``), and a SwiGLU MLP."""
    d = cfg["hidden_size"]
    hd = cfg.get("head_dim") or d // cfg["num_attention_heads"]

    def ffn(L, mat):
        return ([(L + ("attn", "q_norm"), (hd,), torch.float32, NORM_STD),
                 (L + ("attn", "k_norm"), (hd,), torch.float32, NORM_STD)]
                + mlp_layout(L + ("mlp",), mat, d, cfg["intermediate_size"]))

    return decoder_layout(cfg, ffn)


def _mlp(p: dict, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    m = p["mlp"]
    return swiglu(h, prec.weight(m["w_gate"]), prec.weight(m["w_up"]), prec.weight(m["w_down"]),
                  prec)


def forward(weights: dict, cfg: dict, tokens: torch.Tensor, rows: torch.Tensor,
            prec: Optional[Precision] = None, past: Optional[KV] = None):
    """Logits at ``rows`` of the new ``tokens`` after ``past``; see
    :func:`common.decoder_forward`."""
    return decoder_forward(weights, cfg, tokens, rows, prec or Precision(), _mlp, past)
