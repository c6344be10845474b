"""Plain forward of the Qwen1.5-MoE / Qwen2-MoE decoder (``model_type``
``qwen2_moe``, Hugging Face ``Qwen2MoeForCausalLM``), float32.

Per layer: multi-head attention with RoPE on ``rmsnorm(x)``; then on
``h = rmsnorm(x)`` the sparse block: router logits ``h @ W_r`` over the
``num_experts`` experts, softmax, the ``num_experts_per_tok`` largest
probabilities taken as they are (``norm_topk_prob`` false), each chosen
expert's ``down(silu(gate(h)) · up(h))`` weighted by its probability and
summed, plus the shared expert of width
``shared_expert_intermediate_size`` on every token.

Departures, shared by the program (it has no such parameters): no bias on
the q, k and v projections, and no ``shared_expert_gate`` (the published
model scales the shared expert by ``sigmoid(h @ w_g)``; here it is added
whole).  Norm weights are stored in offset form, ``(1 + w)``.  The weights
hold the experts padded to a multiple the program lays out; the router's
padding columns are never read here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .common import KV, Precision, decoder_forward, decoder_layout, mlp_layout, swiglu


def layout(cfg: dict) -> list:
    """The weights' leaves: the decoder's, then per layer the router
    (float32 ``[d, E]``, scale ``1/sqrt(d)``), the experts stacked ``[E,
    d_in, d_out]`` and the shared expert.  ``E`` is the count the program
    lays out (``port.experts_padded``, at least ``num_experts``)."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    e = cfg["port"].get("experts_padded") or cfg["num_experts"]

    def ffn(L, mat):
        return ([(L + ("moe", "router"), (d, e), torch.float32, 1.0 / math.sqrt(d)),
                 mat(L + ("moe", "w_gate"), d, f, (e,)), mat(L + ("moe", "w_up"), d, f, (e,)),
                 mat(L + ("moe", "w_down"), f, d, (e,))]
                + mlp_layout(L + ("shared_mlp",), mat, d, cfg["shared_expert_intermediate_size"]))

    return decoder_layout(cfg, ffn)


def route(h: torch.Tensor, router: torch.Tensor, cfg: dict):
    """``(probabilities [T, k], experts [T, k])`` of rows ``h [T, d]``:
    softmax over the real experts' float32 logits, top-k, not renormed."""
    e = cfg["num_experts"]
    probs = torch.softmax(h @ router[:, :e].to(torch.float32), dim=-1)
    weights, experts = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg.get("norm_topk_prob"):
        weights = weights / weights.sum(-1, keepdim=True)
    return weights, experts


def _moe(p: dict, h: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    m = p["moe"]
    weights, experts = route(h, m["router"], cfg)
    y = torch.zeros_like(h)
    for e in torch.unique(experts).tolist():
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        out = swiglu(h[tok], prec.weight(m["w_gate"][e]), prec.weight(m["w_up"][e]),
                     prec.weight(m["w_down"][e]), prec)
        y.index_add_(0, tok, out * weights[tok, slot][:, None])
    s = p["shared_mlp"]
    return y + swiglu(h, prec.weight(s["w_gate"]), prec.weight(s["w_up"]),
                      prec.weight(s["w_down"]), prec)


def forward(weights: dict, cfg: dict, tokens: torch.Tensor, rows: torch.Tensor,
            prec: Optional[Precision] = None, past: Optional[KV] = None):
    """Logits at ``rows`` of the new ``tokens`` after ``past``; see
    :func:`common.decoder_forward`."""
    return decoder_forward(weights, cfg, tokens, rows, prec or Precision(),
                           lambda p, h, pr: _moe(p, h, cfg, pr), past)
