"""Mixture-of-Experts layer of the port: the router and the routed experts.

* :func:`moe_apply` — the serving path.  Tokens are dispatched by sorting
  their ``[T, k]`` expert choices, so each expert's rows lie together; the
  routed experts' gate, up and down products go through the grouped GEMM
  (:mod:`repro_torch.kernels.grouped_gemm`: the CUDA kernel with
  ``kernel=True`` on a card, its plain version otherwise), and the rows are
  put back in token order, weighted and summed over k.  It computes each
  token on its k experts only.
* :func:`moe_reference` — the reference's dense one-hot dispatch (every
  expert on every token, E× the expert flops): a test oracle, never served.

Under a parallel context on a real mesh whose expert axes divide the
padded expert count, :func:`moe_apply` dispatches to the expert-parallel
path, :func:`repro_torch.parallel.moe_parallel.moe_ep` (the reference's
``parallel/moe_parallel.py``: capacity-bounded all-to-all dispatch, the
local experts' products through the same grouped GEMM), as the reference's
``moe_apply`` does; outside one it runs the sorted dispatch below (the
reference falls back to its dense dispatch there).  Config notes:
qwen2-moe's 60 routed experts are padded to 64 (padding experts' router
logits are -1e30, so they are never chosen); arctic's parallel dense FFN
and qwen2-moe's merged shared experts are added by the caller
(``transformer.block_apply``).  The reference's load-balancing auxiliary
loss (Switch-style, ``E · Σ_e f_e · P_e``) is a training term: the serving
path never computes it; ``with_aux=True`` (the training forward) returns it
beside the output.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import grouped_gemm as gg_kernel
from repro_torch.parallel.context import current_context, is_dtensor

Params = Dict[str, Any]


def router_topk(
    p_router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig, *, with_aux: bool = False
) -> Tuple[torch.Tensor, ...]:
    """Returns (weights ``[T, k]`` fp32, experts ``[T, k]`` int64) for flat
    tokens ``x [T, D]``: softmax over fp32 router logits, padding experts
    forced to -1e30, top-k, optionally renormalised.  ``with_aux=True``
    appends the load-balancing loss ``E_real · Σ_e mean_t(P_te) · f_e``
    (``f_e``: the share of the ``T·k`` choices that went to expert ``e``)."""
    e_real, e_pad = cfg.n_experts, cfg.n_experts_padded or cfg.n_experts
    # a new tensor, and matmul does not save its output for backward: the
    # padding columns can be written in place under autograd too
    logits = x.float() @ p_router                         # [T, Epad]
    if e_pad > e_real:
        logits[:, e_real:] = -1e30
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.router_norm_topk:
        weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    if not with_aux:
        return weights, experts
    me = probs.mean(dim=0)                                # mean prob per expert
    flat = experts.reshape(-1)
    ce = torch.zeros_like(me).index_add_(0, flat, torch.ones_like(flat, dtype=me.dtype))
    aux = e_real * torch.sum(me * (ce / flat.numel()))
    return weights, experts, aux


def moe_reference(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The reference's dense dispatch oracle.  x: ``[B, S, D]`` → y."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    weights, experts = router_topk(p["router"], xt, cfg)
    e = cfg.n_experts_padded or cfg.n_experts
    onehot = F.one_hot(experts, e).to(x.dtype)            # [T, k, E]
    comb = (onehot * weights[..., None].to(x.dtype)).sum(1)   # [T, E]
    gate = torch.einsum("td,edf->tef", xt, p["w_gate"])
    up = torch.einsum("td,edf->tef", xt, p["w_up"])
    h = F.silu(gate) * up
    y_e = torch.einsum("tef,efd->ted", h, p["w_down"])    # [T, E, D]
    y = torch.einsum("ted,te->td", y_e, comb)
    return y.reshape(b, s, d)


def moe_apply(
    p: Params, x: torch.Tensor, cfg: ModelConfig, *, kernel: bool = False, with_aux: bool = False,
):
    """Sorted dispatch through the grouped GEMM.  x: ``[B, S, D]`` → y, or
    (y, the router's load-balancing loss) with ``with_aux=True``.

    Every row of the batch is routed, padding rows of a fused step included
    (as the reference does); a valid row's result does not depend on them.
    Nothing is read back to the host: the group sizes stay on the device,
    and every step is deterministic (a stable sort, a gather, and a scatter
    to distinct rows — no atomic accumulation), so greedy tokens repeat run
    to run.  ``kernel=True`` calls the grouped GEMM's wrapper (the CUDA
    kernel for a CUDA tensor); otherwise its plain version.  On a mesh
    (DTensor ``x`` under a context whose ``ep_axes`` divide the padded
    expert count) it is :func:`~repro_torch.parallel.moe_parallel.moe_ep`."""
    ctx = current_context()
    e_pad = cfg.n_experts_padded or cfg.n_experts
    if ctx is not None and ctx.ep_axes and is_dtensor(x) and e_pad % ctx.axis_size(ctx.ep_axes) == 0:
        from repro_torch.parallel.moe_parallel import moe_ep

        y, aux = moe_ep(p, x, cfg, ctx, kernel=kernel)
        return (y, aux) if with_aux else y
    b, s, d = x.shape
    k = cfg.top_k
    xt = x.reshape(b * s, d)
    routed = router_topk(p["router"], xt, cfg, with_aux=with_aux)
    weights, experts = routed[0], routed[1]               # [T, k]
    flat = experts.reshape(-1)                            # [T·k]
    order = torch.argsort(flat, stable=True)              # (token, choice) slots by expert
    # rows per expert, counted on the device (torch.bincount would read the
    # ids' maximum back to the host)
    ids = torch.arange(e_pad, device=flat.device)
    group_sizes = (flat[:, None] == ids[None, :]).sum(0, dtype=torch.int32)
    xs = xt.index_select(0, order // k)                   # [T·k, D], sorted by expert
    gemm = gg_kernel.grouped_gemm if kernel else gg_kernel.grouped_gemm_plain
    gate = gemm(xs, p["w_gate"], group_sizes)
    up = gemm(xs, p["w_up"], group_sizes)
    ys = gemm(F.silu(gate) * up, p["w_down"], group_sizes)
    # back to (token, choice) order: slot order[j] gets sorted row j
    y = torch.empty_like(ys).index_copy_(0, order, ys).reshape(b * s, k, d)
    y = (y * weights[..., None].to(y.dtype)).sum(1).reshape(b, s, d)
    return (y, routed[2]) if with_aux else y
