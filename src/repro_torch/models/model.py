"""Model façade: ``build_model(cfg)`` returns a ``Model`` with uniform entry
points, so callers never branch on family; plus the training loss and
parameter accounting (``cross_entropy_loss``, ``param_count``,
``active_param_count``).  Every family of the reference
is ported: dense, MoE, VLM, SSM and hybrid on
:mod:`repro_torch.models.transformer`, enc-dec on
:mod:`repro_torch.models.encdec`.  As in the reference, the SSM, hybrid,
enc-dec and VLM families are served through these entry points only: the
stage executor and the engine serve decoder-only attention blocks on
token inputs."""

from __future__ import annotations

from dataclasses import dataclass
import math
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.context import is_dtensor
from repro_torch.parallel.vocab import cross_entropy_parts
from . import encdec, transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    # (generator, device=None) -> params at the reference's init
    # distributions, on the first card unless device says otherwise
    init: Callable[..., Any]
    # (params, batch) -> (logits [B,S,V], aux loss): the whole sequence, no
    # cache; raises for a kernel config (the kernels are forward-only)
    train_forward: Callable[..., Tuple[Any, Any]]
    prefill: Callable[..., Tuple[Any, Any]]
    # chunked prefill (prompt consumed in fixed-token pieces, state carried
    # across boundaries) — greedy-token-identical to `prefill`
    prefill_chunked: Callable[..., Tuple[Any, Any]]
    decode_step: Callable[..., Tuple[Any, Any]]
    # fused mixed prefill/decode step: tokens [B,S] with per-row
    # (cache_pos, q_lens) — returns (full logits [B,S,V], caches)
    fused_step: Callable[..., Tuple[Any, Any]]
    # (batch, max_len, device=None) -> dense KV cache (default: first card)
    init_cache: Callable[..., Any]
    # (num_pages, page_tokens, batch=1, device=None) -> paged KV pools
    # (default: first card); the page table rides into each forward call as
    # page_table=[B, pages_per_slot]
    init_paged_cache: Callable[..., Any]


def build_model(cfg: ModelConfig) -> Model:
    from repro_torch.convert import init_params

    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=lambda generator, device=None: init_params(cfg, generator, device),
            train_forward=lambda p, b: encdec.train_forward(p, b, cfg),
            prefill=lambda p, b, max_len=None: encdec.prefill(p, b, cfg, max_len),
            prefill_chunked=lambda p, b, max_len=None, chunk=64, **kw: encdec.prefill_chunked(
                p, b, cfg, max_len, chunk=chunk, **kw
            ),
            decode_step=lambda p, t, c, pos, page_table=None: encdec.decode_step(
                p, t, c, pos, cfg, page_table=page_table
            ),
            fused_step=lambda p, t, c, pos, qlens, page_table=None: encdec.fused_step(
                p, t, c, pos, qlens, cfg, page_table=page_table
            ),
            # as the reference: a placeholder cross cache of length s (the
            # encoder's frame count is unknown here), replaced at prefill
            init_cache=lambda b, s, device=None: {
                "self": encdec.init_self_cache(cfg, b, s, device),
                "cross": encdec.init_self_cache(cfg, b, s, device),
            },
            init_paged_cache=lambda num_pages, page_tokens, b=1, device=None: {
                "self": encdec.init_paged_self_cache(cfg, num_pages, page_tokens, device),
                "cross": None,  # computed at prefill from the encoder memory
            },
        )
    transformer.check_family(cfg)
    return Model(
        cfg=cfg,
        init=lambda generator, device=None: init_params(cfg, generator, device),
        train_forward=lambda p, b: transformer.train_forward(p, b, cfg),
        prefill=lambda p, b, max_len=None: transformer.prefill(p, b, cfg, max_len),
        prefill_chunked=lambda p, b, max_len=None, chunk=64, **kw: transformer.prefill_chunked(
            p, b, cfg, max_len, chunk=chunk, **kw
        ),
        decode_step=lambda p, t, c, pos, page_table=None: transformer.decode_step(
            p, t, c, pos, cfg, page_table=page_table
        ),
        fused_step=lambda p, t, c, pos, qlens, page_table=None: transformer.fused_step(
            p, t, c, pos, qlens, cfg, page_table=page_table
        ),
        init_cache=lambda b, s, device=None: transformer.init_cache(cfg, b, s, device),
        init_paged_cache=lambda num_pages, page_tokens, b=1, device=None: (
            transformer.init_paged_cache(cfg, b, num_pages, page_tokens, device)
        ),
    )


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------


def cross_entropy_loss(
    logits: torch.Tensor,          # [B, S, V]
    labels: torch.Tensor,          # [B, S] int; −1 = ignore
    *,
    aux_loss=0.0,
    aux_weight: float = 0.01,
    z_loss: float = 1e-4,
) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels that are not −1, in
    fp32, plus the z-loss ``z_loss · mean(lse²)`` (PaLM-style, stabilizes
    the softmax normalizer) and ``aux_weight · aux_loss``.  DTensor logits
    (a mesh) take the vocab-parallel sums of
    :func:`~repro_torch.parallel.vocab.cross_entropy_parts`."""
    if is_dtensor(logits):
        total_nll, total_lse2, count = cross_entropy_parts(logits, labels)
        denom = count.clamp_min(1.0)
        return total_nll / denom + z_loss * total_lse2 / denom + aux_weight * aux_loss
    logits = logits.float()
    labels = torch.as_tensor(labels).to(device=logits.device, dtype=torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    nll = lse - gold
    mask = (labels >= 0).to(torch.float32)
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    loss = loss + z_loss * ((lse * mask) ** 2).sum() / denom
    return loss + aux_weight * aux_loss


# --------------------------------------------------------------------------
# parameter accounting
# --------------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    """Elements in a param tree (nested dicts and lists of tensors)."""
    return int(sum(x.numel() for x in _leaves(params) if isinstance(x, torch.Tensor)))


def param_count_shape(cfg: ModelConfig) -> int:
    """Parameter count from shapes only (params made on the meta device —
    no allocation, nothing drawn)."""
    model = build_model(cfg)
    tree = model.init(torch.Generator(), "meta")
    return sum(math.prod(x.shape) for x in _leaves(tree))


def active_param_count(cfg: ModelConfig) -> int:
    """MoE: parameters touched per token (for MODEL_FLOPS = 6·N_active·D)."""
    total = param_count_shape(cfg)
    if not cfg.n_experts:
        return total
    e_pad = cfg.n_experts_padded or cfg.n_experts
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    routed_total = e_pad * per_expert * cfg.n_layers
    routed_active = cfg.top_k * per_expert * cfg.n_layers
    return total - routed_total + routed_active
