"""Model façade: ``build_model(cfg)`` returns a ``Model`` with uniform entry
points, so callers never branch on family.  Every family of the reference
is ported: dense, MoE, VLM, SSM and hybrid on
:mod:`repro_torch.models.transformer`, enc-dec on
:mod:`repro_torch.models.encdec`.  As in the reference, the SSM, hybrid,
enc-dec and VLM families are served through these entry points only: the
stage executor and the engine serve decoder-only attention blocks on
token inputs."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

from repro_torch.configs.base import ModelConfig
from . import encdec, transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    # (generator, device=None) -> params at the reference's init
    # distributions, on the first card unless device says otherwise
    init: Callable[..., Any]
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
