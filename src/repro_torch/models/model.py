"""Model façade: ``build_model(cfg)`` returns a ``Model`` with uniform entry
points, so the engine never branches on family.  Only the dense family is
ported; the others raise ``NotImplementedError`` here."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

from repro_torch.configs.base import ModelConfig
from . import transformer


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


def build_model(cfg: ModelConfig) -> Model:
    from repro_torch.convert import init_params

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
    )
