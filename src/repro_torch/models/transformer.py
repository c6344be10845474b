"""Decoder-only transformer stack of the port: the dense family
(llama3.2-1b, qwen3-14b with qk-norm, gemma-7b with GeGLU and head 256,
gemma2-27b with local/global windows, softcaps and post-norms), with a
dense KV cache and the entry points the serving path calls: ``prefill``,
``prefill_chunked``, ``decode_step`` and ``fused_step``.

Parameters hold one dict per layer (``params["layers"]`` is a list), the
serving layout, whatever ``cfg.scan_layers`` says; ``remat`` is a training
knob and is ignored.  The KV cache is ``{"layers": {"k", "v"}}`` with one
``[L, B, max_len, KV, hd]`` tensor each, updated in place.  MoE, SSM,
hybrid, VLM and enc-dec families raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from .layers import Params, uses_kernels, mlp, multihead_attention, rmsnorm, softcap

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _TORCH_DTYPES[cfg.dtype]


def check_family(cfg: ModelConfig) -> None:
    """Raise for the families this slice of the port does not serve."""
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: only dense "
            "decoders are (ROADMAP A9-A11)"
        )


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer attention window.  gemma2 alternates Local/Global; global
    layers get a huge window (≡ full attention)."""
    big = 1 << 30
    if cfg.sliding_window is None:
        return [big] * cfg.n_layers
    pattern = cfg.local_global_pattern or "LG"
    return [
        cfg.sliding_window if pattern[i % len(pattern)] == "L" else big
        for i in range(cfg.n_layers)
    ]


def block_apply(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    window: int,
    kv_cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos=None,
    q_lens: Optional[torch.Tensor] = None,   # [B] fused-batch valid rows
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One transformer block; returns (x, new_cache)."""
    kernels = uses_kernels(cfg)
    h = rmsnorm(x, p["ln_attn"], kernel=kernels)
    attn_out, new_cache = multihead_attention(
        p["attn"], h, cfg,
        positions=positions,
        kv_cache=kv_cache,
        cache_pos=cache_pos,
        layer_window=window,
        q_lens=q_lens,
    )
    if cfg.post_block_norm:
        attn_out = rmsnorm(attn_out, p["ln_attn_post"], kernel=kernels)
    x = x + attn_out

    h = rmsnorm(x, p["ln_mlp"], kernel=kernels)
    ff_out = mlp(p["mlp"], h, cfg.activation)
    if cfg.post_block_norm:
        ff_out = rmsnorm(ff_out, p["ln_mlp_post"], kernel=kernels)
    return x + ff_out, new_cache


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Params:
    """Dense KV cache, zeros, on ``device`` (default: the first card)."""
    check_family(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = torch_dtype(cfg)
    return {
        "layers": {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
        }
    }


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------


def _embed_in(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Token embedding + positions."""
    if cfg.frontend != "none":
        raise NotImplementedError(f"frontend {cfg.frontend!r} is not ported yet")
    embed = params["embed"]
    tokens = batch["tokens"].to(device=embed.device, dtype=torch.int64)
    x = embed[tokens]
    b, s = tokens.shape
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    return x, positions


def _logits_out(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, params["ln_final"], kernel=uses_kernels(cfg))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(x @ head, cfg.logit_softcap)


def _dense_stack(params, x, cfg, positions, caches, cache_pos, q_lens=None):
    """Loop over transformer layers; returns (x, caches)."""
    windows = _layer_windows(cfg)
    for i, layer_p in enumerate(params["layers"]):
        cache_i = (
            {"k": caches["layers"]["k"][i], "v": caches["layers"]["v"][i]}
            if caches
            else None
        )
        x, _ = block_apply(
            layer_p, x, cfg,
            positions=positions, window=windows[i],
            kv_cache=cache_i, cache_pos=cache_pos, q_lens=q_lens,
        )
    # the per-layer caches are views of the stacked tensors, written in place
    return x, caches


def forward(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    caches: Optional[Params] = None,
    cache_pos=None,
    q_lens: Optional[torch.Tensor] = None,
    page_table=None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (logits [B,S,V], caches)."""
    check_family(cfg)
    if page_table is not None:
        raise NotImplementedError("paged KV is not ported yet (ROADMAP A0, the next slice)")
    x, positions = _embed_in(params, batch, cfg)
    if cache_pos is not None:
        # a [B] cache_pos carries one depth per row (ragged batches): each
        # row's positions, causal mask and KV write index follow it
        cp = torch.as_tensor(cache_pos).to(device=x.device, dtype=torch.int32)
        if cp.ndim == 0:
            positions = positions + cp
        else:
            positions = positions + cp[:, None]
        cache_pos = cp
    if q_lens is not None:
        q_lens = torch.as_tensor(q_lens).to(device=x.device, dtype=torch.int32)
    x, new_caches = _dense_stack(params, x, cfg, positions, caches, cache_pos, q_lens)
    return _logits_out(params, x, cfg), new_caches


def prefill(params, batch, cfg: ModelConfig, max_len: Optional[int] = None):
    """Run the prompt, return (last_logits, caches)."""
    b, s = batch["tokens"].shape
    max_len = max_len or s
    caches = init_cache(cfg, b, max_len, device=params["embed"].device)
    logits, caches = forward(
        params, batch, cfg, caches=caches, cache_pos=torch.zeros((), dtype=torch.int32)
    )
    return logits[:, -1], caches


def prefill_chunked(
    params,
    batch,
    cfg: ModelConfig,
    max_len: Optional[int] = None,
    *,
    chunk: int = 64,
    caches: Optional[Params] = None,
    start: int = 0,
):
    """Chunked prefill: the prompt in ``chunk``-token pieces, each written at
    its absolute offset — greedy-token-identical to :func:`prefill`."""
    b, s = batch["tokens"].shape
    if chunk <= 0:
        raise ValueError(f"chunk must be > 0, got {chunk}")
    if not 0 <= start < s:
        raise ValueError(f"start must be in [0, {s}), got {start}")
    max_len = max_len or s
    if caches is None:
        caches = init_cache(cfg, b, max_len, device=params["embed"].device)
    logits = None
    off = start
    while off < s:
        n = min(chunk, s - off)
        sub = dict(batch, tokens=batch["tokens"][:, off : off + n])
        logits, caches = forward(
            params, sub, cfg, caches=caches,
            cache_pos=torch.tensor(off, dtype=torch.int32),
        )
        off += n
    return logits[:, -1], caches


def decode_step(params, token_batch, caches, cache_pos, cfg: ModelConfig, *, page_table=None):
    """One-token step: tokens [B,1]; ``cache_pos`` is a scalar or a ``(B,)``
    int32 vector (ragged batch)."""
    logits, new_caches = forward(
        params, token_batch, cfg, caches=caches, cache_pos=cache_pos,
        page_table=page_table,
    )
    return logits[:, -1], new_caches


def fused_step(
    params, token_batch, caches, cache_pos, q_lens, cfg: ModelConfig, *, page_table=None,
):
    """One FUSED mixed prefill/decode step: tokens [B, S] where row b's first
    ``q_lens[b]`` tokens are valid — decode rows 1, prefill chunks up to S,
    idle rows 0.  Rows write KV only over their valid span.  Returns the
    FULL logits [B, S, V] and the caches."""
    return forward(
        params, token_batch, cfg, caches=caches,
        cache_pos=torch.as_tensor(cache_pos, dtype=torch.int32),
        q_lens=torch.as_tensor(q_lens, dtype=torch.int32),
        page_table=page_table,
    )
