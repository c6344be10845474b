"""Encoder–decoder backbone of the port for seamless-m4t-large-v2 (the audio
family), the reference's ``repro.models.encdec`` in PyTorch.

As in the reference, the speech frontend is a stub: the batch carries
precomputed frame embeddings ``batch["frames"]`` ``[B, S_enc, d_model]``.
The encoder is a non-causal self-attention stack; the decoder is causal,
with cross-attention over the encoder memory.  At prefill each decoder
layer's cross K/V are computed once from the memory and cached.

Caches keep the reference's layout, ``{"self": {"k", "v"}, "cross": {"k",
"v"}}`` with ``[L, B, S, KV, hd]`` tensors; a paged self-attention cache
holds page pools ``[L, num_pages + 1, P, KV, hd]`` instead (the page table
rides into each call as ``page_table``), while the cross K/V stay dense:
encoder-length, written once, never grown.  Unlike the reference, the
self-attention cache is written in place.  Parameters hold one dict per
layer under ``"encoder"`` and ``"decoder"``; ``scan_layers`` is ignored,
and ``remat`` applies to the training forward only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.parallel.context import is_dtensor, shard_hint
from repro_torch.parallel.sharding import cache_on_mesh
from repro_torch.parallel.vocab import embed_lookup
from .layers import Params, mlp, multihead_attention, rmsnorm, uses_kernels
from .transformer import check_trainable, remat as remat_fn, torch_dtype


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _enc_block(layer_p, x, cfg, positions):
    kernels = uses_kernels(cfg)
    h = rmsnorm(x, layer_p["ln_attn"], kernel=kernels)
    out, _ = multihead_attention(layer_p["attn"], h, cfg, positions=positions, causal=False)
    x = x + out
    h = rmsnorm(x, layer_p["ln_mlp"], kernel=kernels)
    return x + mlp(layer_p["mlp"], h, cfg.activation)


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig, *, remat: bool = False
           ) -> torch.Tensor:
    """frames ``[B, S_enc, D]`` (the stub frontend's output) → memory
    ``[B, S_enc, D]``, on the parameters' device in ``cfg.dtype``.
    ``remat``: recompute each block in the backward pass (training)."""
    x = shard_hint(frames.to(device=params["embed"].device, dtype=torch_dtype(cfg)),
                   "batch", None, "embed")
    b, s = x.shape[:2]
    positions = _positions(b, s, x.device)
    block = remat_fn(_enc_block, remat)
    for layer_p in params["encoder"]:
        x = block(layer_p, x, cfg, positions)
    return rmsnorm(x, params["ln_enc_final"], kernel=uses_kernels(cfg))


def _cross_kv(layer_p, memory, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    hd = cfg.resolved_head_dim
    b, s = memory.shape[:2]
    k = (memory @ layer_p["cross_attn"]["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (memory @ layer_p["cross_attn"]["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    return k, v


def cross_kv_cache(params: Params, memory: torch.Tensor, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Every decoder layer's cross K/V of ``memory``, stacked ``[L, B, S_enc,
    KV, hd]``."""
    kvs = [_cross_kv(lp, memory, cfg) for lp in params["decoder"]]
    return {"k": torch.stack([k for k, _ in kvs]), "v": torch.stack([v for _, v in kvs])}


def _dec_block(layer_p, x, cfg, positions, memory_kv, self_cache, cache_pos,
               q_lens=None, page_table=None):
    kernels = uses_kernels(cfg)
    # paged self-attention: the layer's page pools and the one shared
    # [B, pages_per_slot] table (cross K/V stay dense)
    if self_cache is not None and page_table is not None:
        self_cache = dict(self_cache, table=page_table)
    h = rmsnorm(x, layer_p["ln_self"], kernel=kernels)
    out, _ = multihead_attention(
        layer_p["self_attn"], h, cfg,
        positions=positions, kv_cache=self_cache, cache_pos=cache_pos, q_lens=q_lens,
    )
    x = x + out
    h = rmsnorm(x, layer_p["ln_cross"], kernel=kernels)
    # cross-attention sees the whole encoder memory whatever the row's
    # length; q_lens only zeroes the padding query rows
    out, _ = multihead_attention(
        layer_p["cross_attn"], h, cfg, positions=positions, cross_kv=memory_kv, q_lens=q_lens,
    )
    x = x + out
    h = rmsnorm(x, layer_p["ln_mlp"], kernel=kernels)
    return x + mlp(layer_p["mlp"], h, cfg.activation)


def _dec_block_from_memory(layer_p, x, cfg, positions, memory):
    return _dec_block(layer_p, x, cfg, positions, _cross_kv(layer_p, memory, cfg), None, None)


def decode_stack(params, tokens, cfg, memory=None, cross_cache=None, self_cache=None,
                 cache_pos=None, q_lens=None, page_table=None, *, remat: bool = False):
    """The decoder over ``tokens`` ``[B, S]``: cross K/V from
    ``cross_cache`` (or computed from ``memory``), the self-attention cache
    written in place at ``cache_pos`` (a scalar, or ``[B]`` per-row depths).
    Returns (logits ``[B, S, V]``, the self cache).  ``remat`` (training,
    no cache): recompute each block, cross K/V included, in the backward
    pass."""
    embed = params["embed"]
    if is_dtensor(embed):
        x = embed_lookup(embed, tokens)
    else:
        x = embed[tokens.to(device=embed.device, dtype=torch.int64)]
    x = shard_hint(x, "batch", None, "embed")
    b, s = tokens.shape
    positions = _positions(b, s, x.device)
    if cache_pos is not None:
        # a scalar: one depth for every row; a [B] vector: each row offsets,
        # masks and writes its KV at its own depth
        cp = torch.as_tensor(cache_pos).to(device=x.device, dtype=torch.int32)
        positions = positions + (cp if cp.ndim == 0 else cp[:, None])
        cache_pos = cp
    if q_lens is not None:
        q_lens = torch.as_tensor(q_lens).to(device=x.device, dtype=torch.int32)
    if page_table is not None:
        page_table = torch.as_tensor(page_table).to(device=x.device, dtype=torch.int32)
    for i, layer_p in enumerate(params["decoder"]):
        if remat:
            x = remat_fn(_dec_block_from_memory, True)(layer_p, x, cfg, positions, memory)
            continue
        if cross_cache is not None:
            kv = (cross_cache["k"][i], cross_cache["v"][i])
        else:
            kv = _cross_kv(layer_p, memory, cfg)
        sc = (
            {"k": self_cache["k"][i], "v": self_cache["v"][i]}
            if self_cache is not None
            else None
        )
        x = _dec_block(layer_p, x, cfg, positions, kv, sc, cache_pos, q_lens, page_table)
    x = rmsnorm(x, params["ln_final"], kernel=uses_kernels(cfg))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    # the per-layer self caches are views of the stacked tensors, written in place
    return shard_hint(x @ head, "batch", None, "vocab"), self_cache


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def train_forward(params, batch, cfg: ModelConfig):
    """The training forward: encode ``batch["frames"]``, then the decoder
    over ``batch["tokens"]`` with no cache; returns (logits, aux loss 0)."""
    check_trainable(cfg)
    memory = encode(params, batch["frames"], cfg, remat=cfg.remat)
    logits, _ = decode_stack(params, batch["tokens"], cfg, memory=memory, remat=cfg.remat)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_self_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Dense decoder self-attention cache, zeros, ``[L, B, max_len, KV, hd]``
    on ``device`` (default: the first card); under a parallel context on a
    real mesh, DTensors laid out by ``cache_pspec_tree``."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = torch_dtype(cfg)
    meta = {"k": torch.empty(shape, dtype=dt, device="meta"),
            "v": torch.empty(shape, dtype=dt, device="meta")}
    on_mesh = cache_on_mesh(cfg, meta, batch, max_len)
    if on_mesh is not None:
        return on_mesh
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_paged_self_cache(cfg: ModelConfig, num_pages: int, page_tokens: int, device=None):
    """Paged decoder self-attention cache: per-layer page pools ``[L,
    num_pages + 1, P, KV, hd]`` (the last page is the trash page); the page
    table is passed per call."""
    shape = (cfg.n_layers, num_pages + 1, page_tokens, cfg.n_kv_heads, cfg.resolved_head_dim)
    device = resolve_device(device)
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def prefill(params, batch, cfg: ModelConfig, max_len: Optional[int] = None):
    """Encode, then the teacher-forced decoder prompt; returns
    (last_logits, caches)."""
    cross_cache = cross_kv_cache(params, encode(params, batch["frames"], cfg), cfg)
    b, s = batch["tokens"].shape
    self_cache = init_self_cache(cfg, b, max_len or s, device=params["embed"].device)
    logits, self_cache = decode_stack(
        params, batch["tokens"], cfg, cross_cache=cross_cache, self_cache=self_cache,
        cache_pos=torch.zeros((), dtype=torch.int32),
    )
    return logits[:, -1], {"self": self_cache, "cross": cross_cache}


def prefill_chunked(
    params,
    batch,
    cfg: ModelConfig,
    max_len: Optional[int] = None,
    *,
    chunk: int = 64,
    self_cache=None,
    page_table=None,
    start: int = 0,
):
    """Chunked decoder prefill: the encoder runs once (cross K/V cached as
    in :func:`prefill`), then the decoder prompt is teacher-forced in
    ``chunk``-token pieces, the self-attention cache carried across them —
    greedy-token-identical to the whole-prompt pass.

    ``self_cache``/``page_table`` continue an existing (possibly paged)
    self-attention cache; ``start`` skips prompt tokens whose KV the mapped
    pages already hold (prefix reuse)."""
    if chunk <= 0:
        raise ValueError(f"chunk must be > 0, got {chunk}")
    cross_cache = cross_kv_cache(params, encode(params, batch["frames"], cfg), cfg)
    b, s = batch["tokens"].shape
    if not 0 <= start < s:
        raise ValueError(f"start must be in [0, {s}), got {start}")
    if self_cache is None:
        self_cache = init_self_cache(cfg, b, max_len or s, device=params["embed"].device)
    logits = None
    off = start
    while off < s:
        n = min(chunk, s - off)
        logits, self_cache = decode_stack(
            params, batch["tokens"][:, off : off + n], cfg,
            cross_cache=cross_cache, self_cache=self_cache,
            cache_pos=torch.tensor(off, dtype=torch.int32), page_table=page_table,
        )
        off += n
    return logits[:, -1], {"self": self_cache, "cross": cross_cache}


def decode_step(params, token_batch, caches, cache_pos, cfg: ModelConfig, *, page_table=None):
    """One-token decoder step; ``cache_pos`` is a scalar or a ``(B,)`` int32
    vector (ragged batch: per-row self-attention depth)."""
    logits, self_cache = decode_stack(
        params, token_batch["tokens"], cfg,
        cross_cache=caches["cross"], self_cache=caches["self"],
        cache_pos=cache_pos, page_table=page_table,
    )
    return logits[:, -1], {"self": self_cache, "cross": caches["cross"]}


def fused_step(params, token_batch, caches, cache_pos, q_lens, cfg: ModelConfig, *,
               page_table=None):
    """One fused mixed prefill/decode decoder step (as
    :func:`repro_torch.models.transformer.fused_step`): tokens ``[B, S]``
    with per-row ``(cache_pos, q_lens)``; returns the full logits ``[B, S,
    V]`` and the caches."""
    logits, self_cache = decode_stack(
        params, token_batch["tokens"], cfg,
        cross_cache=caches["cross"], self_cache=caches["self"],
        cache_pos=torch.as_tensor(cache_pos, dtype=torch.int32),
        q_lens=torch.as_tensor(q_lens, dtype=torch.int32),
        page_table=page_table,
    )
    return logits, {"self": self_cache, "cross": caches["cross"]}
