"""Shared layers of the port (PyTorch, plain functions on tensors).

Parameters are nested dicts of tensors, and weights keep the reference's
``x @ w`` orientation (``[d_in, d_out]``).  Attention supports GQA, causal
and sliding-window masking, soft-capping (gemma2), qk-norm (qwen3) and RoPE,
and three implementations:

* ``naive``   — materializes the score matrix (oracle / small tests),
* ``chunked`` — a loop over KV blocks with online softmax (the flash
  algorithm in plain PyTorch),
* ``pallas``  — the port's hand-written CUDA kernels
  (:mod:`repro_torch.kernels`); on a CPU tensor they run their plain
  versions.  The name is the reference's, so one config selects the kernel
  path in both packages.

All three take **ragged batches**: a ``(B,)`` ``cache_pos`` gives every row
its own KV write index and causal mask, and ``q_lens`` gives each row its
number of valid query rows (the fused mixed prefill/decode batch).

Unlike the reference, the dense KV cache is written **in place**: the
returned cache holds the same tensors that were passed in.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import rmsnorm as rms_kernel

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rmsnorm(
    x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *, kernel: bool = False
) -> torch.Tensor:
    """Offset-form RMSNorm ``x·rsqrt(mean(x²)+eps)·(1+w)`` in fp32, cast
    back.  ``kernel=True`` goes through the CUDA kernel's wrapper (which
    runs the same plain math on a CPU tensor)."""
    if kernel:
        return rms_kernel.rmsnorm(x, w, eps)
    return rms_kernel.rmsnorm_plain(x, w, eps)


def uses_kernels(cfg: ModelConfig) -> bool:
    """``attention_impl="pallas"`` runs attention AND every RMSNorm through
    the port's CUDA kernels; the other impls are plain PyTorch."""
    return cfg.attention_impl == "pallas"


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (int).  Split-halves rotation in
    fp32, cast back."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                        # [D/2]
    angles = positions[..., None].to(torch.float32) * freqs      # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# --------------------------------------------------------------------------
# attention (plain versions)
# --------------------------------------------------------------------------


def _chunked_attention(q, k, v, q_pos, k_pos, *, causal, window, cap, scale, chunk):
    """Online-softmax attention over KV chunks (the flash algorithm).

    q: [B,Sq,G,R,D] (GQA-grouped), k/v: [B,Sk,G,D]."""
    b, sq, g, r, d = q.shape
    sk = k.shape[1]
    qf = q.float()
    m = torch.full((b, g, r, sq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, g, r, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, g, r, sq, d), dtype=torch.float32, device=q.device)
    for lo in range(0, sk, chunk):
        kb = k[:, lo : lo + chunk].float()
        vb = v[:, lo : lo + chunk].float()
        pb = k_pos[lo : lo + chunk]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kb) * scale
        s = softcap(s, cap)
        mask = fa_kernel.bcast_mask(fa_kernel.attn_mask(q_pos, pb, causal, window))
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", pexp, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def _write_kv(cache: torch.Tensor, new: torch.Tensor, cache_pos, q_lens) -> None:
    """Write ``new [B, Sq, KV, D]`` into ``cache [B, Smax, KV, D]`` in place.

    * ``q_lens`` given (fused mixed batch): row b writes ``new[b, :q_lens[b]]``
      at ``cache_pos[b]`` and NOTHING else — a clamped slice write would slide
      a short row near ``Smax`` backwards and corrupt valid KV.  Every entry
      of the scatter gets a distinct in-row index: tokens past ``Smax`` are
      folded below ``cache_pos`` and, like every other masked token, write
      back the value already there.
    * otherwise: the reference's ``dynamic_update_slice`` semantics, per row
      (start clamped to ``[0, Smax - Sq]``).
    """
    b, sq = new.shape[0], new.shape[1]
    smax = cache.shape[1]
    if sq > smax:
        raise ValueError(f"{sq} new tokens cannot fit a {smax}-slot cache row")
    dev = cache.device
    cp = torch.as_tensor(cache_pos, device=dev).to(torch.int64).reshape(-1).expand(b)
    ii = torch.arange(sq, device=dev, dtype=torch.int64)[None, :]
    new = new.to(cache.dtype)
    if q_lens is None:
        dest = torch.clamp(cp, 0, smax - sq)[:, None] + ii             # [B, Sq]
        idx = dest[:, :, None, None].expand(-1, -1, *cache.shape[2:])
        cache.scatter_(1, idx, new)
        return
    pos = cp[:, None] + ii                                              # [B, Sq]
    ql = q_lens.to(device=dev, dtype=torch.int64)[:, None]
    valid = (ii < ql) & (pos < smax)
    dest = torch.where(pos < smax, pos, pos - sq)
    # a row parked at or past the end writes nothing: any distinct slots do
    dest = torch.where(cp[:, None] < smax, dest, ii.expand(b, -1))
    idx = dest[:, :, None, None].expand(-1, -1, *cache.shape[2:])
    old = torch.gather(cache, 1, idx)
    cache.scatter_(1, idx, torch.where(valid[:, :, None, None], new, old))


def multihead_attention(
    p: Params,
    x: torch.Tensor,                  # [B, Sq, D_model]
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,          # [B, Sq]
    kv_cache: Optional[Dict[str, torch.Tensor]] = None,  # {"k","v": [B,Smax,KV,hd]}
    cache_pos=None,                   # scalar, or [B] per-row (#valid cache entries)
    layer_window: Optional[int] = None,
    causal: Optional[bool] = None,
    q_lens: Optional[torch.Tensor] = None,  # [B] valid query rows per batch row
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA self-attention with RoPE.  Three cache paths: none; dense KV at a
    scalar ``cache_pos``; dense ragged KV with a ``[B]`` ``cache_pos`` and
    optional ``q_lens``.  The KV cache is updated in place.  Query rows at
    or beyond a row's ``q_len`` come out as exact zeros from every impl."""
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP A11, VLM slice)")
    if kv_cache is not None and "table" in kv_cache:
        raise NotImplementedError(
            "paged KV is not ported yet (ROADMAP A0: the next slice, kernel B2)"
        )
    hd = cfg.resolved_head_dim
    b, sq, _ = x.shape
    kernels = uses_kernels(cfg)
    ragged = isinstance(cache_pos, torch.Tensor) and cache_pos.ndim > 0
    q = (x @ p["wq"]).reshape(b, sq, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(b, sq, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, sq, cfg.n_kv_heads, hd)

    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], kernel=kernels)
        k = rmsnorm(k, p["k_norm"], kernel=kernels)

    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q_pos = positions if ragged else positions[0]

    new_cache = None
    if kv_cache is not None:
        kcache, vcache = kv_cache["k"], kv_cache["v"]
        cp = cache_pos if cache_pos is not None else 0
        _write_kv(kcache, k, cp, q_lens if ragged else None)
        _write_kv(vcache, v, cp, q_lens if ragged else None)
        new_cache = {"k": kcache, "v": vcache}
        k, v = kcache, vcache
        k_pos1d = torch.arange(k.shape[1], device=x.device)
        # the causal test against q_pos also masks unwritten cache slots
        causal = True
    else:
        k_pos1d = q_pos if q_pos.ndim == 1 else torch.arange(k.shape[1], device=x.device)
        if causal is None:
            causal = True

    g = k.shape[2]
    n_rep = cfg.n_heads // g
    scale = cfg.attn_logit_scale if cfg.attn_logit_scale is not None else 1.0 / math.sqrt(hd)
    window = layer_window
    if window is not None and window <= 0:
        window = None
    impl = cfg.attention_impl
    if impl == "pallas":
        if q_pos.ndim == 2:
            offs = q_pos[:, 0]
        else:
            offs = q_pos[0].expand(b)
        out = fa_kernel.flash_attention(
            q.contiguous(), k, v,
            offs.to(torch.int32).contiguous(),
            None if q_lens is None else q_lens.to(device=x.device, dtype=torch.int32).contiguous(),
            scale=scale, causal=causal, window=window, softcap=cfg.attn_softcap,
        )
    elif impl == "chunked" and k.shape[1] > cfg.attn_chunk and sq > 1:
        qg = q.reshape(b, sq, g, n_rep, hd)
        out = _chunked_attention(
            qg, k, v, q_pos, k_pos1d,
            causal=causal, window=window, cap=cfg.attn_softcap, scale=scale,
            chunk=cfg.attn_chunk,
        )
    else:
        qg = q.reshape(b, sq, g, n_rep, hd)
        out = fa_kernel.masked_attention(
            qg, k, v, fa_kernel.attn_mask(q_pos, k_pos1d, causal, window),
            scale=scale, cap=cfg.attn_softcap,
        ).to(x.dtype)

    out = out.reshape(b, sq, cfg.n_heads * hd)
    if q_lens is not None:
        # fused-batch padding contract: query rows beyond a row's q_len emit
        # exact zeros from EVERY impl (the kernel zeroes them itself;
        # naive/chunked would leak a uniform softmax)
        keep = torch.arange(sq, device=x.device)[None, :, None] < q_lens.to(x.device)[:, None, None]
        out = torch.where(keep, out, torch.zeros_like(out))
    out = out @ p["wo"]
    return out, new_cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------


def mlp(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    if activation == "silu":
        h = F.silu(gate) * up
    elif activation in ("geglu", "gelu"):
        h = F.gelu(gate, approximate="tanh") * up
    else:
        raise ValueError(activation)
    return h @ p["w_down"]
