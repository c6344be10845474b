"""Shared layers of the port (PyTorch, plain functions on tensors).

Parameters are nested dicts of tensors, and weights keep the reference's
``x @ w`` orientation (``[d_in, d_out]``).  Attention supports GQA, causal
and sliding-window masking, soft-capping (gemma2), qk-norm (qwen3), RoPE and
M-RoPE (qwen2-vl), enc-dec cross-attention (seamless), and three
implementations:

* ``naive``   — materializes the score matrix (oracle / small tests),
* ``chunked`` — a loop over KV blocks with online softmax (the flash
  algorithm in plain PyTorch),
* ``pallas``  — the port's hand-written CUDA kernels
  (:mod:`repro_torch.kernels`); on a CPU tensor they run their plain
  versions.  The name is the reference's, so one config selects the kernel
  path in both packages.

All three take **ragged batches**: a ``(B,)`` ``cache_pos`` gives every row
its own KV write index and causal mask, and ``q_lens`` gives each row its
number of valid query rows (the fused mixed prefill/decode batch), and a
**paged** cache (page pools plus a page table, ``"table" in kv_cache``).

Unlike the reference, the KV cache — dense rows and page pools alike — is
written **in place**: the returned cache holds the same tensors that were
passed in.

On a mesh (DTensor activations under a parallel context) the projections
and the MLP are DTensor products steered by the reference's shard hints,
and RoPE with the plain core runs on each rank's batch rows and heads
(its local shards); a dense KV cache on the mesh is written and read the same
way, each rank on its slice of it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import rmsnorm as rms_kernel
from repro_torch.parallel.context import grad_as, is_dtensor, like_batch, shard_hint

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rmsnorm(
    x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *, kernel: bool = False
) -> torch.Tensor:
    """Offset-form RMSNorm ``x·rsqrt(mean(x²)+eps)·(1+w)`` in fp32, cast
    back.  ``kernel=True`` goes through the CUDA kernel's wrapper (which
    runs the same plain math on a CPU tensor), on a DTensor on each rank's
    rows."""
    if kernel and is_dtensor(x):
        # on a mesh: the kernel on each rank's rows, whole along the norm
        if any(p.is_shard(x.ndim - 1) for p in x.placements):
            raise NotImplementedError("the RMSNorm kernel takes rows whole on each rank")
        w = w.full_tensor() if is_dtensor(w) else w
        return _on_shards(lambda xl: rms_kernel.rmsnorm(xl, w, eps), (x,), like=x)
    if kernel:
        return rms_kernel.rmsnorm(x, w, eps)
    return rms_kernel.rmsnorm_plain(x, w, eps)


def uses_kernels(cfg: ModelConfig) -> bool:
    """``attention_impl="pallas"`` runs attention, every RMSNorm, the MoE
    experts' grouped GEMMs and the Mamba2 SSD scans through the port's
    CUDA kernels; the other impls are plain PyTorch."""
    return cfg.attention_impl == "pallas"


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Split-halves rotation of x [B, S, H, D] by angles [B, S, D/2], in
    fp32, cast back."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (int).  Split-halves rotation in
    fp32, cast back."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)               # [D/2]
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(
    x: torch.Tensor,
    positions: torch.Tensor,           # [3, B, S] — (t, h, w) position streams
    theta: float,
    sections: Tuple[int, int, int],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the D/2 frequency slots are split into
    (t, h, w) sections, each rotated by its own position stream."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to head_dim/2 = {d // 2}")
    freqs = rope_freqs(d, theta, x.device)                        # [D/2]
    # per-slot positions [B, S, D/2]: slot j takes the stream of its section
    pos_slots = torch.cat(
        [positions[i][..., None].to(torch.float32).expand(*positions.shape[1:], sec)
         for i, sec in enumerate(sections)],
        dim=-1,
    )
    return _rotate(x, pos_slots * freqs)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# --------------------------------------------------------------------------
# attention (plain versions)
# --------------------------------------------------------------------------


def _chunked_attention(q, k, v, q_pos, k_pos, *, causal, window, cap, scale, chunk,
                       with_lse=False):
    """Online-softmax attention over KV chunks (the flash algorithm).

    q: [B,Sq,G,R,D] (GQA-grouped), k/v: [B,Sk,G,D].  ``with_lse``: also
    each row's log-sum-exp of its scores, ``[B, Sq, G, R]`` fp32."""
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
    out = out.permute(0, 3, 1, 2, 4).to(q.dtype)
    if with_lse:
        return out, (m + torch.log(torch.clamp(l, min=1e-30))).permute(0, 3, 1, 2)
    return out


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


def _paged_update(pool_k, pool_v, table, k, v, cache_pos, q_lens) -> None:
    """Scatter this call's new K/V ``[B, Sq, KV, D]`` into the page pools
    ``[num_pages + 1, P, KV, D]`` through ``table`` ``[B, pages_per_slot]``.

    Token ``i`` of row ``b`` lands at flat pool row
    ``table[b, pos // P] * P + pos % P`` with ``pos = cache_pos[b] + i``.
    Tokens outside their row's valid span (``i >= q_lens[b]``), past the
    slot's logical length (``pos >= pages_per_slot · P``) or on an unmapped
    entry go to the trash page (the pool's last), so the scatter can never
    corrupt a real page.  Unlike the reference's functional ``.at[].set``,
    the pools are written in place, with one ``index_copy_`` on each flat
    view.  Valid tokens have distinct destinations; duplicate indices occur
    only inside the trash page, where which copy wins does not matter: no
    query ever sees the trash page.
    """
    b, sq = k.shape[0], k.shape[1]
    np1, page_tokens = pool_k.shape[0], pool_k.shape[1]
    pages_per_slot = table.shape[1]
    dev = pool_k.device
    cp = torch.as_tensor(cache_pos, device=dev).to(torch.int64).reshape(-1).expand(b)
    ql = (
        torch.full((b,), sq, dtype=torch.int64, device=dev)
        if q_lens is None
        else q_lens.to(device=dev, dtype=torch.int64)
    )
    ii = torch.arange(sq, device=dev, dtype=torch.int64)[None, :]
    pos = cp[:, None] + ii                                              # [B, Sq]
    valid = (ii < ql[:, None]) & (pos < pages_per_slot * page_tokens)
    pidx = torch.clamp(pos // page_tokens, 0, pages_per_slot - 1)
    page = torch.gather(table.to(device=dev, dtype=torch.int64), 1, pidx)
    page = torch.where(valid & (page >= 0), page, torch.full_like(page, np1 - 1))
    dest = (page * page_tokens + pos % page_tokens).reshape(-1)
    for pool, new in ((pool_k, k), (pool_v, v)):
        flat = pool.view((np1 * page_tokens,) + tuple(pool.shape[2:]))
        flat.index_copy_(0, dest, new.to(pool.dtype).reshape((b * sq,) + tuple(pool.shape[2:])))


# the naive/chunked read path of a paged cache: the logical [B, L, KV, D]
# view gathered out of the pool (the kernel's plain version uses the same
# gather; the kernel itself reads through the table and never builds it)
_paged_view = fa_kernel.paged_view


def _rope_qk(q, k, positions, cfg: ModelConfig, ragged: bool):
    """RoPE (M-RoPE when ``cfg.mrope_sections`` is set) on q and k; returns
    them with ``q_pos``: ``[Sq]`` shared across rows, or ``[B, Sq]`` per row
    (ragged: positions already carry each row's cache_pos).  M-RoPE masks
    follow the temporal stream."""
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        return q, k, positions[0] if ragged else positions[0][0]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, positions if ragged else positions[0]


def _plain_core(q, k, v, q_pos, k_pos1d, cfg: ModelConfig, *, causal, window, scale):
    """The ``chunked`` (long keys, several queries) or ``naive`` core on
    q ``[B, Sq, H, D]`` and k/v ``[B, Sk, G, D]``: ``[B, Sq, H, D]``."""
    b, sq, h, hd = q.shape
    g = k.shape[2]
    qg = q.reshape(b, sq, g, h // g, hd)
    if cfg.attention_impl == "chunked" and k.shape[1] > cfg.attn_chunk and sq > 1:
        out = _chunked_attention(
            qg, k, v, q_pos, k_pos1d,
            causal=causal, window=window, cap=cfg.attn_softcap, scale=scale,
            chunk=cfg.attn_chunk,
        )
    else:
        out = fa_kernel.masked_attention(
            qg, k, v, fa_kernel.attn_mask(q_pos, k_pos1d, causal, window),
            scale=scale, cap=cfg.attn_softcap,
        ).to(q.dtype)
    return out.reshape(b, sq, h, hd)


def _attention_on_mesh(q, k, v, positions, cfg: ModelConfig, *, cross, causal, window, scale):
    """Attention of DTensors q ``[B, Sq, H, D]`` and k/v ``[B, Sk, KV, D]``
    (no cache): RoPE and the core (the flash kernel for a kernel config,
    else the plain one) run on each rank's local batch rows and heads
    (:func:`_on_shards`, PyTorch's ``shard_map``), so the masks, built
    from ``arange``, never meet a DTensor.  k and v are laid out like q's
    heads (``kv_heads``), which keeps each rank's query heads beside their
    KV group; that needs the KV head count to divide over the head axis."""
    from torch.distributed.tensor import Partial, Replicate

    kv_of, grads = None, None
    if cfg.n_kv_heads % _head_shards(q) == 0:
        k = shard_hint(k, "batch", None, "kv_heads", None)
        v = shard_hint(v, "batch", None, "kv_heads", None)
    else:
        # fewer KV heads than head shards: every rank of the head axis holds
        # them all and takes those of its own query heads, so its gradient
        # of k and v is partial over that axis (its heads' part)
        whole = [Replicate() if p.is_shard(2) else p for p in q.placements]
        k = k.redistribute(q.device_mesh, whole)
        v = v.redistribute(q.device_mesh, whole)
        h0 = _local_offset(q)[2]
        kv_of = lambda n, dev: (h0 + torch.arange(n, device=dev)) // (cfg.n_heads // cfg.n_kv_heads)  # noqa: E731
        part = [Partial() if p.is_shard(2) else p for p in q.placements]
        grads = (None, part, part, None)
    if not is_dtensor(positions):
        positions = like_batch(positions, q, batch_dim=positions.ndim - 2)
    if causal is None:
        causal = not cross

    def core(q, k, v, positions):
        if kv_of is not None:
            idx = kv_of(q.shape[2], q.device)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        if cross:
            q_pos = positions[0] if positions.ndim == 2 else positions[0][0]
            k_pos1d = torch.arange(k.shape[1], device=q.device)
        else:
            q, k, q_pos = _rope_qk(q, k, positions, cfg, False)
            k_pos1d = q_pos
        if uses_kernels(cfg):
            offs = q_pos[0].expand(q.shape[0]).to(torch.int32).contiguous()
            return fa_kernel.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                             offs, None, scale=scale, causal=causal,
                                             window=window, softcap=cfg.attn_softcap)
        return _plain_core(q, k, v, q_pos, k_pos1d, cfg, causal=causal, window=window,
                           scale=scale)

    return _on_shards(core, (q, k, v, positions), like=q, grads=grads)


def _on_shards(fn, args, *, like, extra=(), grads=None):
    """``fn`` on the local shards of DTensors ``args`` (and the plain
    ``extra``), PyTorch's ``local_map`` with the result laid out and
    shaped like DTensor ``like`` — also where a dim is cut unevenly, which
    ``local_map`` cannot shape.  Gradients flow back to each argument in
    its own layout, or in the layout ``grads`` gives it (one entry an
    argument, ``None`` for its own)."""
    from torch.distributed.tensor import DTensor

    grads = grads or (None,) * len(args)
    out = fn(*(a.to_local(grad_placements=g) for a, g in zip(args, grads)), *extra)
    # the global strides keep the local tensor's order of dims
    stride, step = [0] * out.ndim, 1
    for d in sorted(range(out.ndim), key=out.stride):
        stride[d] = step
        step *= like.shape[d]
    return DTensor.from_local(out, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=tuple(stride))


def _local_offset(x) -> Tuple[int, ...]:
    """Where this rank's shard of DTensor ``x`` starts in the global tensor."""
    from repro_torch.launch.mesh import local_shape_and_offset

    return local_shape_and_offset(x.shape, x.device_mesh, x.placements)[1]


def _write_kv_slice(cache: torch.Tensor, new: torch.Tensor, cache_pos, off: int) -> None:
    """Write ``new [B, Sq, KV, D]`` at global position ``cache_pos`` into
    ``cache [B, L, KV, D]``, a slice of the sequence starting at ``off``:
    only the tokens that fall in it land, in place."""
    sq, length = new.shape[1], cache.shape[1]
    dev = cache.device
    new = new.to(cache.dtype)
    cp = torch.as_tensor(cache_pos, device=dev).to(torch.int64).reshape(())
    if sq == 1:
        at = cp - off
        keep = (at >= 0) & (at < length)
        i = torch.clamp(at, 0, length - 1).reshape(1)
        cache.index_copy_(1, i, torch.where(keep, new, cache.index_select(1, i)))
        return
    src = off + torch.arange(length, device=dev) - cp          # token of each slot
    inside = ((src >= 0) & (src < sq))[None, :, None, None]
    got = new.index_select(1, torch.clamp(src, 0, sq - 1))
    cache.copy_(torch.where(inside, got, cache))


def _cached_attention_on_mesh(q, k, v, positions, cfg: ModelConfig, kv_cache, cache_pos, *,
                              window, scale):
    """Self-attention of DTensors q ``[B, Sq, H, D]`` and the new k/v
    ``[B, Sq, KV, D]`` against a dense KV cache of DTensors ``[B, L, KV,
    D]`` laid out by ``cache_pspec_tree``, written in place (a scalar
    ``cache_pos``).  q, k and v take the cache's layout of the batch and
    the heads (the query heads beside their KV group); each rank writes the
    tokens that fall in its slice of the cache and attends over that slice.
    Where the cache's sequence is cut over mesh dims, each rank's partial
    result and log-sum-exp are merged over them (the flash merge: a group
    max, then group sums), so every rank of those dims ends with the whole
    result.  A kernel config runs the flash kernel on each rank's slice of
    a cache that is whole along the sequence."""
    from torch.distributed.tensor import Replicate

    from repro_torch.launch.mesh import group_of
    from repro_torch.parallel import collectives

    kc, vc = kv_cache["k"], kv_cache["v"]
    if "table" in kv_cache or not is_dtensor(kc):
        raise NotImplementedError("attention on a mesh takes a dense DTensor KV cache")
    mesh, cpl = kc.device_mesh, tuple(kc.placements)
    seq_dims = [m for m, p in enumerate(cpl) if p.is_shard(1)]
    pl = [p if (p.is_shard(0) or p.is_shard(2)) else Replicate() for p in cpl]
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    if not is_dtensor(positions):
        positions = like_batch(positions, q, batch_dim=positions.ndim - 2)
    off = _local_offset(kc)[1]
    group = group_of(mesh, tuple(mesh.mesh_dim_names[m] for m in seq_dims)) if seq_dims else None
    cp = torch.as_tensor(cache_pos)
    if cp.ndim != 0:
        raise NotImplementedError("attention on a mesh takes one cache_pos for every row")

    def core(q, k, v, kc, vc, positions, cp):
        q, k, q_pos = _rope_qk(q, k, positions, cfg, False)
        _write_kv_slice(kc, k, cp, off)
        _write_kv_slice(vc, v, cp, off)
        k_pos = off + torch.arange(kc.shape[1], device=q.device)
        if uses_kernels(cfg):
            if group is not None:
                raise NotImplementedError("the flash kernel takes a cache whole along the "
                                          "sequence on each rank")
            offs = q_pos[0].expand(q.shape[0]).to(torch.int32).contiguous()
            return fa_kernel.flash_attention(q.contiguous(), kc, vc, offs, None, scale=scale,
                                             causal=True, window=window,
                                             softcap=cfg.attn_softcap)
        if group is None:
            return _plain_core(q, kc, vc, q_pos, k_pos, cfg, causal=True, window=window,
                               scale=scale)
        b, sq, h, hd = q.shape
        g = kc.shape[2]
        out, lse = _chunked_attention(
            q.reshape(b, sq, g, h // g, hd), kc, vc, q_pos, k_pos, causal=True, window=window,
            cap=cfg.attn_softcap, scale=scale, chunk=min(cfg.attn_chunk, kc.shape[1]),
            with_lse=True)
        top = collectives.all_max(lse, group)
        w = torch.exp(lse - top)
        num = collectives.all_reduce(out.float() * w[..., None], group)
        den = collectives.all_reduce(w, group)
        return (num / den[..., None]).to(q.dtype).reshape(b, sq, h, hd)

    return _on_shards(core, (q, k, v, kc, vc, positions), like=q,
                      extra=(cp.to(device=q.device, dtype=torch.int32),))


def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """``[B, S, n·hd]`` → ``[B, S, n, hd]``.  A DTensor whose last dim is
    cut over more parts than ``n`` divides into is made whole along it
    first (DTensor cannot split a dim cut between heads)."""
    b, s = t.shape[0], t.shape[1]
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate

        dims = [m for m, p in enumerate(t.placements) if p.is_shard(t.ndim - 1)]
        parts = math.prod(t.device_mesh.size(m) for m in dims)
        if dims and n % parts:
            t = t.redistribute(t.device_mesh, [Replicate() if m in dims else p
                                               for m, p in enumerate(t.placements)])
    return t.reshape(b, s, n, hd)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``[B, S, n, hd]`` → ``[B, S, n·hd]`` for a DTensor; heads cut
    unevenly over the mesh (``n`` not a multiple of the parts) are made
    whole first: their columns would not be DTensor's even cut of the
    merged dim.  Its gradient is then made whole there too: the row-cut
    product after it hands back one cut evenly along ``n·hd``, which
    DTensor cannot split into the heads."""
    from torch.distributed.tensor import Replicate

    b, s, n, hd = t.shape
    dims = [m for m, p in enumerate(t.placements) if p.is_shard(2)]
    if dims and n % math.prod(t.device_mesh.size(m) for m in dims):
        t = t.redistribute(t.device_mesh, [Replicate() if m in dims else p
                                           for m, p in enumerate(t.placements)])
        return grad_as(t.reshape(b, s, n * hd), t.placements)
    return t.reshape(b, s, n * hd)


def _head_shards(q) -> int:
    """Into how many parts q's head dim (2) is cut on its mesh."""
    n = 1
    for m, p in enumerate(q.placements):
        if p.is_shard(2):
            n *= q.device_mesh.size(m)
    return n


def multihead_attention(
    p: Params,
    x: torch.Tensor,                  # [B, Sq, D_model]
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,          # [B, Sq] (or [3, B, Sq] for M-RoPE)
    kv_cache: Optional[Dict[str, torch.Tensor]] = None,  # {"k","v": [B,Smax,KV,hd]}, or
                                      # paged {"k","v": [num_pages+1,P,KV,hd], "table"}
    cache_pos=None,                   # scalar, or [B] per-row (#valid cache entries)
    layer_window: Optional[int] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # enc-dec cross attn
    causal: Optional[bool] = None,    # None → causal for self, full for cross
    q_lens: Optional[torch.Tensor] = None,  # [B] valid query rows per batch row
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention with RoPE (M-RoPE when ``cfg.mrope_sections`` is set,
    ``positions`` then ``[3, B, Sq]`` and masks following the temporal
    stream).  Self-attention has four cache paths: none; dense KV at a
    scalar ``cache_pos``; dense ragged KV with a ``[B]`` ``cache_pos`` and
    optional ``q_lens``; paged KV (page pools and a ``[B, pages_per_slot]``
    table).  The KV cache is updated in place.  Cross-attention
    (``cross_kv``: the encoder memory's K/V ``[B, S_enc, KV, hd]``) projects
    and rotates only the queries, writes no cache and sees every encoder
    key.  Query rows at or beyond a row's ``q_len`` come out as exact zeros
    from every impl."""
    hd = cfg.resolved_head_dim
    b, sq, _ = x.shape
    kernels = uses_kernels(cfg)
    ragged = isinstance(cache_pos, torch.Tensor) and cache_pos.ndim > 0
    q = _split_heads(x @ p["wq"], cfg.n_heads, hd)
    if cross_kv is None:
        k = _split_heads(x @ p["wk"], cfg.n_kv_heads, hd)
        v = _split_heads(x @ p["wv"], cfg.n_kv_heads, hd)
    else:
        k, v = cross_kv

    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], kernel=kernels)
        if cross_kv is None:
            k = rmsnorm(k, p["k_norm"], kernel=kernels)

    scale = cfg.attn_logit_scale if cfg.attn_logit_scale is not None else 1.0 / math.sqrt(hd)
    window = layer_window
    if window is not None and window <= 0:
        window = None
    if is_dtensor(q):
        # on a mesh: the core runs on each rank's batch rows and heads, and
        # on its slice of a cache; the reference's hint (layers.py:325)
        q = shard_hint(q, "batch", None, "heads", None)
        if q_lens is not None:
            raise NotImplementedError("attention on a mesh takes no q_lens")
        if kv_cache is not None and cross_kv is None:
            out = _cached_attention_on_mesh(q, k, v, positions, cfg, kv_cache, cache_pos,
                                            window=window, scale=scale)
        else:
            out = _attention_on_mesh(q, k, v, positions, cfg, cross=cross_kv is not None,
                                     causal=causal, window=window, scale=scale)
        out = _merge_heads(out) @ p["wo"]
        return shard_hint(out, "batch", None, "embed"), None

    # RoPE on self-attention only (seamless's cross K/V carry none)
    if cross_kv is not None:
        q_pos = positions[0] if positions.ndim == 2 else positions[0][0]
    else:
        q, k, q_pos = _rope_qk(q, k, positions, cfg, ragged)

    new_cache = None
    paged = kv_cache is not None and cross_kv is None and "table" in kv_cache
    if paged:
        pool_k, pool_v, table = kv_cache["k"], kv_cache["v"], kv_cache["table"]
        cp = cache_pos if cache_pos is not None else 0
        _paged_update(pool_k, pool_v, table, k, v, cp, q_lens)
        new_cache = {"k": pool_k, "v": pool_v, "table": table}
        # logical depth pages_per_slot·P: reads past a row's written span hit
        # stale or trash data that the causal test against q_pos zeroes
        k_pos1d = torch.arange(table.shape[1] * pool_k.shape[1], device=x.device)
        causal = True
        if not kernels:
            # naive/chunked: gather the logical view once, then the dense path
            k, v = _paged_view(pool_k, table), _paged_view(pool_v, table)
    elif kv_cache is not None and cross_kv is None:
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
        k_pos1d = (
            q_pos
            if cross_kv is None and q_pos.ndim == 1
            else torch.arange(k.shape[1], device=x.device)
        )
        if causal is None:
            causal = cross_kv is None

    if cfg.attention_impl == "pallas":
        if q_pos.ndim == 2:
            offs = q_pos[:, 0]
        else:
            offs = q_pos[0].expand(b)
        offs = offs.to(torch.int32).contiguous()
        lens = None if q_lens is None else q_lens.to(device=x.device, dtype=torch.int32).contiguous()
        if paged:
            out = fa_kernel.flash_attention_paged(
                q.contiguous(), pool_k, pool_v, table, offs, lens,
                scale=scale, causal=causal, window=window, softcap=cfg.attn_softcap,
            )
        else:
            out = fa_kernel.flash_attention(
                q.contiguous(), k, v, offs, lens,
                scale=scale, causal=causal, window=window, softcap=cfg.attn_softcap,
            )
    else:
        out = _plain_core(q, k, v, q_pos, k_pos1d, cfg, causal=causal, window=window, scale=scale)

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
    gate = shard_hint(x @ p["w_gate"], "batch", None, "ff")
    up = shard_hint(x @ p["w_up"], "batch", None, "ff")
    if activation == "silu":
        h = F.silu(gate) * up
    elif activation in ("geglu", "gelu"):
        h = F.gelu(gate, approximate="tanh") * up
    else:
        raise ValueError(activation)
    return shard_hint(h @ p["w_down"], "batch", None, "embed")
