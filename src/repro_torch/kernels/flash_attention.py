"""Flash attention, dense and paged: the CUDA kernels of
``csrc/flash_attention.cu`` and their plain versions.

Replaces the Pallas TPU kernels ``_flash_kernel`` and ``_flash_kernel_paged``
(``src/repro/kernels/flash_attention/kernel.py``) and their model-layout
wrappers ``ops.py::flash_attention`` and ``ops.py::flash_attention_paged``.
Layout is the model's: q
``[B, Sq, H, D]``, k/v ``[B, Sk, KV, D]`` (GQA: query head h reads KV head
``h // (H // KV)``).  Row b's query i sits at absolute position
``q_offsets[b] + i``; keys sit at ``0..Sk-1``.  A key is visible when
``kp < Sk``, ``i < q_lens[b]``, causally ``kp <= qp`` and, with a window,
``kp > qp - window``.  Query rows with no visible key — idle rows
(``q_len=0``) and the padding rows ``i >= q_lens[b]`` of a fused mixed
batch — come out as exact zeros.  Scores are fp32 (optionally tanh
soft-capped); the output has q's type.  On the card a call with at most
:func:`_decode_rows` rows (``Sq · H / KV``: 16, or 8 at head dim 256) per
(batch row, KV head) — every decode step — runs the split-KV decode
kernel, which cuts the key axis into fixed splits of :func:`_decode_split`
keys and merges their partial softmaxes
(fp32 scratch from :func:`_decode_workspace`); a bf16 chunk runs the tensor-core
tile, which rounds the probabilities to bf16 for P·V; fp32 chunks and the
decode kernel keep them in fp32, as the plain version does.

The paged kernel reads K/V from page pools ``[num_pages + 1, P, KV, D]``
through a page table ``[B, pages_per_slot]``: logical key ``t`` of row b
lives at page ``table[b, t // P]``, row ``t % P``, and an unmapped entry
(``-1``) reads the trash page ``num_pages``.  Its logical key axis is
``pages_per_slot · P`` long; otherwise it is the dense function on the
gathered view (:func:`paged_view`).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

# kernel launches since the counts were last reset (the CPU path never
# counts): every dense and every paged call, of those the calls that ran the
# split-KV decode kernel (at most _decode_rows rows per KV head), and the
# dense calls without the causal mask (an encoder's self-attention, a
# decoder's cross-attention)
launches = 0
paged_launches = 0
decode_launches = 0
paged_decode_launches = 0
noncausal_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernel is built for: the smoke configs' (32: the serve
# demo and ``--smoke`` on the card), llama3.2-1b's (64), zamba2-2.7b's
# shared attention (80), qwen2-moe-a2.7b's, qwen3-14b's and gemma2-27b's
# (128) and gemma-7b's (256); the others come with the slices of the
# configs that need them
_HEAD_DIMS = (32, 64, 80, 128, 256)
# the decode kernel's most rows per (batch row, KV head)
# (csrc/flash_attention.cu: DEC_ROWS)
_DECODE_ROWS = 16


def _decode_rows(head_dim: int) -> int:
    """The most rows per (batch row, KV head) the decode kernel takes at
    ``head_dim`` (csrc/flash_attention.cu: dec_rows): 16, or 8 at head dim
    256, where 16 rows' output would not fit a thread's registers."""
    return 8 if head_dim > 128 else _DECODE_ROWS


def _decode_split(dtype: torch.dtype, head_dim: int) -> int:
    """Keys per split of the decode kernel (csrc/flash_attention.cu:
    dec_split): 256 where a K row is at most 128 bytes, 128 where it is at
    most 512, else 64 (fp32 at head dim 256, whose 128-key ring would not
    fit a block's shared memory)."""
    row = head_dim * dtype.itemsize
    return 256 if row <= 128 else 128 if row <= 512 else 64


def attn_mask(q_pos, k_pos, causal: bool, window: Optional[int]) -> torch.Tensor:
    """True where attention is allowed: [Sq, Sk], or [B, Sq, Sk] when
    ``q_pos`` carries per-row positions."""
    qp = q_pos[..., :, None]
    m = torch.ones(qp.shape[:-1] + (k_pos.shape[0],), dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & (k_pos <= qp)
    if window is not None:
        m = m & (k_pos > (qp - window))
    return m


def bcast_mask(mask: torch.Tensor) -> torch.Tensor:
    """[Sq,Sk] or [B,Sq,Sk] mask → broadcastable over [B,G,R,Sq,Sk]."""
    return mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]


def visible_mask(
    q_offsets: torch.Tensor, q_lens: torch.Tensor, sq: int, sk: int,
    *, causal: bool, window: Optional[int],
) -> torch.Tensor:
    """``[B, Sq, Sk]`` bool: which keys each query row of the kernel may
    attend — :func:`attn_mask` at positions ``q_offsets[b] + i``, for the
    rows ``i < q_lens[b]``."""
    dev = q_offsets.device
    qi = torch.arange(sq, device=dev, dtype=torch.int64)
    q_pos = q_offsets.to(torch.int64)[:, None] + qi[None, :]
    kp = torch.arange(sk, device=dev, dtype=torch.int64)
    m = attn_mask(q_pos, kp, causal, window if window is not None and window > 0 else None)
    return m & (qi[None, :] < q_lens.to(torch.int64)[:, None])[:, :, None]


def masked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    *, scale: float, cap: Optional[float] = None, zero_masked_rows: bool = False,
    p_fp32: bool = False,
) -> torch.Tensor:
    """The plain masked softmax: the ``naive`` attention impl and, through
    :func:`flash_attention_plain`, the kernel's plain version.

    q ``[B, Sq, G, R, D]`` (GQA-grouped), k/v ``[B, Sk, G, D]``, mask
    ``[Sq, Sk]`` or ``[B, Sq, Sk]``; scores in fp32, optionally tanh
    soft-capped.  ``zero_masked_rows`` gives query rows with no visible key
    exact zeros (otherwise a uniform softmax); ``p_fp32`` keeps P in fp32 for
    P·V (otherwise P is cast to v's type).  Returns ``[B, Sq, G, R, D]`` in
    P·V's type."""
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.float(), k.float()) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    m = bcast_mask(mask)
    s = torch.where(m, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    if zero_masked_rows:
        p = torch.where(m, p, torch.zeros_like(p))
    if p_fp32:
        return torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype), v)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offsets: torch.Tensor, q_lens: torch.Tensor,
    *, scale: float, causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: :func:`masked_attention` over
    the whole key axis with fp32 P and keyless rows zeroed (no KV repeat is
    materialized)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    mask = visible_mask(q_offsets, q_lens, sq, sk, causal=causal, window=window)
    out = masked_attention(
        q.reshape(b, sq, kv, h // kv, d), k, v, mask, scale=scale,
        cap=softcap if softcap is not None and softcap > 0 else None,
        zero_masked_rows=True, p_fp32=True,
    )
    return out.reshape(b, sq, h, d).to(q.dtype)


def _check_kernel_inputs(what, q, k, v, q_offsets, q_lens) -> None:
    """Raise on anything the CUDA kernel does not take: q ``[B, Sq, H, D]``
    on a card; k/v ``[N, S, KV, D]`` (dense rows or page pools) of q's type
    and device; q, k and v contiguous and 16-byte aligned; int32 ``[B]``
    offsets and lengths."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    _build.refuse_fakes(what, q, k, v, q_offsets, q_lens)
    b, _, h, d = q.shape
    kv = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{what} takes float32 or bfloat16 q/k/v of one type, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d not in _HEAD_DIMS or k.ndim != 4 or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(
            f"{what} shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (head_dim must be one of {_HEAD_DIMS})"
        )
    if kv == 0 or h % kv:
        raise ValueError(f"{what}: {h} query heads over {kv} KV heads")
    for name, t in (("q_offsets", q_offsets), ("q_lens", q_lens)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,) or t.device != q.device:
            raise TypeError(f"{what}: {name} must be int32 [{b}] on {q.device}")
    for t in (q, k, v, q_offsets, q_lens):
        if not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous inputs")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{what} copies Q and K/V in 16-byte pieces: align q, k and v to 16 bytes")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q, k and v must share one device")


def _is_decode(q: torch.Tensor, kv: int) -> bool:
    """Whether the card runs this call on the split-KV decode kernel."""
    return q.shape[1] * (q.shape[2] // kv) <= _decode_rows(q.shape[3])


def _decode_workspace(q: torch.Tensor, kv: int, k_len: int) -> Optional[torch.Tensor]:
    """The decode kernel's fp32 scratch on q's device: each split's
    ``(m, l)`` and ``O[D]`` per row, ``[B, KV, splits, rows, D + 2]``; None
    where the call needs none (a chunk, or keys that fit one split)."""
    b, sq, h, d = q.shape
    rows = sq * (h // kv)
    splits = -(-k_len // _decode_split(q.dtype, d))
    if not _is_decode(q, kv) or splits <= 1:
        return None
    return torch.empty(b * kv * splits * rows * (d + 2), dtype=torch.float32, device=q.device)


def _ptr_count(ws: Optional[torch.Tensor]) -> tuple:
    return (None, 0) if ws is None else (ws.data_ptr(), ws.numel())


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offsets: torch.Tensor, q_lens: Optional[torch.Tensor] = None,
    *, scale: float, causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Dense GQA flash attention.  ``q_offsets``/``q_lens`` are ``[B]``
    int32 (``q_lens=None`` → every row has ``Sq`` valid queries).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel, or
    raises on any input the kernel does not take."""
    global launches, decode_launches, noncausal_launches
    b, sq, h, d = q.shape
    if q_lens is None:
        q_lens = torch.full((b,), sq, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_offsets, q_lens, scale=scale, causal=causal,
            window=window, softcap=softcap,
        )
    sk, kv = k.shape[1], k.shape[2]
    _check_kernel_inputs("flash kernel", q, k, v, q_offsets, q_lens)
    if k.shape[0] != b:
        raise ValueError(f"flash kernel: k has {k.shape[0]} rows for {b} query rows")
    out = torch.empty_like(q)
    ws = _decode_workspace(q, kv, sk)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *_ptr_count(ws),
            q_offsets.data_ptr(), q_lens.data_ptr(),
            b, sq, h, sk, kv, d, _DTYPES[q.dtype],
            float(scale), int(bool(causal)), int(window or 0),
            float(softcap or 0.0), sk, stream,
        )
    _build.check(err, "flash_attention_fwd")
    launches += 1
    decode_launches += _is_decode(q, kv)
    noncausal_launches += not causal
    return out


# --------------------------------------------------------------------- paged
def paged_view(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather the logical ``[B, pages_per_slot · P, KV, D]`` cache view out
    of a page pool ``[num_pages + 1, P, KV, D]`` through ``table``
    ``[B, pages_per_slot]``.  Unmapped entries (``-1``) resolve to the trash
    page ``num_pages``: garbage, which the causal mask never lets a query
    see (it sits past every row's written span)."""
    np1, page_tokens = pool.shape[0], pool.shape[1]
    pages_per_slot = table.shape[1]
    t = torch.arange(pages_per_slot * page_tokens, device=pool.device)
    pages = table.to(device=pool.device, dtype=torch.int64)
    pages = torch.where(pages >= 0, pages, torch.full_like(pages, np1 - 1))
    src = pages[:, t // page_tokens] * page_tokens + (t % page_tokens)[None, :]
    return pool.reshape((np1 * page_tokens,) + tuple(pool.shape[2:]))[src]


def flash_attention_paged_plain(
    q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor, table: torch.Tensor,
    q_offsets: torch.Tensor, q_lens: torch.Tensor,
    *, scale: float, causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch: :func:`paged_view` of
    both pools, then :func:`flash_attention_plain` over the
    ``pages_per_slot · P`` logical keys."""
    return flash_attention_plain(
        q, paged_view(pool_k, table), paged_view(pool_v, table), q_offsets, q_lens,
        scale=scale, causal=causal, window=window, softcap=softcap,
    )


def flash_attention_paged(
    q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor, table: torch.Tensor,
    q_offsets: torch.Tensor, q_lens: Optional[torch.Tensor] = None,
    *, scale: float, causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Paged GQA flash attention: q ``[B, Sq, H, D]``, pools
    ``[num_pages + 1, P, KV, D]``, ``table`` ``[B, pages_per_slot]`` (``-1``
    = unmapped, read as the trash page ``num_pages``), ``q_offsets`` /
    ``q_lens`` ``[B]`` int32 as :func:`flash_attention`.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel, or raises on any
    input the kernel does not take.  The kernel itself maps negative entries
    to the trash page at the table read, so the wrapper launches nothing but
    the kernel; a non-negative entry must name a page of the pool."""
    global paged_launches, paged_decode_launches
    b, sq, h, d = q.shape
    if q_lens is None:
        q_lens = torch.full((b,), sq, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return flash_attention_paged_plain(
            q, pool_k, pool_v, table, q_offsets, q_lens, scale=scale, causal=causal,
            window=window, softcap=softcap,
        )
    _check_kernel_inputs("paged flash kernel", q, pool_k, pool_v, q_offsets, q_lens)
    np1, page_tokens, kv = pool_k.shape[0], pool_k.shape[1], pool_k.shape[2]
    if table.ndim != 2 or table.shape[0] != b or table.shape[1] == 0:
        raise ValueError(f"paged flash kernel: table {tuple(table.shape)} for {b} rows")
    if table.dtype != torch.int32 or table.device != q.device or not table.is_contiguous():
        table = table.to(device=q.device, dtype=torch.int32).contiguous()
    pages_per_slot = table.shape[1]
    out = torch.empty_like(q)
    ws = _decode_workspace(q, kv, pages_per_slot * page_tokens)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_paged_fwd(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(),
            out.data_ptr(), *_ptr_count(ws), q_offsets.data_ptr(), q_lens.data_ptr(),
            b, sq, h, kv, d, page_tokens, pages_per_slot, np1, _DTYPES[q.dtype],
            float(scale), int(bool(causal)), int(window or 0), float(softcap or 0.0),
            stream,
        )
    _build.check(err, "flash_attention_paged_fwd")
    paged_launches += 1
    paged_decode_launches += _is_decode(q, kv)
    return out
