"""Dense flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain version.

Replaces the Pallas TPU kernel ``_flash_kernel``
(``src/repro/kernels/flash_attention/kernel.py``) and its model-layout
wrapper ``ops.py::flash_attention``.  Layout is the model's: q
``[B, Sq, H, D]``, k/v ``[B, Sk, KV, D]`` (GQA: query head h reads KV head
``h // (H // KV)``).  Row b's query i sits at absolute position
``q_offsets[b] + i``; keys sit at ``0..Sk-1``.  A key is visible when
``kp < Sk``, ``i < q_lens[b]``, causally ``kp <= qp`` and, with a window,
``kp > qp - window``.  Query rows with no visible key — idle rows
(``q_len=0``) and the padding rows ``i >= q_lens[b]`` of a fused mixed
batch — come out as exact zeros.  Scores are fp32 (optionally tanh
soft-capped); the output has q's type.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

# kernel launches since the count was last reset (the CPU path never counts)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernel is built for: llama3.2-1b's; the others come with
# the slices of the configs that need them
_HEAD_DIMS = (64,)


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
    global launches
    b, sq, h, d = q.shape
    if q_lens is None:
        q_lens = torch.full((b,), sq, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, q_offsets, q_lens, scale=scale, causal=causal,
            window=window, softcap=softcap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    sk, kv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes float32 or bfloat16 q/k/v of one type, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d not in _HEAD_DIMS or tuple(k.shape) != (b, sk, kv, d) or v.shape != k.shape:
        raise ValueError(
            f"flash kernel shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (head_dim must be one of {_HEAD_DIMS})"
        )
    if kv == 0 or h % kv:
        raise ValueError(f"flash kernel: {h} query heads over {kv} KV heads")
    for name, t in (("q_offsets", q_offsets), ("q_lens", q_lens)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,) or t.device != q.device:
            raise TypeError(f"flash kernel: {name} must be int32 [{b}] on {q.device}")
    for t in (q, k, v, q_offsets, q_lens):
        if not t.is_contiguous():
            raise ValueError("flash kernel needs contiguous inputs")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash kernel copies K/V in 16-byte pieces: align k and v to 16 bytes")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash kernel: q, k and v must share one device")
    out = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q_offsets.data_ptr(), q_lens.data_ptr(),
            b, sq, h, sk, kv, d, _DTYPES[q.dtype],
            float(scale), int(bool(causal)), int(window or 0),
            float(softcap or 0.0), sk, stream,
        )
    _build.check(err, "flash_attention_fwd")
    launches += 1
    return out
