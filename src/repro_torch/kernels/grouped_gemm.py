"""Grouped (ragged) GEMM, the MoE expert matmul: the CUDA kernel of
``csrc/grouped_gemm.cu`` and its plain version.

Replaces the Pallas TPU kernel ``_gg_kernel``
(``src/repro/kernels/grouped_gemm/kernel.py``) and its wrapper
``ops.py::grouped_gemm``.  ``out[i] = x[i] @ w[g(i)]`` for rows
``x [M, K]`` sorted by expert, ``w [E, K, N]`` and ``group_sizes [E]``
int32: expert e owns the ``group_sizes[e]`` rows after those of the experts
before it, and rows past the last group come out as zeros (the contraction
``jax.lax.ragged_dot`` performs, the reference's oracle).  Products are
accumulated in fp32; the output has x's type.

On the card the call is bound by the bytes of the touched experts' weights
(each read once per row tile of its expert, never once per row).  The
kernel reads x's rows in place and masks the ragged row edge itself, so the
TPU wrapper's megablocks re-pack (each group padded to whole row blocks in
a copy of x, then the output gathered back) has no counterpart, and the
group sizes stay on the device: the wrapper never reads them on the host.
"""

from __future__ import annotations

import torch

from . import _build

# kernel launches since the count was last reset (the CPU path never counts)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a loop over the experts with
    the row offsets read on the host, each product in fp32, cast back."""
    m, n = x.shape[0], w.shape[2]
    out = torch.zeros((m, n), dtype=x.dtype, device=x.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), m)
        if end > start:
            out[start:end] = (x[start:end].float() @ w[e].float()).to(x.dtype)
        start = end
    return out


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``x [M, K]`` (rows sorted by expert) times ``w [E, K, N]`` per the
    ``[E]`` int32 ``group_sizes``.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel, or raises on any input the kernel does
    not take: float32 or bfloat16 x and w of one type on one card,
    contiguous and 16-byte aligned, K and N multiples of 8, and int32
    ``group_sizes`` of shape ``[E]`` on the same card."""
    global launches
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm: unsupported device {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(
            f"grouped_gemm kernel takes float32 or bfloat16 x and w of one type, got "
            f"{x.dtype}/{w.dtype}"
        )
    if x.ndim != 2 or w.ndim != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"grouped_gemm shapes: x {tuple(x.shape)}, w {tuple(w.shape)}")
    m, k = x.shape
    e, _, n = w.shape
    if k % 8 or n % 8 or k == 0 or n == 0 or e == 0:
        raise ValueError(f"grouped_gemm kernel needs K and N multiples of 8, got K={k}, N={n}")
    if group_sizes.dtype != torch.int32 or tuple(group_sizes.shape) != (e,):
        raise TypeError(f"grouped_gemm: group_sizes must be int32 [{e}], got "
                        f"{group_sizes.dtype} {tuple(group_sizes.shape)}")
    if w.device != x.device or group_sizes.device != x.device:
        raise ValueError("grouped_gemm: x, w and group_sizes must share one device")
    if not (x.is_contiguous() and w.is_contiguous() and group_sizes.is_contiguous()):
        raise ValueError("grouped_gemm kernel needs contiguous inputs")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("grouped_gemm kernel copies in 16-byte pieces: align x and w to 16 bytes")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grouped_gemm_fwd(
            x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
            m, k, n, e, _DTYPES[x.dtype], stream,
        )
    _build.check(err, "grouped_gemm_fwd")
    launches += 1
    return out
