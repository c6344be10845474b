"""RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Replaces the Pallas TPU kernel ``_rmsnorm_kernel``
(``src/repro/kernels/rmsnorm/kernel.py``).  Per row of ``x [..., D]``:
``x · rsqrt(mean(x²) + eps) · (1 + w)`` in fp32, cast back to x's type;
``w [D]`` is fp32 in offset form.  The model calls it at every norm site
(two per block plus the final norm) when ``attention_impl="pallas"``.
"""

from __future__ import annotations

import torch

from . import _build

# kernel launches since the count was last reset (the CPU path never counts)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 math, cast back)."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + w.float())).to(dt)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of ``x`` over its last axis: the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor (raising on any input the
    kernel does not take)."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, got {x.dtype}")
    if w.dtype != torch.float32 or tuple(w.shape) != (d,):
        raise TypeError(f"rmsnorm kernel needs fp32 weights [{d}], got {w.dtype} {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and w")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
            _DTYPES[x.dtype], float(eps), stream,
        )
    _build.check(err, "rmsnorm_fwd")
    launches += 1
    return out
