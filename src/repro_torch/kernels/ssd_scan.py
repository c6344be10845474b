"""Mamba2 SSD chunked scan: the CUDA kernel of ``csrc/ssd_scan.cu`` and its
plain version.

Replaces the Pallas TPU kernel ``_ssd_kernel``
(``src/repro/kernels/ssd_scan/kernel.py``) and its wrapper
``ops.py::ssd_scan``; the plain version is the port of the model's jnp
scan ``models/ssm.py::ssd_chunked`` (the kernel's oracle).  Layout is the
model's: x ``[B, S, H, P]``, dt ``[B, S, H]`` fp32 after softplus, A
``[H]`` fp32 and negative, B/C ``[B, S, G, N]`` (head h reads group
``h // (H // G)``), init_state ``[B, H, P, N]`` fp32 or None (zeros).
Returns y ``[B, S, H, P]`` in x's type and the final state ``[B, H, P, N]``
in fp32, written into ``out_state`` when one is given (it may be
init_state itself: the model's cache then updates in place).  Unlike the
TPU kernel, the CUDA kernel takes an initial state, so it serves the
model's chunk continuation as well as a fresh prefill; it reads the model
layout by stride (no transposes) and masks the ragged last chunk itself
(no padded copies).  bf16 calls run the tensor-core kernel
(``ssd_scan_mma_kernel``), fp32 calls the CUDA-core one
(``ssd_scan_kernel``); the C entry reports which ran, and the wrapper
counts each.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

import ctypes

from . import _build

# kernel launches since the count was last reset (the CPU path never counts),
# in all and by kernel: the bf16 tensor-core kernel, the fp32 CUDA-core one
launches = 0
mma_launches = 0
core_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# state widths the kernel is built for: the reference tests' 32 and 64
# (zamba2-2.7b's), mamba2-130m's 128
_STATE_DIMS = (32, 64, 128)
MAX_CHUNK = 128


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """segsum(x)[..., i, j] = Σ_{j<t≤i} x_t (−inf for j>i): [.., L] → [.., L, L]."""
    n = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_scan_plain(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
    chunk: int, init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the reference's chunked SSD
    (intra-chunk quadratic branch, chunk states, the inter-chunk recurrence
    as a loop, the inter-chunk contribution), all in fp32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))          # dt = 0: no contribution
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, g, n).float()
    Cc = C.reshape(b, nc, chunk, g, n).float()
    dA = dtc * A                                        # [B,nc,L,H] (≤ 0)
    Bh = Bc.repeat_interleave(rep, dim=3)               # [B,nc,L,H,N]
    Ch = Cc.repeat_interleave(rep, dim=3)
    xw = xc.float() * dtc[..., None]                    # dt-weighted inputs

    # intra-chunk (the "quadratic branch" of SSD)
    lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # [B,nc,H,L,L]
    scores = torch.einsum("bclhn,bcshn->bchls", Ch, Bh) * lmat
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xw)

    # chunk states
    cum = torch.cumsum(dA, dim=2)                       # [B,nc,L,H]
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bclhn,bclhp->bchpn", Bh * decay_to_end[..., None], xw)

    # inter-chunk recurrence: the state BEFORE each chunk, then the final one
    chunk_decay = torch.exp(cum[:, :, -1, :])           # [B,nc,H]
    carry = (
        init_state.float() if init_state is not None
        else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    )
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)              # [B,nc,H,P,N]

    # inter-chunk contribution
    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch * torch.exp(cum)[..., None], prev_states)
    y = (y_diag + y_off).reshape(b, sp, h, p)[:, :s]
    return y.to(x.dtype), carry


def ssd_scan(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
    chunk: int, init_state: Optional[torch.Tensor] = None,
    out_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor (raising on any input the kernel does not
    take).  ``out_state`` (fp32 ``[B, H, P, N]``, contiguous, may be
    ``init_state``) receives the final state and is returned."""
    global launches, mma_launches, core_launches
    if x.device.type == "cpu":
        y, final = ssd_scan_plain(x, dt, A, B, C, chunk, init_state)
        if out_state is None:
            return y, final
        return y, out_state.copy_(final)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    _build.refuse_fakes("ssd_scan", x, dt, A, B, C, init_state, out_state)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(
            f"ssd_scan kernel takes float32 or bfloat16 x/B/C of one type, got "
            f"{x.dtype}/{B.dtype}/{C.dtype}"
        )
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan kernel needs fp32 dt and A, got {dt.dtype}, {A.dtype}")
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B.shape) != (b, s, g, n) or C.shape != B.shape
            or g == 0 or h % g or n not in _STATE_DIMS or s == 0):
        raise ValueError(
            f"ssd_scan kernel shapes: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)} (N must be one of "
            f"{_STATE_DIMS}, G must divide H, S > 0)"
        )
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel takes 1 <= chunk <= {MAX_CHUNK}, got {chunk}")
    if x.dtype == torch.bfloat16 and (p % 16 or any(
            t.data_ptr() % 16 for t in (x, B, C))):
        raise ValueError(
            f"ssd_scan bf16 kernel needs P a multiple of 16 (got {p}) and x, B, C "
            "16-byte aligned"
        )
    tensors = [x, dt, A, B, C]
    for name, st in (("init_state", init_state), ("out_state", out_state)):
        if st is None:
            continue
        if st.dtype != torch.float32 or tuple(st.shape) != (b, h, p, n):
            raise TypeError(
                f"ssd_scan kernel needs an fp32 {name} [{b}, {h}, {p}, {n}], got "
                f"{st.dtype} {tuple(st.shape)}"
            )
        tensors.append(st)
    for t in tensors:
        if t.device != x.device:
            raise ValueError("ssd_scan: every input must be on one device")
        if not t.is_contiguous():
            raise ValueError("ssd_scan kernel needs contiguous inputs")
    y = torch.empty_like(x)
    final = (
        torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
        if out_state is None else out_state
    )
    lib = _build.load()
    kernel = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), final.data_ptr(), b, s, h, p, g, n, int(chunk),
            _DTYPES[x.dtype], stream, ctypes.byref(kernel),
        )
    _build.check(err, "ssd_scan_fwd")
    launches += 1
    if kernel.value == 1:
        mma_launches += 1
    else:
        core_launches += 1
    return y, final
