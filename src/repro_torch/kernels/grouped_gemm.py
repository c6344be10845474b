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

bf16, the serving type, runs a persistent kernel of two blocks an SM:
each takes work units of (64-row tile of one expert, 128-column tile, K
split) from a counter in device memory, a producer warp keeps a ring of
TMA loads in flight and a warpgroup multiplies with ``wgmma``.  Where the
call would give the SMs too few tiles (decode routing), :func:`split_k`
cuts K into splits of whole 64-deep steps; each split writes an fp32
partial to a workspace that this wrapper allocates, and the last split of a
tile to finish, found by an arrival counter, sums the partials in split
order (no float atomics: two launches are bit-identical).  The workspace
and the counters (the unit counter and the arrivals, in a zeroed buffer
that the kernel leaves zeroed) are kept per card and shared by every call;
that is safe because the port launches on one stream, so two calls never
run at once.  fp32 (the parity path) runs a CUDA-core kernel with no
split.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build

# kernel launches since the count was last reset (the CPU path never counts)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the bf16 kernel's row tile, column tile and K step (csrc/grouped_gemm.cu)
BM, BN, BK = 64, 128, 64
# split K when the expected output tiles are under WAVES waves of the SMs,
# into enough splits for WAVES waves, each split at least MIN_STEPS K steps
# deep and at most MAX_SPLITS of them (the kernel's bound)
WAVES, MIN_STEPS, MAX_SPLITS = 4, 4, 16

# per card, for the life of the process: the bf16 kernel's int32 counters
# (the unit counter, the blocks done, the split tiles' arrivals), zeroed once
# and left zeroed by every call; its fp32 split-K workspace, which every call
# writes before it reads; and the SM count, the persistent grid's size
_scratch: dict = {}
_sms: dict = {}


def split_k(m: int, k: int, n: int, e: int, sms: int) -> int:
    """How many K splits the bf16 kernel takes for ``m`` rows over ``e``
    experts, ``x [m, k] @ w [e, k, n]``, on a card of ``sms`` SMs.

    The host knows m and e but not which experts have rows, so it expects
    ``e (1 - (1 - 1/e)^m)`` of them to (uniform routing: ~25 at qwen2-moe's
    decode, m = 32, e = 64), and at least ceil(m / 64) row tiles.  With
    those tiles times the column tiles at WAVES (4) waves of the SMs or more
    (chunk routing, m = 2048) K is not split; under it (decode routing) K is
    cut into ceil(WAVES · sms / tiles) splits, each at least MIN_STEPS
    64-deep steps, at most MAX_SPLITS, every one non-empty."""
    n_k = -(-k // BK)
    touched = e * (1.0 - (1.0 - 1.0 / e) ** m)
    tiles = max(-(-m // BM), touched) * -(-n // BN)
    if tiles >= WAVES * sms:
        return 1
    s = max(1, min(math.ceil(WAVES * sms / tiles), n_k // MIN_STEPS, MAX_SPLITS))
    per = -(-n_k // s)
    return -(-n_k // per)


def split_ranges(k: int, splits: int) -> list:
    """The ``[lo, hi)`` K range of each split, as the kernel cuts it: whole
    64-deep steps, ceil(steps / splits) a split, the last ending at K."""
    n_k = -(-k // BK)
    per = -(-n_k // splits)
    return [(s * per * BK, min(k, (s + 1) * per * BK)) for s in range(splits)]


def _scratch_for(device: torch.device, name: str, numel: int, dtype: torch.dtype,
                 zeroed: bool = False) -> torch.Tensor:
    """A flat buffer of at least ``numel`` elements kept for the card: calls
    share it because the port launches on one stream, so two never overlap
    (one allocation less a call on a host-bound path)."""
    buf = _scratch.get((device, name))
    if buf is None or buf.numel() < numel:
        make = torch.zeros if zeroed else torch.empty
        buf = _scratch[(device, name)] = make(max(numel, 4096), dtype=dtype, device=device)
    return buf


def _sm_count(device: torch.device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device]


def _plain_loop(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
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


def _plain_backward(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    group_sizes: torch.Tensor):
    """The gradients of :func:`_plain_loop` (``g`` the output's): each
    expert's ``dx = g·wᵀ`` and ``dw = xᵀ·g`` in fp32, cast back; zeros for
    rows past the last group and for experts with no rows."""
    m = x.shape[0]
    dx = torch.zeros_like(x)
    dw = torch.zeros_like(w)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), m)
        if end > start:
            gf = g[start:end].float()
            dx[start:end] = (gf @ w[e].float().T).to(x.dtype)
            dw[e] = (x[start:end].float().T @ gf).to(w.dtype)
        start = end
    return dx, dw


# The grouped GEMM is one custom op, ``repro_torch::grouped_gemm``, so that
# the rest of PyTorch can reason about it without running it: its fake
# implementation gives the output's shape (fake tensors, whose group sizes
# cannot be read on the host), its FLOP formula counts ``2·M·K·N`` (the
# dense count XLA gives ``ragged_dot``), and its autograd rule is the plain
# loop's own gradient.  ``kernel`` picks the eager implementation: the CUDA
# kernel on a CUDA tensor (``True``), or the plain loop.
@torch.library.custom_op("repro_torch::grouped_gemm", mutates_args=())
def _op(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, kernel: bool) -> torch.Tensor:
    if kernel and x.device.type != "cpu":
        return _launch(x, w, group_sizes)
    return _plain_loop(x, w, group_sizes)


@_op.register_fake
def _(x, w, group_sizes, kernel):
    return x.new_empty((x.shape[0], w.shape[2]))


@torch.library.custom_op("repro_torch::grouped_gemm_backward", mutates_args=())
def _op_backward(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                 group_sizes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _plain_backward(g, x, w, group_sizes)


@_op_backward.register_fake
def _(g, x, w, group_sizes):
    return torch.empty_like(x), torch.empty_like(w)


def _setup_context(ctx, inputs, output):
    x, w, group_sizes, _ = inputs
    ctx.save_for_backward(x, w, group_sizes)


def _backward(ctx, g):
    x, w, group_sizes = ctx.saved_tensors
    dx, dw = _op_backward(g.contiguous(), x, w, group_sizes)
    return dx, dw, None, None


_op.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.repro_torch.grouped_gemm)
def _flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * w_shape[2]


@register_flop_formula(torch.ops.repro_torch.grouped_gemm_backward)
def _flops_backward(g_shape, x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    return 4 * x_shape[0] * x_shape[1] * w_shape[2]


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the custom op's plain
    route): a loop over the experts with the row offsets read on the host,
    each product in fp32, cast back."""
    return _op(x, w, group_sizes, False)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``x [M, K]`` (rows sorted by expert) times ``w [E, K, N]`` per the
    ``[E]`` int32 ``group_sizes``.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel, or raises on any input the kernel does
    not take: float32 or bfloat16 x and w of one type on one card,
    contiguous and 16-byte aligned, K and N multiples of 8, and int32
    ``group_sizes`` of shape ``[E]`` on the same card.  A fake tensor gets
    the output's shape and launches nothing.

    CUDA tensors with no gradient to record and no dispatch mode on (the
    serving path) launch the kernel directly; the rest go through the
    custom op, whose fake implementation, FLOP formula and autograd rule
    they need."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_gemm: unsupported device {x.device}")
    if x.device.type == "cuda" and not _needs_op(x, w):
        return _launch(x, w, group_sizes)
    return _op(x, w, group_sizes, True)


def _needs_op(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether a call must go through the custom op: a dispatch mode is on
    (fake tensors, a counter) or autograd records the call."""
    if torch._C._len_torch_dispatch_stack() > 0:
        return True
    return torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)


def _launch(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors (:func:`grouped_gemm`'s checks, then one
    launch, counted)."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm: unsupported device {x.device}")
    _build.refuse_fakes("grouped_gemm", x, w, group_sizes)
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
        # also what TMA needs: 16-byte-aligned bases, row strides of K and N
        # (multiples of 8) elements
        raise ValueError("grouped_gemm kernel copies in 16-byte pieces: align x and w to 16 bytes")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    lib = _build.load()
    sms = _sm_count(x.device)
    splits, ws, counters = 1, None, None
    if x.dtype == torch.bfloat16:
        splits = split_k(m, k, n, e, sms)
        counters = _scratch_for(x.device, "counters", 2 + (-(-m // BM) + e + 1) * -(-n // BN),
                                torch.int32, zeroed=True)
        if splits > 1:
            ws = _scratch_for(x.device, "workspace", splits * m * n, torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grouped_gemm_fwd(
            x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            m, k, n, e, _DTYPES[x.dtype], splits, sms, stream,
        )
    _build.check(err, "grouped_gemm_fwd")
    launches += 1
    return out
