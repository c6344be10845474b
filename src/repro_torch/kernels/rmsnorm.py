"""RMSNorm: the CUDA kernels ``csrc/rmsnorm.cu`` and their plain version.

Replaces the Pallas TPU kernel ``_rmsnorm_kernel``
(``src/repro/kernels/rmsnorm/kernel.py``).  Per row of ``x [..., D]``:
``x · rsqrt(mean(x²) + eps) · (1 + w)`` in fp32, cast back to x's type;
``w [D]`` is fp32 in offset form.  The model calls it at every norm site
(two per block, two more per block with per-head q/k norms or post-norms,
plus the final norm) when ``attention_impl="pallas"``.

Two kernels, chosen up front by :func:`plan` from (dtype, D, alignment):
the rows kernel (``rmsnorm_rows_kernel``: a row held in the registers of a
half warp, a warp or a few warps, several rows a block, each lane's weights
loaded once into registers for every row it walks) at every width of
:data:`ROWS_INSTANCES`, and the generic kernel (one block a row) at any
other width or a misaligned pointer.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import _build

# kernel launches since the counts were last reset (the CPU path never
# counts): all of them, and by kernel
launches = 0
rows_launches = 0
generic_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the rows kernel's instances: width -> (lanes a row, 16-byte packs a lane),
# the table RMSNORM_ROWS_INSTANCES of csrc/rmsnorm.cu
ROWS_INSTANCES = {
    torch.bfloat16: {128: (16, 1), 768: (32, 3), 1024: (32, 4), 1536: (32, 6), 2048: (32, 8),
                     2560: (32, 10), 3072: (128, 3), 3584: (64, 7), 4608: (192, 3),
                     5120: (128, 5), 7168: (128, 7)},
    torch.float32: {128: (32, 1), 768: (64, 3), 1024: (64, 4), 1536: (64, 6), 2048: (64, 8),
                    2560: (64, 10), 3072: (256, 3), 3584: (128, 7), 4608: (192, 6),
                    5120: (256, 5), 7168: (256, 7)},
}
MAX_THREADS = 256          # the rows kernel's block limit (kRowsMaxThreads)
SM_THREADS = 2048          # resident threads an SM (Hopper)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Which kernel runs: ``"rows"`` with its instance, or ``"generic"``."""

    kernel: str
    lanes: int = 0
    packs: int = 0

    @property
    def instance(self) -> str:
        return f"rows<{self.lanes}x{self.packs}>" if self.kernel == "rows" else "generic"


def plan(d: int, dtype: torch.dtype, *, aligned: bool = True) -> Plan:
    """The kernel for rows of width ``d`` in ``dtype``: the rows kernel where
    an instance covers the width and x, w and out are 16-byte aligned, else
    the generic one."""
    inst = ROWS_INSTANCES.get(dtype, {}).get(d)
    if inst is None or not aligned:
        return Plan("generic")
    return Plan("rows", *inst)


def launch_shape(p: Plan, rows: int, sms: int) -> tuple:
    """``(groups, grid)`` of a rows-kernel launch: one row group a block
    while the rows fit on the SMs one each (a decode step: no SM holds two
    rows), else enough groups a block to spread the rows over the SMs, at
    most ``MAX_THREADS`` threads; the grid is capped at the blocks the SMs
    hold at once (by threads), and the rows spread evenly over the blocks'
    grid-stride loop."""
    if rows <= sms:
        groups = 1
    else:
        groups = min(max(1, MAX_THREADS // p.lanes), math.ceil(rows / sms))
    blocks = math.ceil(rows / groups)
    threads = math.ceil(groups * p.lanes / 32) * 32
    resident = sms * max(1, SM_THREADS // threads)
    if blocks > resident:
        blocks = math.ceil(blocks / math.ceil(blocks / resident))
    return groups, blocks


_SMS = {}


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev.index]


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 math, cast back)."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + w.float())).to(dt)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of ``x`` over its last axis: the plain version for a CPU
    tensor, a CUDA kernel for a CUDA tensor (raising on any input the
    kernels do not take)."""
    global launches, rows_launches, generic_launches
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    _build.refuse_fakes("rmsnorm", x, w)
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
    p = plan(d, x.dtype, aligned=(x.data_ptr() | w.data_ptr() | out.data_ptr()) % 16 == 0)
    groups, grid = launch_shape(p, rows, _sm_count(x.device)) if p.kernel == "rows" else (0, 0)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
            _DTYPES[x.dtype], float(eps), p.lanes, p.packs, groups, grid, stream,
        )
    _build.check(err, "rmsnorm_fwd")
    launches += 1
    if p.kernel == "rows":
        rows_launches += 1
    else:
        generic_launches += 1
    return out
