"""Published peaks, by the name ``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
power limit: 989 TFLOP/s in bf16 and fp16, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}


def of(kind: Optional[str]) -> Optional[dict]:
    """The peaks of the chip named ``kind``, or None for one not listed."""
    return PEAKS.get(kind) if kind else None


def bound_s(ops: float, nbytes: float, peak: dict) -> float:
    """The least time the chip could take: the larger of the operations
    over peak FLOP/s and the bytes over peak bandwidth."""
    return max(ops / peak["bf16_flops"], nbytes / peak["hbm_bytes_s"])
