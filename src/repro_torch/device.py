"""Where the port runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import List

import torch


def cuda_devices() -> List[torch.device]:
    """Every visible CUDA card; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' (devices=[torch.device('cpu')] "
            "for the engine) to run on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_device(device=None) -> torch.device:
    """``device``, or the first card when it is None."""
    if device is not None:
        return torch.device(device)
    return cuda_devices()[0]
