"""The port's counterparts of the reference's walkthroughs in ``examples/``.

Each module mirrors its script (the same steps in the same order and the
same printed lines) and runs as ``python -m repro_torch.examples.<name>``:

- ``quickstart``: the four Moirai steps on llama3.2-1b's fine graph (host
  code only);
- ``heterogeneous_placement``: the paper's Fig. 10 in miniature (placeto,
  m-SCT, GETF and Moirai on three paper graphs and two Table III
  clusters), placeto's policy on ``--device``;
- ``serve_demo``: plan → stage executor → continuous batching, then
  recovery from a device failure, on ``--device``;
- ``train_demo``: a small llama trained with checkpoints on ``--device``.

``--device`` defaults to ``cuda``: without a card those modules exit
non-zero with :func:`repro_torch.device.cuda_devices`'s message.
"""

from __future__ import annotations

import argparse
from typing import List

import torch

from repro_torch.device import cuda_devices


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the example runs (cuda: every visible card)",
    )


def devices_for(name: str) -> List[torch.device]:
    """The torch devices of ``--device name``: every visible card for
    ``cuda`` (a non-zero exit without one), else the CPU."""
    if name == "cpu":
        return [torch.device("cpu")]
    try:
        return cuda_devices()
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
