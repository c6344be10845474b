"""Qwen2-VL-style M-RoPE position streams of a prompt, shared by the VLM
parity tests (``test_torch_vlm.py``) and ``chip_smoke.py``'s VLM phases."""

import numpy as np


def image_streams(text_before: int, rows: int, cols: int, text_after: int) -> np.ndarray:
    """(t, h, w) streams ``[3, S]`` of a prompt: text at t = h = w = its
    index, then a ``rows x cols`` patch grid at one t with h and w its row
    and column from there, then text resuming at the largest position so
    far + 1."""
    text = np.arange(text_before)
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    img = np.stack([np.full(rows * cols, text_before), text_before + r.ravel(),
                    text_before + c.ravel()])
    after = img.max() + 1 + np.arange(text_after)
    return np.concatenate([np.stack([text] * 3), img, np.stack([after] * 3)], axis=1)
