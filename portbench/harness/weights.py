"""The benchmark's weights: random, from ``--seed``, made on the card in a
few large calls, in the type they are served in.

The layout is the checkpoint the program serves from: one dict per layer
under ``"layers"``, matrices in ``x @ w`` orientation (``[d_in, d_out]``),
experts stacked ``[E, d_in, d_out]``, norm weights float32 in offset form.
The same tensors go to the program and to the reference.  Leaves of one
(type, scale) share one flat buffer, filled by one ``normal_`` call on the
card's generator; each leaf is a view of it.

Each reference family states its layout and scales
(``reference/<model_type>.py``: ``layout``).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

from portbench.reference import family


def layout(cfg: dict) -> List[Tuple[tuple, tuple, torch.dtype, float]]:
    """Every leaf of ``cfg``'s weights, ``(path, shape, dtype, std)`` in a
    fixed order, as its reference family lays them out."""
    return family(cfg["model_type"]).layout(cfg)


def _put(tree: dict, path: tuple, leaf: torch.Tensor) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = leaf


def _aligned(n: int) -> int:
    """``n`` elements rounded up to a multiple of 128, so that every leaf
    starts 256-byte aligned (the kernels copy in 16-byte pieces)."""
    return -(-n // 128) * 128


def make(cfg: dict, seed: int, device) -> Dict:
    """The weights of ``cfg`` from ``seed`` on ``device``: one flat buffer
    and one ``normal_`` call per (type, scale)."""
    leaves = layout(cfg)
    groups: "OrderedDict[tuple, list]" = OrderedDict()
    for path, shape, dt, std in leaves:
        groups.setdefault((dt, std), []).append((path, shape))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: dict = {}
    for (dt, std), items in groups.items():
        total = sum(_aligned(math.prod(s)) for _, s in items)
        buf = torch.empty(total, dtype=dt, device=device)
        buf.normal_(0.0, std, generator=gen)
        off = 0
        for path, shape in items:
            n = math.prod(shape)
            _put(tree, path, buf[off : off + n].view(shape))
            off += _aligned(n)
    return tree

