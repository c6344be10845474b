"""Operations and bytes of one grouped GEMM call ``x [M, K] @ w[e]
[K, N]`` per expert group, from the call's group sizes.

Operations ``2 · M · K · N`` over the rows the call received.  Bytes: the
weights of the experts that received rows (``K · N`` each), the rows in
(``M · K``) and out (``M · N``), at ``itemsize`` bytes each.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def call(group_sizes: Sequence[int], k: int, n: int, itemsize: int = 2) -> Tuple[float, float]:
    m = int(sum(int(g) for g in group_sizes))
    touched = sum(1 for g in group_sizes if int(g) > 0)
    ops = 2.0 * m * k * n
    nbytes = itemsize * (touched * k * n + m * k + m * n)
    return ops, nbytes
