"""Operations and bytes of one flash-attention call (one layer of one
forward), from each row's ``q_len`` and ``cache_pos``.

Query i of a row at depth ``c`` sees ``c + i + 1`` keys (causal), so a row
needs ``4 · H · D · (q·c + q(q+1)/2)`` operations (scores and the weighted
sum).  Bytes: each valid query row read and its output written
(``2 · q · H · D`` elements), and the row's keys and values read once
(``2 · (c + q) · KV · D`` elements), at ``itemsize`` bytes each.  Rows
with ``q_len`` 0 need nothing.  The page table's reads are left out.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def call(q_lens: Sequence[int], cache_pos: Sequence[int], heads: int, kv_heads: int,
         head_dim: int, itemsize: int = 2) -> Tuple[float, float]:
    ops = 0.0
    nbytes = 0.0
    for q, c in zip(q_lens, cache_pos):
        q, c = int(q), int(c)
        if q <= 0:
            continue
        ops += 4.0 * heads * head_dim * (q * c + q * (q + 1) / 2)
        nbytes += itemsize * head_dim * (2 * q * heads + 2 * (c + q) * kv_heads)
    return ops, nbytes
