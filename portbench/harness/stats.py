"""The end-to-end numbers of a run, from the driver's records: output
tokens per second, the tails of inter-token gaps, of time to first token
and of queue wait.  Tails are taken over every sample, with the rule that a
request left unserved at the window's end counts with (end − due)."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """The ``p``-th percentile (0–100) of ``values`` by linear interpolation
    between order statistics (numpy's default), or None when empty."""
    xs = sorted(values)
    if not xs:
        return None
    k = (len(xs) - 1) * p / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def output_tokens(recs, win) -> int:
    """Served tokens emitted inside the window."""
    return sum(1 for r in recs for t in r.tokens if win.start <= t <= win.end)


def itl_gaps(recs, win) -> List[float]:
    """Every gap between consecutive tokens of a request whose later token
    was emitted inside the window, in seconds."""
    out = []
    for r in recs:
        ts = r.tokens
        for a, b in zip(ts, ts[1:]):
            if win.start <= b <= win.end:
                out.append(b - a)
    return out


def due_in_window(recs, win):
    return [r for r in recs if win.start <= r.due <= win.end]


def ttft(recs, win) -> List[float]:
    """First-token time − due of every request due in the window; one
    still without a token at the window's end counts with (end − due)."""
    return [(r.tokens[0] if r.tokens else win.end) - r.due for r in due_in_window(recs, win)]


def queue_wait(recs, win) -> List[float]:
    """Admission to a slot − due of every request due in the window; one
    not admitted by the window's end counts with (end − due)."""
    return [(r.admitted if r.admitted is not None else win.end) - r.due
            for r in due_in_window(recs, win)]
