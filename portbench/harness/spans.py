"""The device's idle time put down to the program's phases.

Each instant of the traced window (the ``portbench.window`` label, as in
``trace.py``) in which no operation ran on the card goes to the innermost
``engine.*`` or ``executor.*`` profiler range open on the host at that
instant, or to ``outside`` when none is open (the harness's own work
between steps).  Those ranges are the serving engine's spans
(``repro_torch/serving/tracing.py``), which open only while the engine has
a span recorder.  Idle under ``engine.forward`` or an ``executor.*`` span
is the forward's dispatch and launches; idle under any other ``engine.*``
span is the step's own host work around its forward.

``idle_by_span`` reads the same raw profiler results as ``trace.read``, so
the parts sum to the window's idle time there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import trace

PREFIXES = ("engine.", "executor.")
FORWARD = ("engine.forward", "executor.")
OUTSIDE = "outside"


@dataclass
class IdleSplit:
    window_s: float
    by_span: Dict[str, float]     # innermost span name (or ``outside``) -> idle seconds

    def _share(self, pick) -> float:
        return 100.0 * sum(s for name, s in self.by_span.items() if pick(name)) / self.window_s

    @property
    def step_share(self) -> float:
        """Idle under ``engine.*`` spans other than the forward, % of the window."""
        return self._share(lambda n: n.startswith("engine.") and not n.startswith(FORWARD))

    @property
    def forward_share(self) -> float:
        """Idle under ``engine.forward`` and the executor's spans, % of the window."""
        return self._share(lambda n: n.startswith(FORWARD))

    @property
    def outside_share(self) -> float:
        return self._share(lambda n: n == OUTSIDE)


def split_idle(window: Tuple[int, int], device: List[Tuple[int, int]],
               ranges: List[Tuple[int, int, str]]) -> IdleSplit:
    """Idle time of ``window`` (ns) outside the union of the ``device``
    intervals, each piece under the innermost of ``ranges`` (``(start,
    end, name)``, nested as a thread's ranges are) open there."""
    w0, w1 = window
    busy = trace._union([(max(a, w0), min(b, w1)) for a, b in device if min(b, w1) > max(a, w0)])
    idle, prev = [], w0
    for a, b in busy:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        idle.append((prev, w1))
    # range boundaries in time order; at one instant ends before starts
    marks = sorted([(a, 1, i) for i, (a, _, _) in enumerate(ranges)]
                   + [(b, 0, i) for i, (_, b, _) in enumerate(ranges)])
    out: Dict[str, float] = {}
    open_: List[int] = []
    j = 0
    for t, end in idle:
        while t < end:
            while j < len(marks) and marks[j][0] <= t:
                _, starts, i = marks[j]
                if starts:
                    open_.append(i)
                else:
                    open_.remove(i)
                j += 1
            nxt = min(end, marks[j][0]) if j < len(marks) else end
            name = ranges[open_[-1]][2] if open_ else OUTSIDE
            out[name] = out.get(name, 0.0) + (nxt - t) / 1e9
            t = nxt
    return IdleSplit(window_s=(w1 - w0) / 1e9, by_span=out)


def idle_by_span(results) -> Optional[IdleSplit]:
    """:func:`split_idle` of the raw profiler ``results`` (as ``trace.read``
    takes them), or None when there is no window label or no device event."""
    from torch._C._autograd import DeviceType

    win = None
    device: List[Tuple[int, int]] = []
    ranges: List[Tuple[int, int, str]] = []
    for e in results.events():
        start, end = e.start_ns(), e.end_ns()
        if end <= start:
            continue
        on_device = e.device_type() == DeviceType.CUDA
        if e.is_user_annotation():
            if not on_device:
                if e.name() == trace.WINDOW_LABEL:
                    win = (start, end)
                elif e.name().startswith(PREFIXES):
                    ranges.append((start, end, e.name()))
        elif on_device:
            device.append((start, end))
    if win is None or not device:
        return None
    return split_idle(win, device, ranges)
