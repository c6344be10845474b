"""What a traced run's profiler saw on the device.

The device events are read from the profiler's raw kineto results (its
per-op event tree takes minutes to build for a window and is not needed),
as ``chip_smoke.py``'s ``device_events`` reads them: device time by kernel
name, and the union of the events' intervals as busy time, so kernels that
overlap count once.  Here everything is clipped to the window, which the
harness marks with a ``portbench.window`` label on the host; the label and
the device events share the profiler's clock.  Idle gaps are named by what
the host was doing when they began: the innermost harness label
(``portbench.step``, ``portbench.forward``) and the innermost host
operation then running.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_LABEL = "portbench.window"
# the device trace covers the measured window's last this many seconds:
# stopping a trace takes ~10 s a traced second of serving, so a whole
# window's would take minutes
TRACE_SECONDS = 10.0


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    by_name: Dict[str, Tuple[float, int]]          # name -> (device seconds, calls)
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest idle gaps

    def seconds_of(self, needles) -> Optional[float]:
        """Device seconds of the kernels whose name holds any of
        ``needles``; None when there is none."""
        hits = [s for name, (s, _) in self.by_name.items() if any(n in name for n in needles)]
        return sum(hits) if hits else None

    def top_ops(self, n: int = 10) -> List[list]:
        rows = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name, s] for name, (s, _) in rows]


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Profiler:
    """torch.profiler's kineto session driven directly: prepared in set-up
    (the tracer's own start-up stays out of the window), started
    :data:`TRACE_SECONDS` before the window's end, and stopped after it
    without building the profiler's per-op event tree, which is not
    needed here."""

    def __init__(self, cuda: bool):
        from torch.autograd import profiler

        self._p = profiler.profile(use_device="cuda" if cuda else None, use_kineto=True)
        self._label = None
        self.cuda = cuda

    def prepare(self) -> None:
        self._p._prepare_trace()

    def start(self) -> None:
        import torch

        self._p._start_trace()
        self._label = torch.profiler.record_function(WINDOW_LABEL)
        self._label.__enter__()

    def stop(self):
        """Stop tracing; returns the profiler's raw results."""
        import torch
        from torch.autograd import _disable_profiler

        self._label.__exit__(None, None, None)
        if self.cuda:
            torch.cuda.synchronize()
        return _disable_profiler()


def read(results, n_gaps: int = 10) -> Optional[DeviceTrace]:
    """The device trace of the raw profiler ``results`` inside the
    ``portbench.window`` label, or None when the profiler recorded no
    device event there."""
    from torch._C._autograd import DeviceType

    events = results.events()
    win = None
    host: List[Tuple[int, int, str, bool]] = []
    dev: List[Tuple[int, int, str]] = []
    for e in events:
        start, end = e.start_ns(), e.end_ns()
        if end <= start:
            continue
        on_device = e.device_type() == DeviceType.CUDA
        if e.is_user_annotation():
            if e.name() == WINDOW_LABEL and not on_device:
                win = (start, end)
            elif not on_device:
                host.append((start, end, e.name(), True))
            continue
        if on_device:
            dev.append((start, end, e.name()))
        else:
            host.append((start, end, e.name(), False))
    if win is None:
        return None
    w0, w1 = win
    by_name: Dict[str, Tuple[float, int]] = {}
    spans = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        spans.append((a, b))
        s, n = by_name.get(name, (0.0, 0))
        by_name[name] = (s + (b - a) / 1e9, n + 1)
    if not spans:
        return None
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) / 1e9
    # idle gaps inside the window, longest first, each named by the host
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((a - prev, prev))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((w1 - prev, prev))
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for length, at in gaps[:n_gaps]:
        i = bisect.bisect_right(starts, at)
        label, op = "harness", None
        label_start, op_start = -1, -1
        for a, b, name, is_label in host[max(0, i - 20000): i]:
            if a <= at < b:
                if is_label and a >= label_start:
                    label, label_start = name, a
                elif not is_label and a >= op_start:
                    op, op_start = name, a
        named.append((label + (f" / {op}" if op else ""), length / 1e9))
    return DeviceTrace(window_s=(w1 - w0) / 1e9, busy_s=busy_s, by_name=by_name, gaps=named)
