"""Spans of the serving engine and its stage executor.

A :class:`SpanRecorder` is off until an engine is given one
(``engine.tracer = SpanRecorder()``; ``engine.tracer = None`` turns it off
again).  While off, :func:`span` hands back one shared no-op context
(:data:`OFF`): nothing is recorded, no profiler is called and nothing is
allocated.  While on, each span that closes goes into a bounded ring
(:attr:`SpanRecorder.spans`) as a :class:`Span`: its name, its start and
end in ``time.perf_counter_ns()`` and its attributes.  Spans close
innermost first, so a step's phases stand in the ring before the step's
own span.  When the ring is full its oldest span is dropped and counted
(:attr:`SpanRecorder.dropped`).

While ``torch.profiler`` records, each span is also a profiler range of
the same name (``record_function``), so it lies on the profiler's
timeline beside the device's events.

Span names (``engine.*``, ``executor.*``) and their attributes are listed
in the engine's and the executor's docstrings.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, Optional

import torch


class _Off:
    """The span of a recorder that is off: one shared object that enters,
    leaves and is falsy, so ``if sp: sp.set(...)`` skips the attributes."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


OFF = _Off()


def span(recorder: Optional["SpanRecorder"], name: str):
    """``recorder.span(name)``, or :data:`OFF` when ``recorder`` is None."""
    return OFF if recorder is None else recorder.span(name)


class Span:
    """One span: ``name``, ``start_ns`` / ``end_ns`` (``perf_counter_ns``)
    and ``attrs``."""

    __slots__ = ("name", "start_ns", "end_ns", "attrs", "_rec", "_range")

    def __init__(self, rec: "SpanRecorder", name: str, attrs: Dict[str, Any]):
        self._rec = rec
        self._range = None
        self.name = name
        self.attrs = attrs
        self.start_ns = self.end_ns = 0

    def set(self, **attrs) -> None:
        """Add or replace attributes (those known only once the work ran)."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        if torch.autograd._profiler_enabled():
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        self._rec._close(self)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        return False

    def __repr__(self) -> str:
        return f"Span({self.name!r}, {self.seconds * 1e3:.3f} ms, {self.attrs})"


class SpanRecorder:
    """The ring of closed spans, ``capacity`` of them, oldest dropped first."""

    def __init__(self, capacity: int = 1 << 16):
        self.spans: Deque[Span] = deque(maxlen=capacity)
        self.dropped = 0

    def span(self, name: str, **attrs) -> Span:
        """A span named ``name``, recorded when its ``with`` block ends."""
        return Span(self, name, attrs)

    def _close(self, sp: Span) -> None:
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append(sp)
