"""Drive the engine with a run's traffic: warm up the cell's shapes, bring
the traffic to its steady state, then measure for ``--seconds``.

Token times are read on the host right after each ``step()`` returns: the
step ends in a read of the argmax on the host, so each new token of a
request is an emission at that time.  A closed loop's client sends its
next request at the time its last one is seen finished (due then); an open
loop's request is due at its planned offset after the traffic starts, and
is sent at the first check after that (how late is recorded).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional

from . import program
from .traffic import Planned, Traffic
from .watch import Watch


@dataclass
class Rec:
    """One sent request and what the harness saw of it."""

    planned: Planned
    req: object
    due: float
    sent: float
    admitted: Optional[float] = None
    tokens: List[float] = field(default_factory=list)   # emission time of each served token
    done: Optional[float] = None


@dataclass
class Window:
    start: float
    end: float          # start + seconds: the window's nominal end
    last: float         # the last observation (the first step return at or after ``end``)


class Driver:
    """One run's loop over the engine."""

    def __init__(self, eng, traffic: Traffic, clock: Callable[[], float] = time.perf_counter,
                 probes: Optional[program.Probes] = None, watch: Optional[Watch] = None):
        self.eng = eng
        self.traffic = traffic
        self.mix = traffic.mix
        self.clock = clock
        self.probes = probes
        self.watch = watch
        self.recs: List[Rec] = []
        self._next = 0
        self._inflight: List[Rec] = []
        self._waiting: Deque[Rec] = deque()
        self.steps: List[tuple] = []    # traced run: (t0, t1, forwards before, forwards after)
        self.tracing = False
        self.lateness: List[float] = []
        self.pool_at_start = None
        self.pool_at_end = None
        self.queue_at_start = 0

    # ------------------------------------------------------------ set-up
    def warm_shapes(self, extra_prompts: List[List[int]] = ()) -> None:
        """Run the cell's own step shapes once on every slot: one fused
        ``[slots, prefill_chunk]`` step, then ``[slots, 1]`` decode steps;
        then ``extra_prompts`` (a mix's shared prefixes, registered in the
        KV pool for the traffic to find) one a slot."""
        slots = self.eng.slots
        for i in range(slots):
            self.eng.submit(program.make_request(-1 - i, [1 + i % 7, 2], 3))
        self._drain()
        for j, prompt in enumerate(extra_prompts):
            self.eng.submit(program.make_request(-1 - slots - j, list(prompt) + [1], 1))
        self._drain()

    def _drain(self) -> None:
        while self.eng.queue or any(r is not None for r in self.eng.active):
            self.eng.step()
        self._sync()

    def _sync(self) -> None:
        import torch

        dev = self.eng.devices[0]
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)

    # ------------------------------------------------------------ traffic
    def _send(self, now: float, due: float) -> None:
        if self._next >= len(self.traffic.planned):
            raise RuntimeError("the traffic ran out of planned requests: raise the mix's "
                               "max_requests_per_s")
        p = self.traffic.planned[self._next]
        self._next += 1
        req = program.make_request(p.index, list(p.prompt), p.max_new)
        rec = Rec(planned=p, req=req, due=due, sent=now)
        self.recs.append(rec)
        self._inflight.append(rec)
        self._waiting.append(rec)
        self.eng.submit(req)
        self.lateness.append(now - due)

    def _observe(self, t: float) -> None:
        while self._waiting and self._waiting[0].req.started:
            self._waiting.popleft().admitted = t
        still = []
        for rec in self._inflight:
            n = len(rec.req.out_tokens)
            if n > len(rec.tokens):
                rec.tokens.extend([t] * (n - len(rec.tokens)))
            if rec.req.done:
                rec.done = t
                if rec.admitted is None:
                    rec.admitted = t
            else:
                still.append(rec)
        finished = len(self._inflight) - len(still)
        self._inflight = still
        if self.mix["loop"] == "closed":
            for _ in range(finished):
                self._send(t, t)

    def run(self, seconds: float, on_window_start: Callable[[], None] = lambda: None,
            tail_s: float = 0.0, on_tail_start: Callable[[], None] = lambda: None) -> Window:
        """Send the traffic, warm it up to its steady state, then measure
        ``seconds``; returns the window.  ``on_tail_start`` is called once,
        between steps, when ``tail_s`` seconds of the window are left."""
        import torch

        mix = self.mix
        t0 = self.clock()
        if mix["loop"] == "closed":
            for _ in range(mix["clients"]):
                self._send(t0, t0)
        steps = 0
        start = end = tail = None
        while True:
            now = self.clock()
            if mix["loop"] == "open":
                while (self._next < len(self.traffic.planned)
                       and t0 + self.traffic.planned[self._next].offset_s <= now):
                    self._send(now, t0 + self.traffic.planned[self._next].offset_s)
                if not self._inflight and not self.eng.queue:
                    nxt = t0 + self.traffic.planned[self._next].offset_s
                    time.sleep(max(0.0, min(nxt - now, 0.05)))
                    now = self.clock()
            if start is None:
                warm = (steps >= mix["warmup_steps"] if mix["loop"] == "closed"
                        else now - t0 >= mix["warmup_s"])
                if warm:
                    self._sync()
                    on_window_start()
                    self.pool_at_start = program.pool_counters(self.eng)
                    self.queue_at_start = len(self.eng.queue)
                    if self.watch is not None:
                        self.watch.start()
                    start = self.clock()
                    end = start + seconds
                    tail = max(start, end - tail_s)
            if tail is not None and now >= tail:
                on_tail_start()
                tail = None
            s0 = self.clock()
            if self.tracing:
                nf = len(self.probes.forwards)
                with torch.profiler.record_function("portbench.step"):
                    self.eng.step()
                t = self.clock()
                self.steps.append((s0, t, nf, len(self.probes.forwards)))
            else:
                self.eng.step()
                t = self.clock()
            steps += 1
            if start is not None and self.watch is not None:
                self.watch.step(s0, t)
            self._observe(t)
            if end is not None and t >= end:
                if self.watch is not None:
                    self.watch.stop()
                self.pool_at_end = program.pool_counters(self.eng)
                return Window(start=start, end=end, last=t)
