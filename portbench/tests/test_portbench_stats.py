"""Tails over every sample, with the unserved-at-end rule."""

import numpy as np

from portbench.harness import stats
from portbench.harness.driver import Rec, Window
from portbench.harness.traffic import Planned


class _Req:
    def __init__(self, n):
        self.out_tokens = [0] * n


def _rec(due, tokens, admitted=None):
    return Rec(planned=Planned(index=0, prompt=[1], max_new=len(tokens)), req=_Req(len(tokens)),
               due=due, sent=due, admitted=admitted, tokens=list(tokens))


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        x = rng.random(n)
        for p in (50, 95, 99):
            assert abs(stats.percentile(x, p) - np.percentile(x, p)) < 1e-12
    assert stats.percentile([], 95) is None


def test_tails_window_rules():
    win = Window(start=10.0, end=20.0, last=20.1)
    recs = [
        _rec(5.0, [9.0, 11.0, 12.5]),          # due before the window: not a TTFT sample
        _rec(12.0, [13.0, 13.5], admitted=12.5),
        _rec(18.0, [], admitted=None),          # unserved at the end: counts 20 − 18
        _rec(19.0, [20.05], admitted=19.5),     # first token in the last step
    ]
    assert stats.output_tokens(recs, win) == 4
    assert sorted(stats.itl_gaps(recs, win)) == [0.5, 1.5, 2.0]
    assert sorted(stats.ttft(recs, win)) == [1.0, 1.0500000000000007, 2.0]
    assert sorted(stats.queue_wait(recs, win)) == [0.5, 0.5, 2.0]
    p95 = stats.percentile(stats.ttft(recs, win), 95)
    assert abs(p95 - np.percentile([1.0, 1.05, 2.0], 95)) < 1e-9


def test_watch_summarises_the_window_steps():
    from portbench.harness.watch import Watch

    w = Watch(cuda=False)
    w.start()
    for i in range(40):
        w.step(float(i), i + (0.2 if i == 7 else 0.1))
    w.stop()
    line = w.summary()
    assert line.startswith("40 steps, wall p50 100.000 ")
    assert "max 200.000 ms" in line and "full collections" in line
    assert w._on_gc not in __import__("gc").callbacks
    assert Watch(cuda=False).summary() == "no steps in the window"
