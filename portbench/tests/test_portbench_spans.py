"""The readers of the program's request stamps and the split of the
device's idle time by the engine's spans: by hand on synthetic records and
profiler events, and on one traced CPU run of the open cell at smoke size,
where the stamps are ordered against the harness's own times and feed no
reader that was there before them."""

import json
from types import SimpleNamespace

import pytest
import torch

from portbench.tests._tiny import tiny_cell
from portbench.harness import bench, spans, trace
from portbench.harness.driver import Window

NEW = ("admit_wait_ms_p95", "prefill_ms_p95")
SEED = 2**31 + 91


def _rec(due, ts, ta, tf, first=None, admitted=None, done=False):
    req = SimpleNamespace(t_submit=ts, t_admit=ta, t_first=tf, done=done)
    return SimpleNamespace(req=req, due=due, admitted=admitted,
                           tokens=[first] if first is not None else [])


def _run(recs, win=Window(start=10.0, end=20.0, last=20.5)):
    return bench.RunRecord(cfg={}, mix={}, window=win, recs=recs, setup_s=1.0)


def test_stamp_readers_by_hand():
    recs = [
        _rec(9.0, 9.0, 9.5, 9.9, admitted=9.6),             # due before the window
        _rec(10.0, 10.0, 10.1, 10.4, 10.5, admitted=10.15),
        _rec(11.0, 11.0, 11.3, 12.0, 12.1, admitted=11.35),
        _rec(12.0, 12.0, None, None, admitted=12.05, done=True),    # refused: waits 0
        _rec(19.0, 19.0, 19.2, 20.4, 20.5, admitted=19.25),  # first token after the end
        _rec(19.5, 19.5, None, None),                        # never admitted: end - t_submit
        _rec(19.8, 19.8, 20.3, None, admitted=20.35),        # admitted after the end
    ]
    run = _run(recs)
    wait, prefill = (bench.reader("metrics", n)(run) for n in NEW)
    # waits of the six due in the window: 0.1, 0.3, 0, 0.2, 0.5 and 0.2
    assert wait == pytest.approx(1e3 * (0.3 + 0.75 * (0.5 - 0.3)))
    # request by request no longer than the harness's due -> admission
    assert wait <= bench.reader("metrics", "queue_wait_ms_p95")(run)
    # first tokens in the window: 10.4 (after 0.3) and 12.0 (after 0.7)
    assert prefill == pytest.approx(1e3 * (0.3 + 0.95 * (0.7 - 0.3)))


def test_stamp_readers_say_nothing_without_stamps():
    for name in NEW:
        read = bench.reader("metrics", name)
        assert read(_run([])) is None
        # a program whose requests carry no stamps
        assert read(_run([SimpleNamespace(req=SimpleNamespace(), due=11.0, tokens=[12.0])])) is None


class _Event:
    def __init__(self, a, b, name, device=False, label=True):
        self._a, self._b, self._name, self._dev, self._label = a, b, name, device, label

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def name(self):
        return self._name

    def device_type(self):
        from torch._C._autograd import DeviceType

        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def is_user_annotation(self):
        return self._label


class _Results:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _timeline():
    host = [(0, 1000, trace.WINDOW_LABEL), (100, 900, "portbench.step"), (100, 850, "engine.step"),
            (110, 200, "engine.admit"), (200, 250, "engine.pack"), (250, 700, "engine.forward"),
            (255, 695, "portbench.forward"), (260, 690, "executor.stage"),
            (600, 690, "executor.sync"), (700, 720, "engine.readback"),
            (720, 840, "engine.commit")]
    ev = [_Event(a, b, n) for a, b, n in host]
    ev.append(_Event(270, 280, "cudaLaunchKernel", label=False))        # a host op
    ev += [_Event(a, b, "kernel", device=True, label=False)
           for a, b in ((0, 50), (300, 600), (650, 710))]
    return _Results(ev)


def test_idle_goes_to_the_innermost_engine_span():
    got = spans.idle_by_span(_timeline())
    s = 1e-9
    assert got.window_s == pytest.approx(1000 * s)
    want = {"outside": 200, "engine.step": 20, "engine.admit": 90, "engine.pack": 50,
            "engine.forward": 10, "executor.stage": 40, "executor.sync": 50,
            "engine.readback": 10, "engine.commit": 120}
    assert got.by_span == pytest.approx({k: v * s for k, v in want.items()})
    assert got.step_share == pytest.approx(29.0)
    assert got.forward_share == pytest.approx(10.0)
    assert got.outside_share == pytest.approx(20.0)
    # the parts make up the device's idle share that trace.read gives
    run = _run([])
    run.trace = trace.read(_timeline())
    idle = bench.reader("metrics", "device_idle_share")(run)
    assert got.step_share + got.forward_share + got.outside_share == pytest.approx(idle)
    assert spans.idle_by_span(_Results(_timeline().events()[:-3])) is None     # no device event


def test_a_traced_cpu_run_stamps_in_order_and_feeds_no_earlier_reader(monkeypatch):
    seen = {}
    real = bench.reader

    def capture(kind, name, root=bench.ROOT):
        fn = real(kind, name, root)

        def read(run):
            seen["run"] = run
            return fn(run)

        return read

    monkeypatch.setattr(bench, "reader", capture)
    torch.set_num_threads(2)
    cell = tiny_cell("qwen3-14b", "sysprompt-open")
    res = bench.run_cell(cell, SEED, 1.5, True, device="cpu", log=lambda m: None)
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert 0 <= m["admit_wait_ms_p95"] <= m["queue_wait_ms_p95"]
    assert m["prefill_ms_p95"] > 0
    run = seen["run"]
    served = [r for r in run.recs if r.tokens]
    assert served
    for r in served:
        q = r.req
        assert r.due <= q.t_submit <= q.t_admit <= q.t_first <= r.tokens[0]
    old = [p["name"] for p in cell.per_layer if p["name"] not in NEW]
    before = {n: real("metrics", n)(run) for n in old}
    for r in run.recs:
        r.req.t_submit = r.req.t_admit = r.req.t_first = None
    assert {n: real("metrics", n)(run) for n in old} == before
    assert [real("metrics", n)(run) for n in NEW] == [None, None]


def test_the_phases_tool_reads_the_spans_of_a_tiny_run(capsys):
    from portbench import phases

    torch.set_num_threads(2)
    assert phases.main(["--workload", "qwen3-14b.sysprompt-open", "--seed", str(SEED),
                        "--seconds", "1.5", "--trace", "1", "--recorder", "on", "off",
                        "--tiny"]) == 0
    lines = [json.loads(x.split(" ", 1)[1]) for x in capsys.readouterr().out.splitlines()
             if x.startswith("PHASES ")]
    on, off = lines
    assert (on["recorder"], off["recorder"]) == ("on", "off") and on["seed"] == off["seed"]
    assert on["correct"] and off["correct"], (on["check"], off["check"])
    assert on["ring"]["dropped"] == 0 and on["ring"]["in_window"] > 0
    assert {"engine.step", "engine.admit", "engine.forward", "executor.stage"} <= set(on["phase_ms"])
    assert on["admit_host_ms"]["n"] >= 1 and sum(on["waited"].values()) == on["phase_ms"][
        "engine.admit"]["n"]
    for run in lines:
        assert run["stamps"]["checked"] > 0 and run["stamps"]["out_of_order"] == 0
    # each traced step's profiler range is paired with its ring span (a few
    # can differ more where a loaded host descheduled the thread between
    # the two clock reads)
    ts = on["traced_steps"]
    assert ts["paired"] == ts["ranges"] > 0 and ts["duration_diff_ms"]["p50"] < 1.0
    # no device on the CPU: no idle split; with the recorder off, no ring
    assert "split" not in on and "ring" not in off and "traced_steps" not in off
