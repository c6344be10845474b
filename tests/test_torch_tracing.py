"""The serving engine's spans and request stamps (``serving/tracing.py``),
on CPU smoke engines: dense, paged with prefix sharing, the unfused paths
and speculation.  Each step is one ``engine.step`` with its phases nested
inside it; the stamps are ordered and keep their first values; with the
recorder off nothing is recorded and no profiler range opens; under the
profiler every span is a range of its name and of its duration."""

import dataclasses
import math
import statistics

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import init_params
from repro_torch.core.devices import h100_cluster
from repro_torch.core.placement import PlanConfig
from repro_torch.serving import tracing
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.tracing import SpanRecorder

CPU = [torch.device("cpu")]
PHASES = {"engine.admit", "engine.draft", "engine.pack", "engine.forward", "engine.readback",
          "engine.commit", "engine.observe"}
ROWS = ("decode", "verify", "prefill", "idle")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("llama3.2-1b").smoke(), attention_impl="pallas")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


MODES = {
    "fused": dict(prefill_chunk=8),
    "paged": dict(prefill_chunk=8, plan=dict(kv_page_tokens=8)),
    "interleaved": dict(prefill_chunk=8, fused=False),
    "blocking": dict(prefill_chunk=None),
    "lockstep": dict(prefill_chunk=8, batching="lockstep"),
    "speculative": dict(prefill_chunk=4, plan=dict(spec_tokens=3), draft=True),
}


def _engine(model, mode, cluster=None, **extra):
    cfg, params = model
    kw = dict(MODES[mode])
    plan = dict(method="etf", **kw.pop("plan", {}))
    if kw.pop("draft", False):
        kw.update(draft_cfg=cfg, draft_params=params)
    return ServingEngine(cfg, params, cluster or h100_cluster(1), devices=CPU, slots=3,
                         max_len=64, plan_cfg=PlanConfig(**plan), eos_id=-1, **kw, **extra)


PREFIX = [5 + i for i in range(16)]


def _requests(n=5):
    """Every other request opens with one 16-token prefix (two pages of 8)."""
    return [Request(rid=i, prompt=(PREFIX if i % 2 == 0 else []) + [40 + i] * (3 + 2 * i),
                    max_new_tokens=3 + i % 3) for i in range(n)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.queue or any(r is not None for r in eng.active):
        eng.step()
        steps += 1
    return steps


def _by_step(rec):
    """The ring cut into steps: spans close innermost first, so each step's
    spans run up to and include its ``engine.step``."""
    out, cur = [], []
    for sp in rec.spans:
        cur.append(sp)
        if sp.name == "engine.step":
            out.append(cur)
            cur = []
    assert not cur, cur
    return out


def _parent(spans, i):
    """The span that encloses ``spans[i]``: the first after it in closing
    order whose interval holds it (None for the step's own span)."""
    s = spans[i]
    for p in spans[i + 1:]:
        if p.start_ns <= s.start_ns and s.end_ns <= p.end_ns:
            return p
    return None


@pytest.mark.parametrize("mode", list(MODES))
def test_each_step_is_one_span_with_its_phases_nested(model, mode):
    eng = _engine(model, mode)
    rec = SpanRecorder()
    eng.tracer = rec
    reqs = _requests()
    steps = _serve(eng, reqs)
    assert rec.dropped == 0
    groups = _by_step(rec)
    assert len(groups) == steps
    names = set()
    for spans in groups:
        root = spans[-1]
        assert [s.name for i, s in enumerate(spans) if _parent(spans, i) is None] == ["engine.step"]
        for i, s in enumerate(spans[:-1]):
            names.add(s.name)
            parent = _parent(spans, i)
            if parent is root:
                assert s.name in PHASES, s
            elif s.name == "executor.stage":
                assert parent.name in ("engine.forward", "engine.draft"), s
            elif s.name == "executor.sync":
                assert parent.name == "executor.stage"
            else:
                # a blocking prefill runs inside admission
                assert parent.name == "engine.admit" and mode in ("blocking", "lockstep"), s
        a = root.attrs
        assert sum(a[k] for k in ROWS) == eng.slots and min(a[k] for k in ROWS) >= 0
        assert a["q"] >= a["decode"] + a["verify"] + a["prefill"]
        if a["S"]:
            assert any(s.name == "engine.forward" for s in spans)
    names.add("engine.step")
    assert {"engine.step", "engine.admit", "engine.forward", "engine.readback",
            "engine.commit", "executor.stage"} <= names
    assert ("engine.draft" in names) == (mode == "speculative")
    admits = [s for s in rec.spans if s.name == "engine.admit"]
    assert sum(s.attrs["admitted"] for s in admits) == len(reqs)
    assert {s.attrs["waited"] for s in admits} <= {None, "slots", "width", "pool", "depth"}
    # 5 requests, 3 slots; lockstep admits only at the batch's depth
    want = "depth" if mode == "lockstep" else "slots"
    assert any(s.attrs["waited"] == want for s in admits)
    if mode == "speculative":
        assert any(s.attrs["verify"] for s in rec.spans if s.name == "engine.step")
    for r in reqs:
        assert r.state == "finished"
        assert r.t_submit <= r.t_admit <= r.t_first


def test_a_hot_swap_keeps_the_first_stamps(model):
    eng = _engine(model, "fused", cluster=h100_cluster(2))
    rec = SpanRecorder()
    eng.tracer = rec
    reqs = _requests(3)
    for r in reqs:
        eng.submit(r)
    for _ in range(50):
        if all(r.t_first for r in reqs):
            break
        eng.step()
    assert all(r.t_first for r in reqs)
    first = [(r.t_submit, r.t_admit, r.t_first) for r in reqs]
    eng.on_device_failure(1)
    assert eng.executor.tracer is rec       # the new executor records too
    n = len(rec.spans)
    eng.run_until_drained()
    after = list(rec.spans)[n:]
    # the re-queued requests prefill again, on the new executor
    assert any(s.name == "engine.step" and s.attrs["prefill"] for s in after)
    assert any(s.name == "executor.stage" for s in after)
    for r, stamps in zip(reqs, first):
        assert r.state == "finished" and r.out_tokens
        assert (r.t_submit, r.t_admit, r.t_first) == stamps


def test_a_shared_prefix_skips_its_chunks(model):
    eng = _engine(model, "paged")
    pool = eng._kv_pool
    alloc, reuse = pool.alloc_sequence, {}

    def record(slot, tokens, total_len):
        got = alloc(slot, tokens, total_len)
        reuse[len(tokens)] = got[0]
        return got

    pool.alloc_sequence = record
    rec = SpanRecorder()
    eng.tracer = rec

    def chunks():
        # prompt chunks forwarded: a step's ``prefill`` counts its rows that carried one
        got = sum(s.attrs["prefill"] for s in rec.spans if s.name == "engine.step")
        rec.spans.clear()
        return got

    first = Request(rid=0, prompt=PREFIX + [3, 4], max_new_tokens=2)
    _serve(eng, [first])
    chunk = eng.prefill_chunk
    assert chunks() == math.ceil(len(first.prompt) / chunk)
    later = [Request(rid=i, prompt=PREFIX + [50 + i] * (2 + 7 * i), max_new_tokens=2)
             for i in (1, 2)]
    _serve(eng, later)
    for r in later:
        assert reuse[len(r.prompt)] >= 16
    assert chunks() == sum(math.ceil((len(r.prompt) - reuse[len(r.prompt)]) / chunk)
                           for r in later)


def _profile(fn):
    from torch.autograd import _disable_profiler

    p = torch.autograd.profiler.profile(use_kineto=True)
    p._prepare_trace()
    p._start_trace()
    try:
        fn()
    finally:
        res = _disable_profiler()
    return [e for e in res.events() if e.is_user_annotation()]


def test_off_records_nothing_and_opens_no_range(model):
    on, off = _engine(model, "paged"), _engine(model, "paged")
    rec = on.record_spans()
    assert on.tracer is rec and on.executor.tracer is rec
    a, b = _requests(), _requests()
    _serve(on, a)
    ranges = _profile(lambda: _serve(off, b))
    assert not [e for e in ranges if e.name().startswith(("engine.", "executor."))]
    assert off.tracer is None and off.executor.tracer is None
    assert [r.out_tokens for r in a] == [r.out_tokens for r in b]
    assert all(r.t_first is not None for r in b)          # stamps are always on
    # turned off again: the recorder keeps what it had and gets nothing more
    n = len(rec.spans)
    on.tracer = None
    assert on.executor.tracer is None
    _serve(on, _requests())
    assert len(rec.spans) == n
    assert tracing.span(None, "engine.step") is tracing.OFF and not tracing.OFF


def test_every_span_is_a_profiler_range_of_its_name_and_duration(model):
    eng = _engine(model, "paged")
    with torch.autograd.profiler.record_function("warm"):   # the range's first call
        pass
    rec = SpanRecorder()
    eng.tracer = rec
    ranges = _profile(lambda: _serve(eng, _requests()))
    assert len(rec.spans) > 50
    # the n-th range of a name (by start) is the n-th span of that name (by
    # start).  It opens before the span reads the clock and closes after, so
    # it is never shorter on the profiler's clock; it is longer by the
    # profiler's own work, which a descheduled thread can stretch in a few
    # (a loaded host), so the typical excess is held by the median
    got, want = {}, {}
    for e in sorted(ranges, key=lambda e: e.start_ns()):
        got.setdefault(e.name(), []).append(e.end_ns() - e.start_ns())
    for sp in sorted(rec.spans, key=lambda s: s.start_ns):
        want.setdefault(sp.name, []).append(sp.end_ns - sp.start_ns)
    assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()}
    excess = []
    for name in want:
        for a, b in zip(got[name], want[name]):
            assert a >= b - 50_000, (name, a, b)
            excess.append(a - b)
    assert statistics.median(excess) < 1e6, sorted(excess)[-5:]


def test_the_ring_drops_its_oldest_spans_and_counts_them():
    rec = SpanRecorder(capacity=5)
    for i in range(3):
        with rec.span("engine.step", i=i) as sp:
            with rec.span("engine.admit", i=i):
                pass
            sp.set(done=True)
    assert len(rec.spans) == 5 and rec.dropped == 1
    assert [(s.name, s.attrs["i"]) for s in rec.spans] == [
        ("engine.step", 0), ("engine.admit", 1), ("engine.step", 1),
        ("engine.admit", 2), ("engine.step", 2)]
    last, inner = rec.spans[-1], rec.spans[-2]
    assert last.attrs == {"i": 2, "done": True}
    assert last.start_ns <= inner.start_ns <= inner.end_ns <= last.end_ns
