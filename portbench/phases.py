"""Where a cell's time goes, by the serving engine's own spans and request
stamps (``repro_torch/serving/tracing.py``).  Each run is one run of the
cell as ``run.py`` makes it, with the engine's span recorder on or off
from the engine's build on; prints one ``PHASES`` JSON line a run:

- the cell's metrics, ``correct`` and ``check``, as ``run.py`` gives
  them, and the watch's line of the window's step walls;
- ``phase_ms``: each span's count and mean, p50, p95 and max in ms over
  the window, and ``ring``, what the recorder holds and dropped;
- ``admit_host_ms``: ``engine.admit``'s time in the window's steps that
  admitted (mean, p95, ...), ``waited``, the steps by why the queue's
  head still waited, and ``queue_max``, the longest queue an admission
  left (``engine.admit``'s attributes);
- ``rows_mean``: the window's ``engine.step`` attributes (``S``, rows by
  kind, ``q``) on average;
- ``stamps``: how many served requests were checked against the harness's
  times, ``due ≤ t_submit ≤ t_admit ≤ t_first ≤`` its first token, and
  how many were out of that order;
- traced (``--trace 1``): ``split``, the device's idle share under the
  forward (``engine.forward`` and ``executor.*``), under the step's other
  ``engine.*`` spans and outside them, beside ``device_idle_share``
  (``harness/spans.py``), and ``traced_steps``, the device time of the
  traced steps that carried a prompt chunk and of those that only
  decoded, each step's profiler range paired with its ring span.

A run with the recorder off gives the cost of the spans (``--trace 0``)
or of their profiler ranges (``--trace 1``) against a run with it on; the
two share the seed.  The benchmark's own runs never turn the recorder on.

    python3 portbench/phases.py --workload qwen3-14b.chat --seed 7 --trace 1 --recorder on
    python3 portbench/phases.py --workload qwen3-14b.chat --seed 7 --seconds 20 --trace 0 \\
        --recorder off on on off
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def _seen(on: bool):
    """Hooks into the harness for one run: the engine gets a span recorder
    when ``on``; the raw profiler results and the run's record are kept."""
    from portbench.harness import bench, program, spans, trace

    seen = {}
    build, read, reader = program.build_engine, trace.read, bench.reader

    def build_engine(*a, **kw):
        eng = build(*a, **kw)
        if on:
            seen["rec"] = eng.record_spans()
        return eng

    def read_trace(results, *a, **kw):
        seen["split"] = spans.idle_by_span(results)
        seen["busy"], seen["steps"] = _busy_and_steps(results)
        return read(results, *a, **kw)

    def read_metric(kind, name, root=bench.ROOT):
        fn = reader(kind, name, root)

        def r(run):
            seen["run"] = run
            return fn(run)

        return r

    program.build_engine, trace.read, bench.reader = build_engine, read_trace, read_metric
    try:
        yield seen
    finally:
        program.build_engine, trace.read, bench.reader = build, read, reader


def _busy_and_steps(results):
    """The union of the device's intervals and the ``engine.step`` ranges
    on the host, both on the profiler's clock (ns)."""
    from torch._C._autograd import DeviceType

    from portbench.harness import trace

    dev, steps = [], []
    for e in results.events():
        a, b = e.start_ns(), e.end_ns()
        if b <= a:
            continue
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((a, b))
        elif e.is_user_annotation() and e.name() == "engine.step":
            steps.append((a, b))
    return trace._union(dev), sorted(steps)


def _busy_in(busy, a, b) -> int:
    return sum(min(y, b) - max(x, a) for x, y in busy if y > a and x < b)


def _stats(xs):
    from portbench.harness import stats

    return {"n": len(xs), "mean": statistics.fmean(xs), "p50": stats.percentile(xs, 50),
            "p95": stats.percentile(xs, 95), "max": max(xs)}


def analyse(res: dict, seen: dict, watch: list) -> dict:
    run, rec = seen["run"], seen.get("rec")
    out = {"correct": res["correct"], "check": res["check"],
           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
           "device": res["device"], "watch": watch,
           "idle_gaps": res.get("breakdown", {}).get("idle_gaps")}
    served = [r for r in run.recs if r.tokens and getattr(r.req, "t_first", None) is not None]
    out["stamps"] = {"checked": len(served), "out_of_order": sum(
        1 for r in served
        if not r.due <= r.req.t_submit <= r.req.t_admit <= r.req.t_first <= r.tokens[0])}
    split = seen.get("split")
    if split is not None:
        out["split"] = {"forward_idle_share": split.forward_share,
                        "step_idle_share": split.step_share, "outside": split.outside_share,
                        "device_idle_share": 100.0 * (1 - run.trace.busy_s / run.trace.window_s),
                        "by_span_ms": {k: v * 1e3 for k, v in
                                       sorted(split.by_span.items(), key=lambda kv: -kv[1])}}
    if rec is None:
        return out
    w0, w1 = int(run.window.start * 1e9), int(run.window.last * 1e9)
    sp = [s for s in rec.spans if w0 <= s.start_ns and s.end_ns <= w1]
    out["ring"] = {"spans": len(rec.spans), "dropped": rec.dropped, "in_window": len(sp)}
    by = {}
    for s in sp:
        by.setdefault(s.name, []).append(s.seconds * 1e3)
    out["phase_ms"] = {n: _stats(v) for n, v in sorted(by.items())}
    admits = [s for s in sp if s.name == "engine.admit"]
    took = [s.seconds * 1e3 for s in admits if s.attrs["admitted"]]
    out["admit_host_ms"] = _stats(took) if took else None
    waited = {}
    for s in admits:
        waited[str(s.attrs["waited"])] = waited.get(str(s.attrs["waited"]), 0) + 1
    out["waited"] = waited
    out["queue_max"] = max((s.attrs["queue"] for s in admits), default=None)
    steps = [s for s in sp if s.name == "engine.step"]
    if steps:
        out["rows_mean"] = {k: statistics.fmean(s.attrs[k] for s in steps)
                            for k in ("S", "decode", "verify", "prefill", "idle", "q")}
    prof = seen.get("steps")
    if prof:
        # the profiler ran over the window's last steps: pair them from the end
        ring = [s for s in rec.spans if s.name == "engine.step" and s.end_ns <= w1][-len(prof):]
        kinds = {"chunk": [], "decode": []}
        for (a, b), s in zip(prof, ring):
            if s.attrs["S"]:
                kinds["chunk" if s.attrs["prefill"] else "decode"].append(
                    (_busy_in(seen["busy"], a, b) / 1e6, (b - a) / 1e6))
        out["traced_steps"] = {
            "paired": len(ring), "ranges": len(prof),
            "duration_diff_ms": _stats([abs((b - a) - (s.end_ns - s.start_ns)) / 1e6
                                        for (a, b), s in zip(prof, ring)]),
            **{k: {"n": len(v),
                   "device_ms_mean": statistics.fmean(x for x, _ in v) if v else None,
                   "wall_ms_mean": statistics.fmean(y for _, y in v) if v else None}
               for k, v in kinds.items()}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seed", type=int, required=True,
                    help="the first cell's seed; each further cell takes the next")
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--trace", type=int, default=1)
    ap.add_argument("--recorder", nargs="+", choices=("on", "off"), default=["on"],
                    help="one run of each cell for each, in this order")
    ap.add_argument("--tiny", action="store_true",
                    help="the CPU tests' smoke-size cells, on the CPU")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness import bench

    if not args.tiny and not torch.cuda.is_available():
        print("phases: no CUDA card", file=sys.stderr)
        return 2
    print(f"phases: card {bench.card_line()}", file=sys.stderr, flush=True)
    for ci, name in enumerate(args.workload):
        if args.tiny:
            from portbench.tests._tiny import tiny_cell

            cell, device = tiny_cell(*name.rsplit(".", 1)), "cpu"
        else:
            cell, device = bench.load_cell(name), "cuda"
        seed = args.seed + ci
        for on in args.recorder:
            watch = []

            def log(msg):
                if "window's steps" in msg:
                    watch.append(msg)
                print(msg, file=sys.stderr, flush=True)

            t0 = time.perf_counter()
            with _seen(on == "on") as seen:
                res = bench.run_cell(cell, seed, args.seconds, bool(args.trace), device=device,
                                     t_start=t0, log=log)
            out = {"cell": name, "seed": seed, "recorder": on, "trace": args.trace,
                   **analyse(res, seen, watch)}
            print("PHASES " + json.dumps(out), flush=True)
            seen.clear()
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
