"""One run of one cell: set-up, the measured window, the check, the result
line.  ``run.py`` is the command; this module does the work, driven by
``BENCHMARK.json``, the configuration file, the mix file, the cell's limits
file and the metric readers, all found by name."""

from __future__ import annotations

import importlib
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from portbench.roofline import peaks

from . import check, program, stats, trace, traffic, weights
from .watch import Watch
from .driver import Driver, Window

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its files read."""

    name: str
    spec: dict
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``: its
    configuration, mix and limits files, and the metrics it reports."""
    bench = _load(root / "BENCHMARK.json")
    spec = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if spec is None:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == spec["config"])
    base = root / "portbench"

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(
        name=workload, spec=spec, cfg=_load(root / conf["file"]),
        mix=_load(base / "mixes" / f"{spec['traffic']}.json"),
        limits=_load(base / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
    )


def reader_path(kind: str, name: str, root: Path = ROOT) -> Path:
    """The file that reads metric ``name``: ``portbench/<kind>/<name>.py``,
    or for a metric split by cells (``<metric>.<part>``, e.g.
    ``device_idle_share.open``) without a file of its own, the reader of
    ``<metric>``."""
    base = root / "portbench" / kind
    own = base / f"{name}.py"
    return own if own.is_file() else base / f"{name.split('.')[0]}.py"


def reader(kind: str, name: str, root: Path = ROOT):
    """The ``read`` function of metric ``name`` (:func:`reader_path`)."""
    path = reader_path(kind, name, root)
    mod_name = f"portbench.{kind}._{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def verdict(max_gap: Optional[float], short: int, tokens: int, cell: Cell) -> Dict[str, Any]:
    """The numbers compared, each beside its limit, and whether all hold:
    the widest gap under the cell's limit, no answer of the wrong length, and
    at least the mix's ``check_served_tokens`` served tokens compared."""
    limit, floor = cell.limits["max_gap"]["limit"], cell.mix["check_served_tokens"]
    return {
        "compared": {"max_gap": {"value": max_gap, "limit": limit},
                     "short_answers": {"value": short, "limit": 0},
                     "sampled_tokens": {"value": tokens, "limit": floor}},
        "correct": max_gap is not None and max_gap <= limit and short == 0 and tokens >= floor,
    }


@dataclass
class RunRecord:
    """What a run saw, for the readers of ``portbench/end_to_end/`` and
    ``portbench/metrics/``."""

    cfg: dict
    mix: dict
    window: Window
    recs: list
    setup_s: float
    steps: list = field(default_factory=list)       # traced: (t0, t1, forward i0, forward i1)
    forwards: list = field(default_factory=list)    # traced: (t0, t1, B, S, q_lens, cache_pos)
    gg_calls: list = field(default_factory=list)    # traced: (group sizes, K, N)
    trace: Optional[trace.DeviceTrace] = None
    traced_from: Optional[float] = None                # host time the device trace began
    peak: Optional[dict] = None
    pool_at_start: Optional[dict] = None
    pool_at_end: Optional[dict] = None

    @property
    def traced_forwards(self) -> list:
        """The forwards that ran inside the device trace."""
        return [f for f in self.forwards if f[0] >= self.traced_from]

    @property
    def traced_gg_calls(self) -> list:
        """The grouped GEMM calls that ran inside the device trace."""
        return [g[1:] for g in self.gg_calls if g[0] >= self.traced_from]

    @property
    def emitted_in_trace(self) -> int:
        """Tokens emitted inside the device trace."""
        return sum(1 for r in self.recs for t in r.tokens if self.traced_from <= t <= self.window.last)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port's runs may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    if not shutil.which("nvidia-smi"):
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or out.stderr.strip()


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
             t_start: Optional[float] = None, log=None, control: bool = False,
             reference: bool = True) -> Dict[str, Any]:
    """Run ``cell`` once; returns the result line's dict (without the
    module check, which the caller makes).  ``control`` also reads the
    control (the fp8 reference) into ``result["readings"]``; without
    ``reference`` the check is skipped and ``correct`` is False (a rate
    sweep's runs)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cfg, mix = cell.cfg, cell.mix
    marks = [("start", time.perf_counter())]
    params = weights.make(cfg, seed, device)
    marks.append(("weights", time.perf_counter()))
    pcfg = program.port_config(cfg)
    eng = program.build_engine(pcfg, params, mix["engine"], device)
    marks.append(("engine", time.perf_counter()))
    tr = traffic.generate(mix, seed, cfg["vocab_size"], traffic.requests_needed(mix, seconds))
    marks.append(("traffic", time.perf_counter()))
    probes = program.Probes() if traced else None
    cuda = torch.device(device).type == "cuda"
    watch = Watch(cuda)
    drv = Driver(eng, tr, probes=probes, watch=watch)
    drv.warm_shapes(tr.prefixes)
    marks.append(("warm shapes", time.perf_counter()))
    prof = None
    if traced:
        probes.attach(eng)
        prof = trace.Profiler(cuda)
        prof.prepare()

    traced_from = None

    def on_window_start():
        if traced:
            probes.on = True
            drv.tracing = True

    def on_tail_start():
        nonlocal traced_from
        if traced:
            prof.start()
            traced_from = time.perf_counter()

    win = drv.run(seconds, on_window_start, trace.TRACE_SECONDS, on_tail_start)
    if cuda:
        torch.cuda.synchronize(device)
    dtrace = None
    if traced:
        t_read = time.perf_counter()
        probes.on = False
        dtrace = trace.read(prof.stop())
        prof = None
        log(f"portbench: trace stopped and read in {time.perf_counter() - t_read:.2f} s")
        probes.detach()
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    late = drv.lateness
    kind = program.device_name(device)
    log(f"portbench: card {card_line()}")
    marks.append(("warm traffic", win.start))
    log("portbench: set-up " + ", ".join(
        [f"before the run {marks[0][1] - t_start:.3f} s"]
        + [f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])]))
    log(f"portbench: window {win.start - t_start:.3f}..{win.last - t_start:.3f} s after start, "
        f"{len(drv.recs)} requests sent, generator late by at most {max(late or [0]) * 1e3:.3f} ms "
        f"(mean {1e3 * sum(late) / max(1, len(late)):.3f} ms)")
    log(f"portbench: window's steps: {watch.summary()}")
    run = RunRecord(
        cfg=cfg, mix=mix, window=win, recs=drv.recs, setup_s=win.start - t_start,
        steps=drv.steps, forwards=probes.forwards if traced else [],
        gg_calls=probes.group_sizes() if traced else [], trace=dtrace, traced_from=traced_from,
        peak=peaks.of(kind),
        pool_at_start=drv.pool_at_start, pool_at_end=drv.pool_at_end,
    )
    metrics: Dict[str, Dict[str, Any]] = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reader("metrics" if traced else "end_to_end", m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check: the program's state freed, the reference on the card
    due = stats.due_in_window(drv.recs, win)
    failed = sum(1 for r in due if r.req.done and r.req.state != "finished")
    picked = check.sample(drv.recs, seed, mix["check_served_tokens"])
    samples = [(list(r.planned.prompt), list(r.req.out_tokens)) for r in picked]
    short = check.short_answers(drv.recs)
    queue_at_start, queue_at_end, sent = drv.queue_at_start, len(eng.queue), len(drv.recs)
    completed = sum(1 for r in drv.recs if r.done is not None and win.start <= r.done <= win.end)
    program.release(eng)
    del eng, drv, probes
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    got = {}
    if reference:
        got = check.compare(cfg, params, samples, device, control=control,
                            prefix_tokens=(mix.get("shared_prefix") or {}).get("tokens", 0))
    log(f"portbench: reference over {len(samples)} requests, {got.get('tokens', 0)} served "
        f"tokens, in {time.perf_counter() - t_check:.2f} s; mean gap {got.get('mean_gap')}, "
        f"served tokens not the reference's best {got.get('mismatch_share')}")
    judged = verdict(got.get("max_gap"), short, got.get("tokens", 0), cell)
    dev: Dict[str, Any] = {"platform": "gpu" if cuda else "cpu", "kind": kind or str(device),
                           "count": 1, "memory_peak_bytes": memory_peak}
    if traced and dtrace is not None:
        dev["busy_s"] = dtrace.busy_s
        dev["window_s"] = dtrace.window_s
    result: Dict[str, Any] = {"correct": bool(judged["correct"]), "attempted": len(due),
                              "failed": failed, "metrics": metrics, "device": dev}
    if traced and dtrace is not None:
        result["breakdown"] = {"device_ops": dtrace.top_ops(10),
                               "idle_gaps": [[n, s] for n, s in dtrace.gaps[:10]]}
    if control or not reference:
        if control:
            # the control in the program's place, judged by the same rule and limit
            got["control_correct"] = verdict(got.get("control_max_gap"), short,
                                             got.get("control_tokens", 0), cell)["correct"]
        result["readings"] = dict(got, reference_s=time.perf_counter() - t_check,
                                  queue_at_start=queue_at_start, queue_at_end=queue_at_end,
                                  completed=completed, sent=sent)
    result["check"] = judged["compared"]
    return result


def compared_lines(result: Dict[str, Any]) -> List[str]:
    """The numbers compared, each beside its limit (``sampled_tokens``'s
    limit is a floor; the others are ceilings)."""
    return [f"check {k} {v['value']} limit {v['limit']}" for k, v in result["check"].items()]
