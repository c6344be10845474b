"""Event-driven makespan simulator for a placed computation graph.

This is the framework's stand-in for the paper's wall-clock end-to-end
latency measurements (no heterogeneous GPU cluster exists in this container)
and is also used at runtime by the serving engine for admission planning and
straggler hedging.  Semantics match the paper's execution model:

* operators on one device run **sequentially** (non-overlap, Eq. 6) — a TPU
  core / CUDA stream executes one kernel at a time;
* a data flow whose endpoints share a device costs zero (z_q = 0, Eq. 7);
* flows on the same directed channel (k', k'') serialize (congestion, Eq. 8);
* compute and communication of *different* devices overlap freely.

The scheduler is earliest-ready-first per resource (classic list scheduling),
which is how PyTorch/XLA actually dispatch a placed graph.  The simulator
returns the full schedule so tests can verify every MILP constraint holds.

Pipelined (multi-request) execution model
-----------------------------------------
:func:`simulate` answers "how long does ONE query take?" — the paper's
makespan objective (Eqs. 4–8).  A serving system under load cares about a
different quantity: how many queries per second flow through the placement
when many requests are in flight at once.  :func:`simulate_pipeline`
generalizes the event loop to N requests:

* each request is an independent copy of the task graph (its own precedence
  edges), released when the request arrives (and, with ``max_in_flight``,
  admitted only when a serving slot frees — continuous batching).  The
  ``batching`` mode mirrors the serving engine: ``"ragged"`` refills a freed
  slot immediately (per-slot cache positions), ``"lockstep"`` admits cohort
  waves that must fully drain first (the seed engine's shared-position
  constraint); ``decode_batch`` scores ops with the batch-aware cost model;
* devices and channels are SHARED across requests with the exact same
  semantics as the single-query simulator: one op at a time per device
  (Eq. 6), serialized flows per directed channel (Eq. 8), zero-cost
  co-located flows (Eq. 7);
* with ``n_requests=1`` the pipelined simulator reduces *exactly* to
  :func:`simulate` (same dispatch order, same floating-point sums).

In steady state the completion interval converges to the *bottleneck stage
time* — the largest per-request busy time over any single resource — which
:func:`bottleneck_time` computes analytically; the throughput planning
objective (``PlanConfig.objective="throughput"``) minimizes that quantity
instead of the makespan.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from .costmodel import CostModel
from .graph import AugmentedDAG, OpGraph, OpNode, augment


@dataclass
class TaskRecord:
    task_id: int            # op id, or comm id (from the augmented DAG)
    kind: str               # "op" | "comm"
    resource: Tuple         # ("dev", k) or ("chan", src_dev, dst_dev)
    start: float
    end: float


def _task_table(
    graph: OpGraph,
    placement: Mapping[int, int],
    cost: CostModel,
    aug: AugmentedDAG,
    decode_batch: int = 1,
) -> Tuple[Dict[int, float], Dict[int, Tuple], Dict[int, List[int]], Dict[int, List[int]]]:
    """(dur, resource, deps, fanout) for every op and comm task.

    Shared by `simulate` and `simulate_pipeline` — the documented
    n_requests=1 equivalence depends on both using identical task semantics:
    op tasks run for p_ik on ("dev", k); comm tasks run for p_comm on
    ("chan", src_dev, dst_dev), or for 0 on ("local",) when co-located.

    ``decode_batch > 1`` charges each op its batch-aware amortized
    per-request time (``CostModel.compute_time(batch=...)``): concurrent
    serving slots decode as ONE batched kernel, so weight traffic is
    streamed once per step, not once per request."""
    dur: Dict[int, float] = {}
    resource: Dict[int, Tuple] = {}
    deps: Dict[int, List[int]] = {}      # task -> prerequisite tasks
    fanout: Dict[int, List[int]] = {}    # task -> dependents

    for nid, node in graph.nodes.items():
        k = placement[nid]
        # speculative joint graphs: meta["pass_rate"] is the node's forwards
        # per COMMITTED token (target 1/E, draft k/E) — decode-round work
        # scales by it, so draft busy overlaps target verify at the right
        # per-token rate in the event loop.  1.0 when absent (plain graphs).
        dur[nid] = cost.compute_time(node, k, batch=decode_batch) * float(
            node.meta.get("pass_rate", 1.0)
        )
        resource[nid] = ("dev", k)
        deps[nid] = []
        fanout.setdefault(nid, [])

    for q, c in aug.comm.items():
        ks, kd = placement[c.src], placement[c.dst]
        if ks == kd:
            dur[q] = 0.0
            resource[q] = ("local",)  # zero-cost, no resource contention
        else:
            # a flow fires once per forward of its source node
            dur[q] = cost.comm_time(c.bytes, ks, kd) * float(
                graph.nodes[c.src].meta.get("pass_rate", 1.0)
            )
            resource[q] = ("chan", ks, kd)
        deps[q] = [c.src]
        fanout.setdefault(q, []).append(c.dst)
        fanout.setdefault(c.src, []).append(q)
        deps[c.dst].append(q)

    return dur, resource, deps, fanout


def _device_busy(schedule: Mapping, k: int) -> float:
    """Total busy seconds of device ``k`` over any schedule's records."""
    return sum(
        r.end - r.start for r in schedule.values() if r.resource == ("dev", k)
    )


# --------------------------------------------------------------------------
# Chunked-prefill costing: score the prompt work the serving engine actually
# runs.  A request with ``prompt_len`` tokens executes
# ceil(prompt_len / prefill_chunk) prefill passes of the placed graph before
# its decode pass; each pass's per-op cost is the graph node rescaled to the
# chunk's token count (relative to the seq_len the node costs were counted
# at), evaluated through the SAME roofline cost model on the SAME shared
# device/channel resources.
# --------------------------------------------------------------------------


def prefill_chunk_sizes(prompt_len: int, prefill_chunk: Optional[int]) -> List[int]:
    """Token counts of the prefill passes for one request's prompt.

    ``prefill_chunk=None`` means whole-prompt (blocking) prefill — one pass;
    ``prompt_len <= 0`` means no prefill work at all (the pre-chunking
    decode-only request model)."""
    p = int(prompt_len)
    if p <= 0:
        return []
    c = int(prefill_chunk) if prefill_chunk else p
    if c <= 0:
        raise ValueError(f"prefill_chunk must be > 0 or None, got {prefill_chunk}")
    return [min(c, p - i) for i in range(0, p, c)]


def resolve_graph_seq_len(graph: OpGraph, seq_len: Optional[int]) -> int:
    """The sequence length the graph's node costs were counted at —
    an explicit override, else ``graph.seq_len`` (set by the model-graph
    builders).  Prefill-aware scoring is meaningless without it."""
    s = seq_len if seq_len is not None else getattr(graph, "seq_len", None)
    if not s or int(s) <= 0:
        raise ValueError(
            "prefill-aware scoring needs the token count the graph costs were "
            "built at: pass graph_seq_len=..., or use a graph whose builder "
            "records .seq_len (core.modelgraph.transformer_graph does)"
        )
    return int(s)


def scale_edge_bytes(node: OpNode, payload: float, frac: float, cfrac: float) -> float:
    """Token-rescale a payload emitted by ``node`` (its output tensor, which
    is also what comm nodes carry across a stage cut).  s²-shaped outputs —
    attention score/probability tensors in the fine-granularity graph —
    record their quadratic share as ``meta["quad_out_bytes"]``: that share
    is billed queries × keys (``frac × cfrac``), the rest linearly with the
    chunk.  Nodes without the meta key keep the old linear scaling."""
    meta = node.meta or {}
    quad = min(float(meta.get("quad_out_bytes", 0.0)), float(payload))
    return (payload - quad) * frac + quad * frac * cfrac


def scale_node_to_tokens(
    node: OpNode,
    tokens: int,
    seq_len: int,
    *,
    context_tokens: Optional[int] = None,
) -> OpNode:
    """A copy of ``node`` rescaled from ``seq_len`` tokens to ``tokens``.

    Flops, activation HBM traffic, and the output payload scale with the
    token count; resident weight traffic (``param_bytes``, streamed once per
    pass regardless of chunk size) does not.

    Attention's score/context work is quadratic in the attended span, not
    linear in the query count: the model-graph builders record each node's
    quadratic share as ``meta["quad_flops"]`` / ``meta["quad_bytes"]``, and
    that share scales as ``(tokens/seq_len) × (context_tokens/seq_len)`` —
    queries × keys — instead of linearly.  ``context_tokens`` is the KV span
    the chunk attends over (its own tokens plus every token already in the
    cache); the default ``None`` means a standalone pass (context = its own
    tokens), which makes a whole-prompt pass at ``tokens = t`` exactly equal
    a graph natively built at ``seq_len = t``.  Nodes without quad metadata
    (coarsened supernodes that fused attention away, non-attention ops)
    fall back to the old linear approximation."""
    frac = float(tokens) / float(seq_len)
    cfrac = float(context_tokens if context_tokens is not None else tokens) / float(seq_len)
    serial = node.meta.get("serial") if node.meta else None
    scaled = node.copy()
    meta = node.meta or {}
    quad_f = min(float(meta.get("quad_flops", 0.0)), node.flops)
    scaled.flops = (node.flops - quad_f) * frac + quad_f * frac * cfrac
    # the invariant weight stream only exists when the node actually streams
    # its weights alongside activations (bytes > params); a gather-style node
    # (embedding: touched rows ≪ resident table, bytes <= params) reads
    # token-indexed bytes that scale with the chunk.  meta["invariant_bytes"]
    # overrides the param-based inference — a tied lm_head streams the shared
    # vocab table every pass despite carrying param_bytes = 0
    if "invariant_bytes" in meta:
        inv = min(float(meta["invariant_bytes"]), node.bytes_accessed)
    elif node.bytes_accessed > node.param_bytes:
        inv = min(node.param_bytes, node.bytes_accessed)
    else:
        inv = 0.0
    act = max(node.bytes_accessed - inv, 0.0)
    quad_b = min(float(meta.get("quad_bytes", 0.0)), act)
    scaled.bytes_accessed = inv + (act - quad_b) * frac + quad_b * frac * cfrac
    scaled.output_bytes = scale_edge_bytes(node, node.output_bytes, frac, cfrac)
    if serial:
        # hierarchy supernodes carry (flops, bytes, op_type) member triples
        # with no per-member weight or quad split: scale both terms linearly
        # (the documented fallback fidelity once coarsening discards meta)
        scaled.meta = dict(node.meta)
        scaled.meta["serial"] = [
            (f * frac, nb * frac, ot) for f, nb, ot in serial
        ]
    return scaled


def prefill_compute_time(
    cost: CostModel,
    node: OpNode,
    device_idx: int,
    tokens: int,
    seq_len: int,
    context_tokens: Optional[int] = None,
) -> float:
    """p_ik of one ``tokens``-token prefill chunk of ``node`` (batch-1: the
    serving engine prefills one slot row at a time).  ``context_tokens`` is
    the KV span the chunk attends over (cache + itself) — attention's
    quadratic share is billed queries × keys (see
    :func:`scale_node_to_tokens`)."""
    return cost.compute_time(
        scale_node_to_tokens(node, tokens, seq_len, context_tokens=context_tokens),
        device_idx,
    )


def fused_prefill_compute_time(
    cost: CostModel,
    node: OpNode,
    device_idx: int,
    tokens: int,
    seq_len: int,
    context_tokens: Optional[int] = None,
) -> float:
    """p_ik of a ``tokens``-token prefill chunk when the chunk rides INSIDE
    the decode batch's fused forward (the engine's one-program-per-step
    path): the weight stream and kernel launch are already charged to the
    decode pass sharing the program, so only the chunk's marginal activation
    work is billed (see ``CostModel.marginal_compute_time``).
    ``context_tokens`` bills attention's quadratic share at the chunk's true
    KV span, as in :func:`prefill_compute_time`."""
    return cost.marginal_compute_time(
        scale_node_to_tokens(node, tokens, seq_len, context_tokens=context_tokens),
        device_idx,
    )


def _resolve_prompt_lens(
    n_requests: int, prompt_len: Union[None, int, Sequence[int]]
) -> List[int]:
    """Per-request prompt token counts from a scalar or sequence spec."""
    if prompt_len is None:
        return [0] * n_requests
    if isinstance(prompt_len, (int, float)):
        if prompt_len < 0:
            raise ValueError(f"prompt_len must be >= 0, got {prompt_len}")
        return [int(prompt_len)] * n_requests
    lens = [int(p) for p in prompt_len]
    if len(lens) != n_requests:
        raise ValueError(
            f"prompt_len sequence has {len(lens)} entries for {n_requests} requests"
        )
    if any(p < 0 for p in lens):
        raise ValueError("prompt lengths must be >= 0")
    return lens


def _prefill_task_table(
    graph: OpGraph,
    placement: Mapping[int, int],
    cost: CostModel,
    aug: AugmentedDAG,
    tokens: int,
    seq_len: int,
    fused_prefill: bool = False,
    context_tokens: Optional[int] = None,
) -> Tuple[Dict[int, float], Dict[int, Tuple]]:
    """(dur, resource) of one ``tokens``-token prefill pass of the placed
    graph — same task ids, deps and resources as the decode pass
    (``_task_table``), durations rescaled to the chunk's token count (and
    its ``context_tokens`` KV span for attention's quadratic share).
    ``fused_prefill`` bills devices at the marginal (fused mixed-batch)
    rate.  Comm payloads scale with the chunk — and an s²-shaped payload
    (a score tensor crossing a stage cut) bills its ``quad_out_bytes``
    share queries × keys, like the compute it feeds
    (:func:`scale_edge_bytes`)."""
    pct = fused_prefill_compute_time if fused_prefill else prefill_compute_time
    dur: Dict[int, float] = {}
    resource: Dict[int, Tuple] = {}
    for nid, node in graph.nodes.items():
        k = placement[nid]
        dur[nid] = pct(cost, node, k, tokens, seq_len, context_tokens)
        resource[nid] = ("dev", k)
    frac = float(tokens) / float(seq_len)
    cfrac = float(context_tokens if context_tokens is not None else tokens) / float(seq_len)
    for q, c in aug.comm.items():
        ks, kd = placement[c.src], placement[c.dst]
        if ks == kd:
            dur[q] = 0.0
            resource[q] = ("local",)
        else:
            payload = scale_edge_bytes(graph.nodes[c.src], c.bytes, frac, cfrac)
            dur[q] = cost.comm_time(payload, ks, kd)
            resource[q] = ("chan", ks, kd)
    return dur, resource


def prefill_busy(
    graph: OpGraph,
    placement: Mapping[int, int],
    cost: CostModel,
    *,
    prompt_len: int,
    prefill_chunk: Optional[int] = None,
    seq_len: Optional[int] = None,
    aug: Optional[AugmentedDAG] = None,
    fused_prefill: bool = False,
) -> Dict[Tuple, float]:
    """Per-request prefill busy seconds by resource (device / directed
    channel) — the chunked prompt work one request adds on top of its decode
    pass.  Added to the decode busy by :func:`bottleneck_time` and mirrored
    by the throughput MILP's busy-time accumulators.  ``fused_prefill``
    scores chunks at the fused mixed-batch marginal rate (no second weight
    stream, no second launch — the engine's default serving path); comm
    busy is unchanged."""
    chunks = prefill_chunk_sizes(prompt_len, prefill_chunk)
    busy: Dict[Tuple, float] = {}
    if not chunks:
        return busy
    s = resolve_graph_seq_len(graph, seq_len)
    aug = aug or augment(graph)
    # chunks are costed as (size, KV-context) pairs: chunk i attends over
    # every prior chunk's cache plus itself, so attention's quadratic share
    # grows along the prompt (identical pair iteration in the MILP's busy
    # accumulators — keep in sync with core.milp)
    counts: Dict[Tuple[int, int], int] = {}
    run = 0
    for t in chunks:
        run += t
        counts[(t, run)] = counts.get((t, run), 0) + 1
    pct = fused_prefill_compute_time if fused_prefill else prefill_compute_time
    for (t, ctx), n in counts.items():
        for nid, node in graph.nodes.items():
            k = placement[nid]
            key = ("dev", k)
            busy[key] = busy.get(key, 0.0) + n * pct(cost, node, k, t, s, ctx)
        frac = float(t) / float(s)
        cfrac = float(ctx) / float(s)
        for q, c in aug.comm.items():
            ks, kd = placement[c.src], placement[c.dst]
            if ks != kd:
                key = ("chan", ks, kd)
                payload = scale_edge_bytes(graph.nodes[c.src], c.bytes, frac, cfrac)
                busy[key] = busy.get(key, 0.0) + n * cost.comm_time(payload, ks, kd)
    return busy


@dataclass
class SimResult:
    """Single-query simulation outcome: the makespan (paper Eq. 4 objective),
    the full per-task schedule (op and comm :class:`TaskRecord` entries,
    keyed by task id), and the augmented DAG the tasks refer to."""

    makespan: float
    schedule: Dict[int, TaskRecord]
    aug: AugmentedDAG

    def device_busy(self, k: int) -> float:
        """Total busy seconds of device ``k`` in this schedule."""
        return _device_busy(self.schedule, k)


def simulate(
    graph: OpGraph,
    placement: Mapping[int, int],
    cost: CostModel,
    *,
    aug: Optional[AugmentedDAG] = None,
    priority: Optional[Mapping[int, float]] = None,
) -> SimResult:
    """Simulate ``graph`` under ``placement`` (op id -> device idx).

    ``priority`` (lower = sooner) overrides the earliest-ready-first dispatch
    order per resource — used to execute the MILP's own schedule order (the
    runtime dispatches tasks in the solver's S_i order)."""
    aug = aug or augment(graph)
    dur, resource, deps, fanout = _task_table(graph, placement, cost, aug)
    n_deps = {t: len(d) for t, d in deps.items()}

    # --- event loop -------------------------------------------------------
    # ready[resource] = heap of (ready_time, task_id)
    ready: Dict[Tuple, List[Tuple[float, int]]] = {}
    free_at: Dict[Tuple, float] = {}
    running: Dict[Tuple, Optional[int]] = {}

    events: List[Tuple[float, int, int]] = []  # (time, seq, task) completions
    seq = 0
    schedule: Dict[int, TaskRecord] = {}
    completed: Dict[int, float] = {}

    def push_ready(task: int, t: float):
        nonlocal seq
        res = resource[task]
        if res == ("local",) or dur[task] == 0.0:
            # zero-duration: complete instantly at its ready time
            heapq.heappush(events, (t, seq, task))
            seq += 1
            schedule[task] = TaskRecord(task, _kind(task), res, t, t)
            return
        ready.setdefault(res, [])
        rank = priority.get(task, t) if priority is not None else t
        heapq.heappush(ready[res], (rank, t, task))
        try_start(res, t)

    def _kind(task: int) -> str:
        return "op" if task in graph.nodes else "comm"

    def try_start(res: Tuple, now: float):
        nonlocal seq
        if running.get(res) is not None:
            return
        q = ready.get(res)
        if not q:
            return
        _, rt, task = heapq.heappop(q)
        start = max(rt, free_at.get(res, 0.0), now)
        end = start + dur[task]
        running[res] = task
        schedule[task] = TaskRecord(task, _kind(task), res, start, end)
        heapq.heappush(events, (end, seq, task))
        seq += 1

    # seed: tasks with no prerequisites
    for t, nd in n_deps.items():
        if nd == 0:
            push_ready(t, 0.0)

    makespan = 0.0
    while events:
        t, _, task = heapq.heappop(events)
        makespan = max(makespan, t)
        completed[task] = t
        res = resource[task]
        if res != ("local",) and dur[task] > 0.0:
            running[res] = None
            free_at[res] = t
        for dep in fanout.get(task, []):
            n_deps[dep] -= 1
            if n_deps[dep] == 0:
                push_ready(dep, t)
        if res != ("local",) and dur[task] > 0.0:
            try_start(res, t)

    if len(completed) != len(dur):
        missing = set(dur) - set(completed)
        raise RuntimeError(f"simulation deadlock; unfinished tasks: {sorted(missing)[:10]}")

    return SimResult(makespan=makespan, schedule=schedule, aug=aug)


# --------------------------------------------------------------------------
# Validation: assert a simulated schedule obeys every MILP constraint family.
# Used by property tests and by the MILP solver's self-check.
# --------------------------------------------------------------------------


def validate_schedule(
    graph: OpGraph,
    placement: Mapping[int, int],
    cost: CostModel,
    result: SimResult,
    *,
    atol: float = 1e-9,
) -> None:
    """Assert a simulated schedule obeys every MILP constraint family:
    precedence through comm nodes (Eq. 4), valid device assignment, memory
    (Eq. 5), per-device and per-channel non-overlap (Eqs. 6/8), and
    zero-cost co-located flows (Eq. 7).  Raises ``AssertionError`` on the
    first violation (used by property tests and the solver self-check)."""
    sched = result.schedule
    aug = result.aug

    # (4a) precedence through comm nodes
    for (u, v), q in aug.edge_to_comm.items():
        assert sched[u].end <= sched[q].start + atol, f"flow {q} starts before {u} ends"
        assert sched[q].end <= sched[v].start + atol, f"op {v} starts before flow {q} ends"

    # (4c) every op placed on exactly one valid device
    for nid in graph.nodes:
        assert 0 <= placement[nid] < cost.cluster.k

    # (5) memory
    assert cost.memory_ok(graph, placement), "memory constraint violated"

    # (6) non-overlap per device; (8) non-overlap per channel
    by_res: Dict[Tuple, List[TaskRecord]] = {}
    for r in sched.values():
        if r.resource != ("local",) and r.end > r.start:
            by_res.setdefault(r.resource, []).append(r)
    for res, recs in by_res.items():
        recs.sort(key=lambda r: r.start)
        for a, b in zip(recs, recs[1:]):
            assert a.end <= b.start + atol, (
                f"overlap on {res}: task {a.task_id} [{a.start},{a.end}] vs "
                f"task {b.task_id} [{b.start},{b.end}]"
            )

    # (7) zero-cost same-device flows
    for q, c in aug.comm.items():
        if placement[c.src] == placement[c.dst]:
            assert sched[q].end - sched[q].start <= atol


# --------------------------------------------------------------------------
# Pipelined multi-request simulation (steady-state throughput).
# --------------------------------------------------------------------------


@dataclass
class PipelineResult:
    """Outcome of a multi-request pipelined simulation.

    ``schedule`` is keyed by ``(request_id, task_id)``; task ids are the op /
    comm ids of the shared :class:`AugmentedDAG` (every request executes the
    same placed graph).
    """

    n_requests: int
    makespan: float                           # last completion time
    arrivals: List[float]                     # per-request arrival times
    completions: List[float]                  # per-request completion times
    schedule: Dict[Tuple[int, int], TaskRecord]
    aug: AugmentedDAG
    # per-request prefill chunk token counts ([] per request when the run
    # was decode-only — the pre-chunking request model).  Prefill tasks are
    # keyed ``(rid, ("prefill", round, task_id))`` in ``schedule``.
    prompt_chunks: List[List[int]] = field(default_factory=list)

    # ---------------------------------------------------------- throughput
    @property
    def latencies(self) -> List[float]:
        return [c - a for a, c in zip(self.arrivals, self.completions)]

    @property
    def throughput(self) -> float:
        """Completed requests per second over the whole simulated window."""
        span = self.makespan - min(self.arrivals)
        return self.n_requests / span if span > 0 else math.inf

    @property
    def steady_throughput(self) -> float:
        """Asymptotic completions/sec: excludes pipeline fill by measuring
        the interval between the first and last completion."""
        if self.n_requests < 2:
            return self.throughput
        done = sorted(self.completions)
        span = done[-1] - done[0]
        return (self.n_requests - 1) / span if span > 0 else math.inf

    def latency_percentile(self, p: float) -> float:
        lats = sorted(self.latencies)
        if not lats:
            return 0.0
        idx = min(len(lats) - 1, max(0, math.ceil(p / 100.0 * len(lats)) - 1))
        return lats[idx]

    def latency_percentiles(self) -> Dict[str, float]:
        return {f"p{p}": self.latency_percentile(p) for p in (50, 95, 99)}

    # ---------------------------------------------------------- utilization
    def device_busy(self, k: int) -> float:
        return _device_busy(self.schedule, k)

    def device_util(self, k: int) -> float:
        return self.device_busy(k) / self.makespan if self.makespan > 0 else 0.0

    def utilization(self, n_devices: int) -> Dict[int, float]:
        return {k: self.device_util(k) for k in range(n_devices)}


def _resolve_arrivals(n_requests: int, arrival) -> List[float]:
    """Resolve an arrival-process spec into per-request timestamps.

    ``arrival`` forms:

    * ``None`` / ``0``                → all at t=0 (saturated pipeline);
    * ``float``                       → fixed inter-arrival gap (open loop);
    * ``("poisson", rate[, seed])``   → seeded Poisson process with ``rate``
      requests/sec (i.i.d. exponential gaps) — bursty open-loop load, so
      throughput benchmarks stop overstating steady-state req/s the way a
      perfectly regular fixed-gap stream does;
    * sequence of floats              → explicit per-request timestamps
      (trace replay); must be non-negative and non-decreasing.
    """
    if arrival is None:
        return [0.0] * n_requests
    if isinstance(arrival, (int, float)):
        if arrival < 0:
            raise ValueError(f"inter-arrival gap must be >= 0, got {arrival}")
        return [i * float(arrival) for i in range(n_requests)]
    if (
        isinstance(arrival, (tuple, list))
        and len(arrival) > 0
        and arrival[0] == "poisson"
    ):
        if len(arrival) not in (2, 3):
            raise ValueError(
                'poisson arrival spec must be ("poisson", rate) or '
                f'("poisson", rate, seed), got {arrival!r}'
            )
        rate = float(arrival[1])
        if not math.isfinite(rate) or rate <= 0:
            raise ValueError(f"poisson rate must be a finite value > 0, got {rate}")
        seed = int(arrival[2]) if len(arrival) == 3 else 0
        import numpy as _np

        gaps = _np.random.default_rng(seed).exponential(1.0 / rate, size=n_requests)
        return [float(t) for t in _np.cumsum(gaps)]
    arrivals = [float(a) for a in arrival]
    if len(arrivals) != n_requests:
        raise ValueError(
            f"arrival sequence has {len(arrivals)} entries for {n_requests} requests"
        )
    if any(a < 0 for a in arrivals):
        raise ValueError("trace arrival times must be non-negative")
    if any(b < a for a, b in zip(arrivals, arrivals[1:])):
        raise ValueError("trace arrival times must be non-decreasing")
    return arrivals


def simulate_pipeline(
    graph: OpGraph,
    placement: Mapping[int, int],
    cost: CostModel,
    n_requests: int,
    arrival=None,
    *,
    max_in_flight: Optional[int] = None,
    batching: str = "ragged",
    decode_batch: int = 1,
    prompt_len: Union[None, int, Sequence[int]] = None,
    prefill_chunk: Optional[int] = None,
    graph_seq_len: Optional[int] = None,
    aug: Optional[AugmentedDAG] = None,
    fused_prefill: bool = False,
) -> PipelineResult:
    """Simulate ``n_requests`` copies of the placed graph sharing one cluster.

    ``arrival`` selects the arrival process — saturated, fixed-gap,
    ``("poisson", rate[, seed])``, or an explicit timestamp trace (see
    :func:`_resolve_arrivals`).

    ``max_in_flight`` caps concurrency (serving slots): a request is admitted
    — its root tasks released — only once fewer than ``max_in_flight``
    requests are unfinished, at ``max(arrival, slot-free time)``.

    ``batching`` selects the admission model, matching the two serving-engine
    modes:

    * ``"ragged"`` (default) — admit-on-retire: any freed slot is refilled
      immediately (the engine's per-slot cache positions make this the real
      runtime behavior);
    * ``"lockstep"`` — cohort waves: up to ``max_in_flight`` requests are
      admitted together, and the next wave opens only after EVERY request of
      the current wave completes (the seed engine's shared-``cache_pos``
      constraint with mixed-depth requests — the model planner objectives
      scored before ragged batching landed).

    ``decode_batch > 1`` applies the batch-aware cost model: each op is
    charged its amortized per-request time at that decode batch size
    (weight traffic streamed once per batched step), so ``slots > 1`` plans
    are scored the way the batched engine actually runs them.

    ``prompt_len`` (scalar, or one entry per request) gives each request a
    chunked-prefill phase before its decode pass: ceil(prompt_len /
    prefill_chunk) sequential prefill passes of the placed graph (whole-
    prompt when ``prefill_chunk`` is None), each costed at its chunk's token
    count relative to ``graph_seq_len`` (default: ``graph.seq_len``) and
    contending for the SAME devices and channels as every other request's
    work — prompt-heavy workloads are no longer scored as if prompts were
    free.  ``prompt_len=None``/``0`` reproduces the decode-only request
    model exactly.

    ``fused_prefill`` scores each prefill chunk at the fused mixed-batch
    marginal rate — the engine packs chunks into the live decode batch, so a
    chunk pays no second weight stream and no second kernel launch (see
    :func:`fused_prefill_compute_time`).  The round structure is unchanged:
    chunks still execute strictly in order before their request's decode
    pass, so :func:`validate_pipeline_schedule` applies as-is."""
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    if batching not in ("ragged", "lockstep"):
        raise ValueError(
            f"batching must be 'ragged' or 'lockstep', got {batching!r}"
        )
    aug = aug or augment(graph)
    arrivals = _resolve_arrivals(n_requests, arrival)
    if arrivals != sorted(arrivals):
        raise ValueError("arrival times must be non-decreasing")

    # per-task static data, identical for every request
    dur, resource, deps, fanout = _task_table(
        graph, placement, cost, aug, decode_batch
    )
    roots = [t for t, d in deps.items() if not d]

    # per-request prefill rounds: round r < n_chunks runs the r-th prefill
    # chunk (whole graph, chunk-scaled durations), round n_chunks is the
    # decode pass.  Chunks are sequential (round r+1's roots release when
    # round r fully completes — the engine writes chunk r's KV before
    # running chunk r+1).
    prompt_lens = _resolve_prompt_lens(n_requests, prompt_len)
    chunks_of = [prefill_chunk_sizes(p, prefill_chunk) for p in prompt_lens]
    # chunk r of a request attends over every prior chunk's KV plus itself,
    # so tables are keyed (size, context) — attention's quadratic share
    # grows along the prompt (see scale_node_to_tokens)
    ctx_of = []
    for ch in chunks_of:
        run, ctxs = 0, []
        for t in ch:
            run += t
            ctxs.append(run)
        ctx_of.append(ctxs)
    pre_tables: Dict[Tuple[int, int], Tuple[Dict[int, float], Dict[int, Tuple]]] = {}
    if any(chunks_of):
        s_graph = resolve_graph_seq_len(graph, graph_seq_len)
        pairs = {
            (t, c)
            for ch, cx in zip(chunks_of, ctx_of)
            for t, c in zip(ch, cx)
        }
        for toks, ctx in pairs:
            pre_tables[(toks, ctx)] = _prefill_task_table(
                graph, placement, cost, aug, toks, s_graph,
                fused_prefill=fused_prefill, context_tokens=ctx,
            )
    n_rounds = [len(ch) + 1 for ch in chunks_of]   # prefill rounds + decode

    def round_tables(rid: int, r: int) -> Tuple[Dict[int, float], Dict[int, Tuple]]:
        if r < len(chunks_of[rid]):
            return pre_tables[(chunks_of[rid][r], ctx_of[rid][r])]
        return dur, resource

    def sched_key(rid: int, r: int, task: int):
        # decode-round records keep the pre-chunking ``(rid, task)`` key;
        # prefill records are namespaced so consumers can tell them apart
        if r == n_rounds[rid] - 1:
            return (rid, task)
        return (rid, ("prefill", r, task))

    # --- event loop over (request, round, task) keys ----------------------
    # A request's roots enter the ready queues only via an ADMISSION event at
    # its release time, so every queued task is ready "now" — a freed device
    # never commits to a future-ready task over one that becomes ready
    # sooner (future arrivals would otherwise cause head-of-line blocking).
    ready: Dict[Tuple, List[Tuple[float, int, int, int]]] = {}
    free_at: Dict[Tuple, float] = {}
    running: Dict[Tuple, Optional[Tuple[int, int, int]]] = {}

    # events: (time, seq, ("task", rid, r, tid)) | (time, seq, ("admit", rid))
    events: List[Tuple[float, int, Tuple]] = []
    seq = 0
    schedule: Dict[Tuple, TaskRecord] = {}
    tasks_per_round = len(dur)
    remaining_round = {
        (rid, r): tasks_per_round
        for rid in range(n_requests)
        for r in range(n_rounds[rid])
    }
    n_deps: Dict[Tuple[int, int, int], int] = {}
    completions = [0.0] * n_requests
    completed_requests = 0

    def _kind(r: int, rid: int, task: int) -> str:
        base = "op" if task in graph.nodes else "comm"
        return base if r == n_rounds[rid] - 1 else f"prefill-{base}"

    def push_event(t: float, payload: Tuple):
        nonlocal seq
        heapq.heappush(events, (t, seq, payload))
        seq += 1

    def push_ready(rid: int, r: int, task: int, t: float):
        rdur, rres = round_tables(rid, r)
        res = rres[task]
        if res == ("local",) or rdur[task] == 0.0:
            push_event(t, ("task", rid, r, task))
            schedule[sched_key(rid, r, task)] = TaskRecord(
                task, _kind(r, rid, task), res, t, t
            )
            return
        # earliest-ready-first; ties broken by (request, round, task) id so
        # that a single request reproduces `simulate`'s dispatch order exactly
        heapq.heappush(ready.setdefault(res, []), (t, rid, r, task))
        try_start(res, t)

    def try_start(res: Tuple, now: float):
        if running.get(res) is not None:
            return
        q = ready.get(res)
        if not q:
            return
        rt, rid, r, task = heapq.heappop(q)
        rdur, _ = round_tables(rid, r)
        start = max(rt, free_at.get(res, 0.0), now)
        end = start + rdur[task]
        running[res] = (rid, r, task)
        schedule[sched_key(rid, r, task)] = TaskRecord(
            task, _kind(r, rid, task), res, start, end
        )
        push_event(end, ("task", rid, r, task))

    for rid in range(n_requests):
        for r in range(n_rounds[rid]):
            for task, d in deps.items():
                n_deps[(rid, r, task)] = len(d)

    slots = max_in_flight if max_in_flight is not None else n_requests
    if slots < 1:
        raise ValueError("max_in_flight must be >= 1")
    next_admit = 0
    wave_open = 0            # unfinished requests of the current lockstep wave

    def admit_wave(now: float) -> None:
        """Release the next cohort of up to ``slots`` requests (lockstep):
        each member enters at max(its arrival, the wave-open time), and the
        NEXT wave opens only once every member of this one completes."""
        nonlocal next_admit, wave_open
        take = min(slots, n_requests - next_admit)
        for rid in range(next_admit, next_admit + take):
            push_event(max(now, arrivals[rid]), ("admit", rid))
        next_admit += take
        wave_open = take

    if batching == "lockstep":
        admit_wave(0.0)
    else:
        next_admit = min(slots, n_requests)
        for rid in range(next_admit):
            push_event(arrivals[rid], ("admit", rid))

    makespan = 0.0
    while events:
        t, _, payload = heapq.heappop(events)
        if payload[0] == "admit":
            rid = payload[1]
            for task in roots:
                push_ready(rid, 0, task, t)
            continue
        _, rid, r, task = payload
        makespan = max(makespan, t)
        rdur, rres = round_tables(rid, r)
        res = rres[task]
        if res != ("local",) and rdur[task] > 0.0:
            running[res] = None
            free_at[res] = t
        remaining_round[(rid, r)] -= 1
        if remaining_round[(rid, r)] == 0:
            if r < n_rounds[rid] - 1:
                # this prefill chunk's KV is written — release the next round
                for root in roots:
                    push_ready(rid, r + 1, root, t)
            else:
                completions[rid] = t
                completed_requests += 1
                if batching == "lockstep":
                    wave_open -= 1
                    if wave_open == 0 and next_admit < n_requests:
                        admit_wave(t)
                elif next_admit < n_requests:
                    # ragged admit-on-retire: the freed slot is refilled NOW
                    push_event(max(t, arrivals[next_admit]), ("admit", next_admit))
                    next_admit += 1
        for dep in fanout.get(task, []):
            n_deps[(rid, r, dep)] -= 1
            if n_deps[(rid, r, dep)] == 0:
                push_ready(rid, r, dep, t)
        if res != ("local",) and rdur[task] > 0.0:
            try_start(res, t)

    if completed_requests != n_requests:
        unfinished = sorted({r for (r, _), n in remaining_round.items() if n})
        raise RuntimeError(
            f"pipeline simulation deadlock; unfinished requests: {unfinished[:10]}"
        )

    return PipelineResult(
        n_requests=n_requests,
        makespan=makespan,
        arrivals=arrivals,
        completions=completions,
        schedule=schedule,
        aug=aug,
        prompt_chunks=chunks_of,
    )


def validate_pipeline_schedule(
    graph: OpGraph,
    placement: Mapping[int, int],
    cost: CostModel,
    result: PipelineResult,
    *,
    atol: float = 1e-9,
) -> None:
    """Every MILP constraint family, extended across requests: per-request
    precedence through comm nodes, zero-cost co-located flows, and
    non-overlap per shared resource over ALL requests' tasks.  Runs with
    prefill rounds too (``prompt_len > 0``): each prefill pass obeys the
    same precedence/flow families, chunks execute strictly in order, and
    the decode pass starts only after the last chunk."""
    sched = result.schedule
    aug = result.aug

    for rid in range(result.n_requests):
        for (u, v), q in aug.edge_to_comm.items():
            assert sched[(rid, u)].end <= sched[(rid, q)].start + atol
            assert sched[(rid, q)].end <= sched[(rid, v)].start + atol
        for q, c in aug.comm.items():
            if placement[c.src] == placement[c.dst]:
                assert sched[(rid, q)].end - sched[(rid, q)].start <= atol

    # prefill rounds: same families per chunk, plus strict chunk ordering
    chunks_of = result.prompt_chunks or [[] for _ in range(result.n_requests)]
    for rid, chunks in enumerate(chunks_of):
        prev_end = None
        for r in range(len(chunks)):
            key = lambda t: (rid, ("prefill", r, t))
            for (u, v), q in aug.edge_to_comm.items():
                assert sched[key(u)].end <= sched[key(q)].start + atol
                assert sched[key(q)].end <= sched[key(v)].start + atol
            for q, c in aug.comm.items():
                if placement[c.src] == placement[c.dst]:
                    assert sched[key(q)].end - sched[key(q)].start <= atol
            recs = [sched[key(t)] for t in list(graph.nodes) + list(aug.comm)]
            assert all(rec.kind.startswith("prefill-") for rec in recs)
            start = min(rec.start for rec in recs)
            if prev_end is not None:
                assert start >= prev_end - atol, (
                    f"request {rid} prefill chunk {r} starts before chunk "
                    f"{r - 1} completes"
                )
            prev_end = max(rec.end for rec in recs)
        if chunks:
            decode_start = min(
                sched[(rid, t)].start for t in list(graph.nodes) + list(aug.comm)
            )
            assert decode_start >= prev_end - atol, (
                f"request {rid} decode starts before its prefill completes"
            )

    for nid in graph.nodes:
        assert 0 <= placement[nid] < cost.cluster.k
    assert cost.memory_ok(graph, placement), "memory constraint violated"

    by_res: Dict[Tuple, List[TaskRecord]] = {}
    for r in sched.values():
        if r.resource != ("local",) and r.end > r.start:
            by_res.setdefault(r.resource, []).append(r)
    for res, recs in by_res.items():
        recs.sort(key=lambda r: r.start)
        for a, b in zip(recs, recs[1:]):
            assert a.end <= b.start + atol, (
                f"cross-request overlap on {res}: task {a.task_id} "
                f"[{a.start},{a.end}] vs task {b.task_id} [{b.start},{b.end}]"
            )


def bottleneck_time(
    graph: OpGraph,
    placement: Mapping[int, int],
    cost: CostModel,
    *,
    decode_batch: int = 1,
    prompt_len: int = 0,
    prefill_chunk: Optional[int] = None,
    graph_seq_len: Optional[int] = None,
    aug: Optional[AugmentedDAG] = None,
    fused_prefill: bool = False,
) -> float:
    """Per-request busy time of the most loaded resource (device or channel).

    This is the steady-state completion interval of a saturated pipeline —
    requests/sec → 1 / bottleneck_time — and the objective minimized by
    ``plan(..., objective="throughput")``.  It deliberately ignores the
    critical-path length (pipeline fill), which only affects latency.
    ``decode_batch > 1`` charges ops their batch-aware amortized per-request
    cost (one weight stream per batched decode step — see
    ``CostModel.compute_time``).  ``prompt_len > 0`` adds each request's
    chunked-prefill work (``prefill_chunk`` tokens per pass, whole-prompt
    when None) to the same per-resource busy sums — prompt-heavy workloads
    stop scoring as if prompts were free (see :func:`prefill_busy`).
    ``fused_prefill`` charges those chunks the fused mixed-batch marginal
    rate, matching the engine's one-program-per-step serving path."""
    aug = aug or augment(graph)
    busy: Dict[Tuple, float] = {}
    for nid, node in graph.nodes.items():
        k = placement[nid]
        key = ("dev", k)
        # meta["pass_rate"] = forwards per committed token (speculative
        # joint graphs: target 1/E, draft k/E); absent → 1.0.  Prefill work
        # below is NOT scaled: both models prefill the prompt exactly once.
        busy[key] = busy.get(key, 0.0) + cost.compute_time(
            node, k, batch=decode_batch
        ) * float(node.meta.get("pass_rate", 1.0))
    for q, c in aug.comm.items():
        ks, kd = placement[c.src], placement[c.dst]
        if ks != kd:
            key = ("chan", ks, kd)
            busy[key] = busy.get(key, 0.0) + cost.comm_time(
                c.bytes, ks, kd
            ) * float(graph.nodes[c.src].meta.get("pass_rate", 1.0))
    if prompt_len and prompt_len > 0:
        for key, t in prefill_busy(
            graph, placement, cost,
            prompt_len=prompt_len, prefill_chunk=prefill_chunk,
            seq_len=graph_seq_len, aug=aug, fused_prefill=fused_prefill,
        ).items():
            busy[key] = busy.get(key, 0.0) + t
    return max(busy.values()) if busy else 0.0


def evaluate(
    graph: OpGraph,
    placement: Mapping[int, int],
    cost: CostModel,
    *,
    runtime_fusion_rules=None,
) -> float:
    """Makespan of a placement; optionally apply backend runtime fusion first
    (placements computed on the ORIGINAL graph still benefit from co-located
    fusible chains — the paper's Fig. 10 a/b evaluation)."""
    if runtime_fusion_rules is not None:
        from .fusion import runtime_fuse

        graph, placement = runtime_fuse(graph, dict(placement), runtime_fusion_rules)
    return simulate(graph, placement, cost).makespan
