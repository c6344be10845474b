"""Heuristic device-placement baselines the paper compares against.

* ``etf``  — classic Earliest Task First list scheduling, communication-aware
  (Hwang et al.), extended with memory feasibility.
* ``getf`` — GETF [Su et al., arXiv:2004.14639]: ETF generalized to *related*
  (heterogeneously fast) machines via group assignment: tasks are first
  mapped to machine *speed groups* by a work-threshold rule, then ETF runs
  restricted to each task's group (our implementation of the paper's
  description; the original's LP grouping is approximated by the
  work-threshold rule, documented in DESIGN.md).
* ``msct`` — m-SCT from Baechi [Jeon et al., SoCC'20]: Small-Communication-
  Time scheduling; each task designates a *favorite child* (the successor
  whose co-location saves the largest communication cost); a device that
  finishes task i prefers i's favorite child, otherwise falls back to the
  earliest-start rule.  Memory-capped per device as in Baechi.
* ``bottleneck_balance`` — throughput-oriented list scheduler: instead of the
  earliest finish (a latency objective), each ready task goes to the device
  minimizing the resulting *bottleneck-stage time* — the largest per-request
  busy time over any device or channel — which is the steady-state completion
  interval of a saturated serving pipeline (see core.simulate.bottleneck_time
  and the pipelined partitioning objective of Tarnawski et al.).
* ``round_robin`` / ``single_device`` — sanity baselines.  Their ``objective``
  is the simulated makespan of the produced placement (NOT NaN: a NaN
  objective poisons best-candidate selection because every NaN comparison is
  False, silently keeping or dropping the candidate by iteration order).

All heuristics return a ``PlacementResult`` whose ``objective`` is their own
internal schedule estimate; benchmarks re-evaluate every method through the
same event simulator for fairness.  Every heuristic accepts
``serving_slots``: memory feasibility charges each op ``param_bytes +
serving_slots × kv_bytes`` (Eq. 5's KV-aware resident cost), and ``getf`` /
``msct`` additionally accept ``objective="throughput"`` to run their
group-restricted / favorite-child searches under the bottleneck-stage
criterion instead of earliest finish.
"""

from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .costmodel import CostModel
from .graph import OpGraph
from .milp import PlacementResult


def _comm_ready_time(
    cost: CostModel,
    graph: OpGraph,
    nid: int,
    k: int,
    placement: Dict[int, int],
    end: Dict[int, float],
) -> float:
    """Earliest time all inputs of ``nid`` are available on device ``k``."""
    t = 0.0
    for p in graph.nodes[nid].inputs:
        arr = end[p] + cost.comm_time(graph.nodes[p].output_bytes, placement[p], k)
        t = max(t, arr)
    return t


def _greedy_list_schedule(
    graph: OpGraph,
    cost: CostModel,
    *,
    eligible: Optional[Dict[int, List[int]]] = None,
    favorite: Optional[Dict[int, int]] = None,
    name: str = "etf",
    candidate_key=None,
    on_commit=None,
    objective_fn=None,
    serving_slots: int = 1,
) -> PlacementResult:
    """Shared engine for every list scheduler: pick the (ready task, device)
    candidate with the smallest key, respecting memory.

    ``eligible`` restricts device choices per task; ``favorite`` gives
    m-SCT's co-location preference.  ``candidate_key(nid, k, s, f)``
    overrides the earliest-finish ordering entirely (bottleneck_balance);
    ``on_commit(nid, k)`` lets the caller maintain its own scoring state;
    ``objective_fn()`` overrides the reported objective (default: makespan
    of the internal schedule).  ``serving_slots`` makes the memory check
    KV-aware (Eq. 5 resident cost)."""
    t0 = _time.perf_counter()
    K = cost.cluster.k
    caps = np.array([d.mem_bytes for d in cost.cluster.devices])
    usage = np.zeros(K)

    def _resident(nid: int) -> float:
        return cost.resident_bytes(graph.nodes[nid], serving_slots)

    indeg = {nid: len(n.inputs) for nid, n in graph.nodes.items()}
    ready: Set[int] = {nid for nid, d in indeg.items() if d == 0}
    placement: Dict[int, int] = {}
    start: Dict[int, float] = {}
    end: Dict[int, float] = {}
    dev_free = np.zeros(K)
    last_on_dev: Dict[int, int] = {}  # device -> last scheduled op

    n_total = len(graph.nodes)
    while len(placement) < n_total:
        # candidate (start_time, finish_time, task, device)
        best = None
        for nid in ready:
            node = graph.nodes[nid]
            devs = eligible.get(nid, list(range(K))) if eligible else range(K)
            for k in devs:
                if usage[k] + _resident(nid) > caps[k]:
                    continue
                s = max(dev_free[k], _comm_ready_time(cost, graph, nid, k, placement, end))
                f = s + cost.compute_time(node, k)
                if candidate_key is not None:
                    key = candidate_key(nid, k, s, f)
                else:
                    # m-SCT preference: a device whose last op designated nid
                    # as favorite child gets a tie-breaking bonus (co-location)
                    fav_bonus = (
                        favorite is not None
                        and favorite.get(last_on_dev.get(k, -1)) == nid
                    )
                    key = (s, not fav_bonus, f, nid, k)
                if best is None or key < best[0]:
                    best = (key, nid, k, s, f)
        if best is None:
            # all ready tasks are memory-blocked everywhere: relax memory on
            # the least-used device (flagged infeasible)
            nid = min(ready)
            k = int(np.argmin(usage))
            s = max(dev_free[k], _comm_ready_time(cost, graph, nid, k, placement, end))
            f = s + cost.compute_time(graph.nodes[nid], k)
            best = (None, nid, k, s, f)
        _, nid, k, s, f = best
        placement[nid] = k
        start[nid], end[nid] = s, f
        usage[k] += _resident(nid)
        dev_free[k] = f
        last_on_dev[k] = nid
        if on_commit is not None:
            on_commit(nid, k)
        ready.discard(nid)
        for succ in graph.nodes[nid].outputs:
            indeg[succ] -= 1
            if indeg[succ] == 0:
                ready.add(succ)

    feasible = bool(np.all(usage <= caps))
    if objective_fn is not None:
        obj = objective_fn()
    else:
        obj = max(end.values()) if end else 0.0
    return PlacementResult(
        placement=placement,
        objective=obj,
        status="feasible" if feasible else "memory-relaxed",
        mip_gap=float("nan"),
        solve_time=_time.perf_counter() - t0,
        method=name,
        start_times=start,
        end_times=end,
    )


def _bottleneck_scorer(graph: OpGraph, cost: CostModel):
    """Shared bottleneck-stage scoring state for throughput-mode schedulers.

    Returns ``(candidate_key, on_commit, objective_fn)`` closures over mutable
    per-resource busy accumulators: the key of placing ``nid`` on ``k`` is the
    resulting max per-request busy time over every device and directed
    channel (see core.simulate.bottleneck_time), tie-broken by earliest
    finish."""
    K = cost.cluster.k
    dev_busy = np.zeros(K)                        # per-request compute busy
    chan_busy: Dict[Tuple[int, int], float] = {}  # per-request channel busy
    placed: Dict[int, int] = {}

    def key(nid: int, k: int, s: float, f: float):
        node = graph.nodes[nid]
        peak = dev_busy[k] + cost.compute_time(node, k)
        for j in range(K):
            if j != k and dev_busy[j] > peak:
                peak = dev_busy[j]
        extra: Dict[Tuple[int, int], float] = {}
        for p in node.inputs:
            kp = placed[p]
            if kp != k:
                t = cost.comm_time(graph.nodes[p].output_bytes, kp, k)
                extra[(kp, k)] = extra.get((kp, k), 0.0) + t
        for ch, t in chan_busy.items():
            peak = max(peak, t + extra.pop(ch, 0.0))
        for t in extra.values():
            peak = max(peak, t)
        return (peak, f, nid, k)

    def commit(nid: int, k: int):
        node = graph.nodes[nid]
        placed[nid] = k
        dev_busy[k] += cost.compute_time(node, k)
        for p in node.inputs:
            kp = placed[p]
            if kp != k:
                t = cost.comm_time(graph.nodes[p].output_bytes, kp, k)
                chan_busy[(kp, k)] = chan_busy.get((kp, k), 0.0) + t

    def objective():
        # bottleneck-stage time of the final placement, not makespan
        peak = float(dev_busy.max()) if K else 0.0
        return max(peak, max(chan_busy.values())) if chan_busy else peak

    return key, commit, objective


def etf(graph: OpGraph, cost: CostModel, *, serving_slots: int = 1) -> PlacementResult:
    return _greedy_list_schedule(graph, cost, name="etf", serving_slots=serving_slots)


def getf(
    graph: OpGraph,
    cost: CostModel,
    *,
    objective: str = "latency",
    serving_slots: int = 1,
) -> PlacementResult:
    """GETF: group machines by speed; heavy tasks are restricted to the fast
    group, light tasks may go anywhere (the work-threshold grouping).

    ``objective="throughput"`` keeps the grouping but replaces the
    earliest-finish candidate rule with the bottleneck-stage criterion, so the
    baseline optimizes the same quantity as the throughput MILP (fair
    Fig. 10-style comparison — ROADMAP open item)."""
    K = cost.cluster.k
    speeds = np.array([d.peak_flops for d in cost.cluster.devices])
    fast = set(np.argsort(-speeds)[: max(1, K // 2)].tolist())
    flops = np.array([graph.nodes[n].flops for n in graph.nodes])
    thresh = float(np.quantile(flops, 0.75)) if len(flops) else 0.0
    eligible = {
        nid: (sorted(fast) if graph.nodes[nid].flops >= thresh and thresh > 0 else list(range(K)))
        for nid in graph.nodes
    }
    if objective == "throughput":
        key, commit, objective_fn = _bottleneck_scorer(graph, cost)
        return _greedy_list_schedule(
            graph, cost, eligible=eligible, name="getf[throughput]",
            candidate_key=key, on_commit=commit, objective_fn=objective_fn,
            serving_slots=serving_slots,
        )
    return _greedy_list_schedule(
        graph, cost, eligible=eligible, name="getf", serving_slots=serving_slots
    )


def msct(
    graph: OpGraph,
    cost: CostModel,
    *,
    objective: str = "latency",
    serving_slots: int = 1,
) -> PlacementResult:
    """m-SCT: favorite child = the most *critical* successor (largest
    bottom-level, i.e. longest remaining path to a sink) — co-locating it
    saves its input communication on the critical path, per Hanen–Munier SCT
    as used in Baechi.

    ``objective="throughput"`` keeps the favorite-child preference but swaps
    the earliest-finish candidate rule for the bottleneck-stage criterion
    (same scorer as ``bottleneck_balance``/``getf[throughput]``): the
    favorite breaks ties among equal-bottleneck choices, so the baseline
    optimizes the quantity the throughput MILP optimizes while retaining
    SCT's communication-avoiding structure (ROADMAP follow-on)."""
    if objective not in ("latency", "throughput"):
        raise ValueError(
            f"objective must be latency|throughput, got {objective!r}"
        )
    K = cost.cluster.k
    mean_t = {
        nid: float(np.mean([cost.compute_time(n, k) for k in range(K)]))
        for nid, n in graph.nodes.items()
    }
    bottom: Dict[int, float] = {}
    for nid in reversed(graph.topo_order()):
        node = graph.nodes[nid]
        bottom[nid] = mean_t[nid] + max((bottom[s] for s in node.outputs), default=0.0)
    favorite: Dict[int, int] = {}
    for nid, node in graph.nodes.items():
        if node.outputs:
            favorite[nid] = max(node.outputs, key=lambda s: (bottom[s], -s))
    if objective == "throughput":
        bkey, bcommit, objective_fn = _bottleneck_scorer(graph, cost)
        last_on_dev: Dict[int, int] = {}  # device -> last scheduled op

        def key(nid: int, k: int, s: float, f: float):
            peak, f_, nid_, k_ = bkey(nid, k, s, f)
            fav = favorite.get(last_on_dev.get(k, -1)) == nid
            return (peak, not fav, f_, nid_, k_)

        def commit(nid: int, k: int):
            bcommit(nid, k)
            last_on_dev[k] = nid

        return _greedy_list_schedule(
            graph, cost, name="m-sct[throughput]",
            candidate_key=key, on_commit=commit, objective_fn=objective_fn,
            serving_slots=serving_slots,
        )
    return _greedy_list_schedule(
        graph, cost, favorite=favorite, name="m-sct", serving_slots=serving_slots
    )


def bottleneck_balance(
    graph: OpGraph, cost: CostModel, *, serving_slots: int = 1
) -> PlacementResult:
    """Throughput list scheduler: greedily minimize the bottleneck-stage time.

    Tasks are taken in ready order; each is placed on the device whose choice
    yields the smallest max-loaded resource (device compute busy + directed
    channel busy, per request), tie-broken by earliest finish (so the
    schedule stays latency-sane among equal-bottleneck choices).  Runs on the
    shared list-schedule engine — the memory handling and ready-set logic are
    the common ones; only the candidate scoring differs."""
    key, commit, objective_fn = _bottleneck_scorer(graph, cost)
    return _greedy_list_schedule(
        graph, cost, name="bottleneck-balance",
        candidate_key=key, on_commit=commit, objective_fn=objective_fn,
        serving_slots=serving_slots,
    )


def round_robin(
    graph: OpGraph, cost: CostModel, *, serving_slots: int = 1
) -> PlacementResult:
    from .simulate import simulate

    t0 = _time.perf_counter()
    order = graph.topo_order()
    placement = {nid: i % cost.cluster.k for i, nid in enumerate(order)}
    ok = cost.memory_ok(graph, placement, serving_slots=serving_slots)
    # score through the event simulator: a NaN objective would compare False
    # against everything and corrupt any best-candidate selection downstream
    obj = simulate(graph, placement, cost).makespan
    return PlacementResult(
        placement=placement,
        objective=obj,
        status="feasible" if ok else "memory-relaxed",
        mip_gap=float("nan"),
        solve_time=_time.perf_counter() - t0,
        method="round-robin",
    )


def single_device(
    graph: OpGraph,
    cost: CostModel,
    k: Optional[int] = None,
    *,
    serving_slots: int = 1,
) -> PlacementResult:
    from .simulate import simulate

    t0 = _time.perf_counter()
    if k is None:
        # fastest device that fits the whole model (weights + per-slot KV),
        # else the biggest-memory one
        total = graph.total_param_bytes() + max(serving_slots, 1) * graph.total_kv_bytes()
        fits = [
            i
            for i, d in enumerate(cost.cluster.devices)
            if d.mem_bytes >= total
        ]
        if fits:
            k = max(fits, key=lambda i: cost.cluster.devices[i].peak_flops)
        else:
            k = int(np.argmax([d.mem_bytes for d in cost.cluster.devices]))
    placement = {nid: k for nid in graph.nodes}
    ok = cost.memory_ok(graph, placement, serving_slots=serving_slots)
    obj = simulate(graph, placement, cost).makespan
    return PlacementResult(
        placement=placement,
        objective=obj,
        status="feasible" if ok else "memory-relaxed",
        mip_gap=float("nan"),
        solve_time=_time.perf_counter() - t0,
        method=f"single-device[{k}]",
    )
