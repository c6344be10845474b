"""Joint replica-count × placement planning (the service-level planner).

Everything in :mod:`repro_torch.core.placement` plans ONE pipeline over the whole
cluster.  At service scale the better question is *how many* pipelines the
cluster should be partitioned into: r copies of the model, each placed on a
device subset by the single-pipeline planner, together serve ``Σ 1/bneck_i``
req/s — usually far more than one wide pipeline whose bottleneck stage is
pinned by the slowest resource (and whose cross-island hops are priced by
the same link model the subclusters inherit).

:func:`plan_replicas` searches replica counts jointly with per-replica
device subsets:

* **candidate generation** (greedy cluster splits, cheap): for each replica
  count ``r``, a balanced LPT split by peak flops plus a locality split
  that seeds the ``r`` fastest devices and attaches every remaining device
  to the seed it has the widest effective path to (so thin inter-island
  links become partition boundaries instead of pipeline hops);
* **per-candidate placement** (expensive, cached): each distinct device
  subset is planned once by :func:`repro_torch.core.placement.plan` on
  ``cluster.subcluster(...)`` — the full MILP + heuristic-envelope pipeline,
  with the configured workload (slots, prompt length, chunked/fused
  prefill) — and scored by its bottleneck-stage time;
* **SLO check** (simulation): the offered Poisson load (``cfg.slo_rate``,
  default 80% of the candidate's aggregate capacity) is split across
  replicas proportionally to their capacity and each replica is run through
  :func:`repro_torch.core.simulate.simulate_pipeline`; the service p99 is the max
  over replicas, compared against ``cfg.slo_p99``.

The single-replica path is bit-identical to ``plan()``: with
``replicas=1`` the one candidate is the FULL device set planned on the
ORIGINAL cluster object (no subcluster round-trip), so the returned
``PlacementResult`` is exactly what ``plan(graph, cluster, cfg)`` returns
(regression-tested in tests/test_replica_plan.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from .costmodel import CostModel
from .devices import ClusterSpec
from .graph import OpGraph
from .milp import PlacementResult

# simulated requests per replica for the p99 SLO check: enough for a p99 to
# mean something beyond the warmup transient, small enough that auto mode's
# candidate sweep stays interactive
SLO_SIM_REQUESTS = 24
# with no explicit slo_rate, check the SLO at this utilization of the
# candidate plan's aggregate steady capacity
DEFAULT_SLO_UTILIZATION = 0.8


@dataclass
class ReplicaSpec:
    """One replica of the service plan: which ORIGINAL cluster devices it
    owns, the single-pipeline placement solved on that subset (node id →
    original device index), its bottleneck-stage seconds / steady req/s
    under the configured workload, and the simulated p99 latency at its
    share of the offered load."""

    devices: List[int]                   # original cluster device indices
    result: PlacementResult              # placement remapped to original idx
    bottleneck_s: float
    throughput_rps: float
    p99_s: float = float("nan")


@dataclass
class ServicePlan:
    """Outcome of :func:`plan_replicas`: the chosen replicas, their summed
    steady capacity, the service p99 (max over replicas) at the offered
    load, whether that met the SLO, and an ``extra`` dict (offered rate,
    candidates examined, per-candidate scores) for operator logs."""

    replicas: List[ReplicaSpec]
    total_rps: float
    p99_s: float
    slo_ok: bool
    extra: dict = field(default_factory=dict)

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)


def _balanced_split(cluster: ClusterSpec, r: int) -> List[List[int]]:
    """LPT by peak flops: fastest-first, each device to the lightest group."""
    order = sorted(range(cluster.k), key=lambda i: -cluster.devices[i].peak_flops)
    groups: List[List[int]] = [[] for _ in range(r)]
    load = [0.0] * r
    for i in order:
        g = min(range(r), key=lambda j: (load[j], j))
        groups[g].append(i)
        load[g] += cluster.devices[i].peak_flops
    return [sorted(g) for g in groups if g]


def _locality_split(cluster: ClusterSpec, r: int) -> List[List[int]]:
    """Seed the r fastest devices; every other device joins the seed it has
    the widest effective path to (ties → lightest group).  Thin inter-island
    links end up as partition boundaries, not pipeline hops."""
    order = sorted(range(cluster.k), key=lambda i: -cluster.devices[i].peak_flops)
    seeds = order[:r]
    groups: List[List[int]] = [[s] for s in seeds]
    load = [cluster.devices[s].peak_flops for s in seeds]
    for i in order[r:]:
        best = max(
            range(r),
            key=lambda j: (cluster.effective_bw(seeds[j], i), -load[j], -j),
        )
        groups[best].append(i)
        load[best] += cluster.devices[i].peak_flops
    return [sorted(g) for g in groups if g]


def _required_bytes(graph: OpGraph, cost: CostModel, slots: int) -> float:
    """Resident bytes one replica needs: params + slots × KV over all ops."""
    return sum(
        cost.resident_bytes(node, slots) for node in graph.nodes.values()
    )


def plan_replicas(
    graph: OpGraph,
    cluster: ClusterSpec,
    config=None,
    *,
    cost: Optional[CostModel] = None,
    **overrides,
) -> ServicePlan:
    """Partition ``cluster`` into replicas and place each — see module doc.

    Reads the replica fields of :class:`repro_torch.core.placement.PlanConfig`
    (``replicas``, ``slo_p99``, ``slo_rate``, ``max_replicas``) plus the
    usual workload fields; every other knob (method, solver budgets,
    prompt/prefill workload) is forwarded verbatim to the per-subset
    ``plan()`` calls.  Returns the feasible (SLO-meeting, if an SLO is
    configured) candidate with the highest total steady req/s; if no
    candidate meets the SLO the highest-throughput one is returned with
    ``slo_ok=False`` so callers can decide to shed load instead of serving
    a silently-violated SLO.
    """
    from .placement import PlanConfig, plan
    from .simulate import bottleneck_time, simulate_pipeline

    cfg = replace(config) if config is not None else PlanConfig()
    for k_, v_ in overrides.items():
        setattr(cfg, k_, v_)
    cost = cost or CostModel(cluster)
    slots = max(int(cfg.serving_slots), 1)
    graph_seq_len = getattr(graph, "seq_len", None)

    need = _required_bytes(graph, cost, slots)
    total_mem = sum(d.mem_bytes for d in cluster.devices)
    fit_cap = max(1, int(total_mem // need)) if need > 0 else cluster.k
    hard_cap = min(cluster.k, fit_cap)
    if cfg.max_replicas is not None:
        hard_cap = min(hard_cap, max(1, int(cfg.max_replicas)))

    if cfg.replicas == "auto":
        counts = list(range(1, hard_cap + 1))
    else:
        r = int(cfg.replicas)
        if not 1 <= r <= cluster.k:
            raise ValueError(
                f"replicas={r} outside 1..{cluster.k} for {cluster.name}"
            )
        counts = [r]

    # ---- candidate partitions, deduped across generators and counts ------
    partitions: List[Tuple[Tuple[int, ...], ...]] = []
    seen = set()
    for r in counts:
        gens = [[list(range(cluster.k))]] if r == 1 else [
            _balanced_split(cluster, r),
            _locality_split(cluster, r),
        ]
        for groups in gens:
            if len(groups) != r:
                continue
            # one replica must FIT its model copy (params + slots × KV)
            if any(
                sum(cluster.devices[i].mem_bytes for i in g) < need
                for g in groups
            ):
                continue
            key = frozenset(frozenset(g) for g in groups)
            if key in seen:
                continue
            seen.add(key)
            partitions.append(tuple(tuple(g) for g in groups))

    if not partitions:
        raise ValueError(
            f"no replica partition of {cluster.name} fits the model: "
            f"need {need:.3g} bytes per replica"
        )

    # ---- per-subset planning, cached by device set -----------------------
    # (the balanced and locality splits frequently agree on some groups)
    plan_cache: Dict[Tuple[int, ...], Tuple[PlacementResult, float]] = {}

    def _plan_group(group: Tuple[int, ...]) -> Tuple[PlacementResult, float]:
        if group in plan_cache:
            return plan_cache[group]
        full = group == tuple(range(cluster.k))
        # the full set plans on the ORIGINAL cluster object — plan()'s
        # result is bit-identical to the pre-replica single-pipeline path
        sub = cluster if full else cluster.subcluster(group)
        sub_cost = cost if full else CostModel(sub)
        res = plan(graph, sub, cfg, cost=sub_cost)
        bneck = bottleneck_time(
            graph, res.placement, sub_cost,
            prompt_len=max(int(cfg.prompt_len), 0),
            prefill_chunk=cfg.prefill_chunk,
            graph_seq_len=graph_seq_len,
            fused_prefill=bool(cfg.fused_prefill),
        )
        plan_cache[group] = (res, bneck)
        return plan_cache[group]

    def _sim_p99(group: Tuple[int, ...], res: PlacementResult, rate: float) -> float:
        full = group == tuple(range(cluster.k))
        sub_cost = cost if full else CostModel(cluster.subcluster(group))
        sim = simulate_pipeline(
            graph, res.placement, sub_cost, SLO_SIM_REQUESTS,
            ("poisson", rate, cfg.seed),
            max_in_flight=slots, decode_batch=slots,
            prompt_len=max(int(cfg.prompt_len), 0) or None,
            prefill_chunk=cfg.prefill_chunk if cfg.prompt_len else None,
            graph_seq_len=graph_seq_len,
            fused_prefill=bool(cfg.fused_prefill),
        )
        return sim.latency_percentile(99.0)

    # ---- score every candidate -------------------------------------------
    scored = []
    for groups in partitions:
        planned = [(_plan_group(g), g) for g in groups]
        rps = [1.0 / b if b > 0 else float("inf") for (_, b), _g in planned]
        total = sum(rps)
        offered = (
            float(cfg.slo_rate) if cfg.slo_rate
            else DEFAULT_SLO_UTILIZATION * total
        )
        p99 = 0.0
        for ((res, _b), g), rp in zip(planned, rps):
            share = offered * (rp / total if total > 0 else 1.0 / len(planned))
            p99 = max(p99, _sim_p99(g, res, share))
        ok = cfg.slo_p99 is None or p99 <= float(cfg.slo_p99)
        scored.append((groups, planned, total, offered, p99, ok))

    scored.sort(key=lambda t: (not t[5], -t[2], len(t[0])))
    groups, planned, total, offered, p99, ok = scored[0]

    replicas = []
    for ((res, bneck), g) in planned:
        full = g == tuple(range(cluster.k))
        if full:
            mapped = res
        else:
            # lift subcluster-local device indices back to the original
            # cluster's numbering (the router and engines speak original ids)
            mapped = replace(
                res,
                placement={nid: g[k] for nid, k in res.placement.items()},
                channels={
                    q: (g[a], g[b]) for q, (a, b) in res.channels.items()
                },
                extra={**res.extra, "devices": list(g), "subcluster": True},
            )
        replicas.append(
            ReplicaSpec(
                devices=list(g),
                result=mapped,
                bottleneck_s=bneck,
                throughput_rps=1.0 / bneck if bneck > 0 else float("inf"),
                p99_s=p99,
            )
        )
    return ServicePlan(
        replicas=replicas,
        total_rps=total,
        p99_s=p99,
        slo_ok=ok,
        extra={
            "offered_rps": offered,
            "slo_p99": cfg.slo_p99,
            "candidates": [
                {
                    "groups": [list(g) for g in c_groups],
                    "total_rps": c_total,
                    "p99_s": c_p99,
                    "slo_ok": c_ok,
                }
                for c_groups, _p, c_total, _o, c_p99, c_ok in scored
            ],
            "replica_counts_searched": counts,
            "memory_replica_cap": hard_cap,
        },
    )
