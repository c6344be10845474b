"""Public placement API: the four Moirai steps (Fig. 2) behind one call.

    input profiling → graph coarsening → problem modeling → problem solving

``plan()`` runs the full pipeline for any method; ``replan()`` supports
elastic serving (device failure / cluster resize) by re-solving on the
surviving devices — placement is fast relative to model lifetime, which is
exactly the regime the paper targets (offline placement, online serving).

Planning objectives
-------------------
``PlanConfig.objective`` selects what a candidate placement is scored by:

* ``"latency"`` (default, the paper's Eqs. 4–8): single-query makespan from
  the event simulator — right for interactive, one-request-at-a-time use.
* ``"throughput"``: bottleneck-stage time — the largest per-request busy
  time over any device or channel (``core.simulate.bottleneck_time``).  In a
  saturated serving pipeline requests complete once per bottleneck interval,
  so minimizing it maximizes steady-state requests/sec even when it costs
  single-query latency (classic pipelined-partitioning objective; see
  Tarnawski et al.).  The MILP is objective-native: in throughput mode it
  minimizes the max per-resource busy time directly (busy-time accumulators
  over Eqs. 4/6/7/8 kept as feasibility — see core.milp), the envelope is
  widened with the ``bottleneck_balance`` list scheduler (and a
  throughput-mode GETF), and every candidate is scored by bottleneck time.

``PlanConfig.serving_slots`` threads the engine's concurrent-request count
into Eq. 5: every op's resident cost is ``param_bytes + serving_slots ×
kv_bytes`` (one KV-cache copy per in-flight request), for the MILP, every
heuristic's memory caps, and candidate scoring alike.
"""

from __future__ import annotations

import dataclasses
import time as _time
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional, Sequence

from .costmodel import CostModel
from .devices import ClusterSpec
from .fusion import DEFAULT_RULES, gcof
from .graph import OpGraph
from .heuristics import (
    bottleneck_balance,
    etf,
    getf,
    msct,
    round_robin,
    single_device,
)
from .hierarchy import (
    _count_unordered_pairs,
    chain_contract,
    cluster_graph,
    lift_placement,
)
from .milp import PlacementResult, solve_placement

# graphs larger than this go through hierarchical clustering before the MILP
MILP_EXACT_MAX_NODES = 48


@dataclass
class PlanConfig:
    """Every knob of the planning pipeline, in one place.

    Fields
    ------
    method:
        Planner to run — ``"moirai"`` (GCOF coarsening + MILP + heuristic
        envelope, the paper's full pipeline) or a single baseline: ``"etf"``,
        ``"getf"``, ``"msct"``, ``"bottleneck_balance"``, ``"placeto"``,
        ``"round_robin"``, ``"single"``.
    objective:
        What a placement is scored (and the MILP solved) by — ``"latency"``
        (single-query makespan, paper Eqs. 4–8) or ``"throughput"``
        (bottleneck-stage time, the steady-state completion interval of a
        saturated serving pipeline).
    serving_slots:
        Concurrent in-flight requests the serving engine will run; Eq. 5
        charges ``param_bytes + serving_slots × kv_bytes`` of resident
        memory per op in the MILP, every heuristic's memory cap, and
        candidate scoring.
    prompt_len:
        Expected prompt tokens per request (the workload assumption).  In
        throughput mode every candidate's bottleneck score — and the MILP's
        busy-time accumulators — include the per-request chunked-prefill
        work this implies (``core.simulate.prefill_busy``), so prompt-heavy
        workloads are no longer scored as if prompts were free.  ``0``
        (default) keeps the decode-only scoring.
    prefill_chunk:
        Tokens per prefill chunk for that scoring AND the serving engine's
        interleaved prefill state machine (the engine reads it off its
        ``plan_cfg``); ``None`` means whole-prompt (blocking) prefill.
    fused_prefill:
        ``True`` (default) scores prefill chunks at the fused mixed-batch
        marginal rate — the serving engine packs prompt chunks into the
        live decode batch, so a chunk pays no second weight stream or
        kernel launch — and tells the engine to serve that way.  ``False``
        restores standalone per-chunk costing and the legacy interleaved
        engine path.
    coarsen:
        Apply GCOF fusion coarsening before solving (paper Fig. 10 c/d vs
        a/b).
    rules:
        Fusion rule set for GCOF (defaults to ``fusion.DEFAULT_RULES``).
    time_limit:
        MILP solver wall-clock budget in seconds.
    mip_rel_gap:
        Relative optimality gap at which the MILP may stop early.
    congestion:
        Model per-channel flow serialization (Eq. 8) in the MILP.
    max_exact_nodes:
        Largest graph solved exactly; bigger graphs go through chain
        contraction / hierarchical clustering first.
    max_chain_nodes:
        Largest chain-contracted graph still solved exactly.
    pair_budget:
        Cap on non-overlap binary variable pairs for the exact MILP.
    placeto_iters:
        Policy-gradient iterations for the ``"placeto"`` baseline.
    seed:
        RNG seed for stochastic planners (placeto).
    placeto_device:
        Device the placeto policy trains on (``None``: the first card).
    replicas / slo_p99 / slo_rate / max_replicas:
        Replica-partitioning knobs consumed by
        :func:`repro_torch.core.replica.plan_replicas` (re-exported here):
        replica count (``"auto"`` or a fixed int), the p99 latency SLO and
        the offered load it is checked at, and the auto-mode search cap.
        :func:`plan` itself ignores them, so the single-pipeline path is
        bit-identical to the pre-replica planner.
    kv_page_tokens:
        Serve the KV cache as fixed-size pages of this many tokens (block
        paging): the engine allocates pages on demand instead of dense
        ``max_len`` rows, and Eq. 5's resident-memory term charges pages
        actually resident — ``kv_bytes`` is scaled by
        :func:`repro_torch.core.costmodel.paged_kv_factor` (page-rounded expected
        residency) in the MILP, every heuristic cap, and the engine's
        admission guard.  ``None`` (default) keeps dense rows and the
        exact legacy ``slots × kv_bytes`` accounting.
    prefix_sharing:
        With paging, share read-only prompt-prefix pages across requests
        keyed by chunk-aligned prefix hashes: matching prefixes reuse
        pages (their prefill chunks are skipped), diverging writes copy on
        write, and refcount-0 registered pages linger on an LRU ring for
        reuse until evicted.  ``False`` gives every request private pages.
    kv_residency:
        Expected fraction of ``max_len`` a sequence actually occupies —
        scales the paged Eq. 5 term's page count (``1.0`` = worst case,
        every slot full).  Ignored without ``kv_page_tokens``.
    draft_config / spec_tokens / acceptance_rate:
        Speculative-decoding knobs (consumed by
        :func:`repro_torch.core.spec_plan.plan_speculative` and the serving
        engine; :func:`plan` ignores them): the draft model's config name,
        the draft tokens proposed per verify round, and the assumed
        per-token acceptance probability that sets the merged graph's
        pass rates (target ``1/E``, draft ``k/E``).
    """

    method: str = "moirai"           # moirai|etf|getf|msct|bottleneck_balance|placeto|round_robin|single
    # "latency" (makespan) | "throughput" (bottleneck-stage time).  Selects
    # the MILP objective AND what the MOIRAI envelope scores candidates by;
    # objective-aware methods (getf, placeto) optimize it too, the remaining
    # heuristics keep their intrinsic criterion (use
    # method="bottleneck_balance" for a standalone throughput heuristic).
    # extra["objective"] always records the CONFIGURED objective.
    objective: str = "latency"
    # concurrent serving slots: Eq. 5 charges serving_slots × kv_bytes of
    # resident KV cache per op (the engine passes its slot count here)
    serving_slots: int = 1
    # expected prompt tokens per request: throughput-mode scoring (and the
    # MILP busy accumulators) charge the implied chunked-prefill work per
    # request; 0 keeps decode-only scoring
    prompt_len: int = 0
    # prefill chunk size for that scoring and for the engine's interleaved
    # prefill state machine; None = whole-prompt (blocking) prefill
    prefill_chunk: Optional[int] = 64
    # score prefill chunks at the fused mixed-batch marginal rate (the
    # engine's default: chunks packed into the live decode batch share its
    # weight stream and kernel launch).  The engine also reads this to pick
    # its serving path — fused one-program steps (True) vs the legacy
    # interleaved per-slot prefill forwards (False)
    fused_prefill: bool = True
    # ---- paged KV cache (serving engine + Eq. 5 accounting) -------------
    # tokens per KV page: set to page the serving engine's KV cache (fixed
    # page pools per stage device + per-slot page tables) AND switch Eq. 5's
    # KV term — in the MILP, every heuristic's memory cap, and envelope
    # scoring — to pages actually resident (ceil(kv_residency·S/P)·P tokens
    # per slot) instead of dense max_len rows.  None = dense (bit-identical
    # to the pre-paging planner); page_tokens = max_len at kv_residency 1.0
    # reproduces the dense numbers exactly
    kv_page_tokens: Optional[int] = None
    # hash-based prefix sharing across requests (chunk-aligned prefix hashes
    # → refcounted read-only pages, COW on divergence, LRU eviction); the
    # planner does NOT discount for it — sharing is headroom, not a promise
    prefix_sharing: bool = True
    # expected fill fraction of a slot's cache row (typical prompt+generation
    # length / max_len) — the configurable expected-residency estimate the
    # page term charges; 1.0 = worst case
    kv_residency: float = 1.0
    # ---- speculative decoding (read by core.spec_plan.plan_speculative and
    # the serving engine; plan() itself ignores them, so non-speculative
    # planning is untouched) ---------------------------------------------
    # config name of the draft model (e.g. "llama3.2-1b", "mamba2-130m");
    # None disables speculation.  serve.py --draft sets it; the engine
    # builds the draft graph from it and plans draft+target JOINTLY via
    # plan_speculative (merged pass-rate graph, shared Eq. 5 memory)
    draft_config: Optional[str] = None
    # draft tokens proposed per verify round (k); each verify forward is a
    # ragged q_len=k+1 row and a round commits expected_accepted_tokens(
    # acceptance_rate, k) tokens.  0 disables speculation
    spec_tokens: int = 0
    # assumed per-token draft acceptance probability for SCORING (the
    # engine measures the real rate per request class at serve time); sets
    # the pass rates 1/E (target) and k/E (draft) on the merged graph
    acceptance_rate: float = 0.75
    coarsen: bool = True             # GCOF (Fig. 10 c/d vs a/b)
    rules: Optional[Sequence[Sequence[str]]] = None
    time_limit: float = 120.0
    mip_rel_gap: float = 1e-3
    congestion: bool = True
    max_exact_nodes: int = MILP_EXACT_MAX_NODES
    max_chain_nodes: int = 400       # chain-contracted graphs up to this size
    pair_budget: int = 2500          # max non-overlap binaries for exact MILP
    placeto_iters: int = 150
    seed: int = 0
    # where the placeto policy trains: None = the first card, "cpu" on a
    # host without one (the port's addition: the reference runs it on JAX's
    # default device)
    placeto_device: Optional[str] = None
    # ---- replica partitioning (read by core.replica.plan_replicas ONLY;
    # plan() itself ignores these, so single-pipeline planning is untouched)
    # "auto" = search replica counts 1..max_replicas jointly with per-replica
    # device subsets; an int pins the replica count (1 = today's single
    # pipeline, bit-identical)
    replicas: object = 1             # int | "auto"
    # p99 end-to-end request latency SLO in seconds, scored per replica by
    # simulate_pipeline under the Poisson offered load; None = no SLO (pick
    # the highest-throughput partition unconditionally)
    slo_p99: Optional[float] = None
    # offered load (req/s) the SLO is evaluated at; None derives it as 80%
    # of the candidate service plan's aggregate steady capacity
    slo_rate: Optional[float] = None
    # cap on the replica count searched in "auto" mode; None = min(device
    # count, how many copies of the model's resident bytes the cluster fits)
    max_replicas: Optional[int] = None


class NoFeasiblePlacement(ValueError):
    """:func:`plan` found no placement of the graph that fits the cluster
    (device memory, with every serving slot's KV cache resident): a loss no
    re-plan can absorb.  A ``ValueError``, typed so that a caller (the
    router) can tell this loss from a fault of the program."""


class NoSurvivingDevices(NoFeasiblePlacement):
    """:func:`replan` found every device of the cluster failed (a
    ``ValueError`` in the reference too)."""


def plan(
    graph: OpGraph,
    cluster: ClusterSpec,
    config: Optional[PlanConfig] = None,
    *,
    cost: Optional[CostModel] = None,
    **overrides,
) -> PlacementResult:
    """Place ``graph`` on ``cluster`` — the full Moirai pipeline in one call.

    Args:
        graph: computation graph to place (any granularity).
        cluster: heterogeneous device + link model the placement targets.
        config: :class:`PlanConfig` selecting method, objective, slots, and
            solver budgets (defaults to ``PlanConfig()``).
        cost: optional pre-built :class:`CostModel` (defaults to a fresh
            roofline model over ``cluster``).
        **overrides: individual ``PlanConfig`` field overrides applied on
            top of ``config`` (e.g. ``plan(g, c, method="etf")``).

    Returns:
        A :class:`PlacementResult` whose ``placement`` maps ORIGINAL node
        ids (coarsening is lifted back) to device indices; ``extra`` records
        the configured objective, serving slots, and coarsening stats.  For
        ``method="moirai"`` the result is the best of the MILP route and
        the heuristic pool under the configured objective (the envelope),
        so Moirai ≥ best heuristic always holds.
    """
    cfg = config or PlanConfig()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    if cost is None:
        cost = CostModel(cluster)
    if getattr(cfg, "kv_page_tokens", None) and cost.kv_page_tokens is None:
        # paged Eq. 5: charge resident pages, not dense rows — the SAME
        # accounting the serving engine's admission uses, threaded through
        # the MILP memory term, heuristic caps, and envelope scoring via
        # this one cost model.  (A caller-supplied paged cost is respected.)
        cost = dataclasses.replace(
            cost,
            kv_page_tokens=int(cfg.kv_page_tokens),
            kv_seq_tokens=getattr(graph, "seq_len", None),
            kv_residency=float(getattr(cfg, "kv_residency", 1.0) or 1.0),
        )
    if cfg.objective not in ("latency", "throughput"):
        raise ValueError(f"unknown objective {cfg.objective!r}")

    t0 = _time.perf_counter()
    rules = cfg.rules if cfg.rules is not None else DEFAULT_RULES
    slots = max(int(cfg.serving_slots), 1)

    from .simulate import bottleneck_time as _bneck, simulate as _sim

    # prefill-aware throughput scoring needs the token count the graph costs
    # were built at; coarsened/contracted work graphs lose the attribute, so
    # resolve it from the ORIGINAL graph once
    prompt = max(int(cfg.prompt_len), 0) if cfg.objective == "throughput" else 0
    graph_seq_len = getattr(graph, "seq_len", None)

    def _bneck_cfg(g_, pl) -> float:
        """Bottleneck-stage time under the configured workload: decode plus
        (with ``cfg.prompt_len``) each request's chunked-prefill work."""
        return _bneck(
            g_, pl, cost,
            prompt_len=prompt, prefill_chunk=cfg.prefill_chunk,
            graph_seq_len=graph_seq_len,
            fused_prefill=bool(getattr(cfg, "fused_prefill", True)),
        )

    def _score(g_, pl) -> float:
        """What a candidate placement is worth under the configured objective.

        A placement that overflows device memory once every serving slot's
        KV cache is resident scores infinite — the envelope must never pick a
        candidate the serving engine cannot actually admit."""
        if slots > 1 and not cost.memory_ok(g_, pl, serving_slots=slots):
            return float("inf")
        if cfg.objective == "throughput":
            return _bneck_cfg(g_, pl)
        return _sim(g_, pl, cost).makespan

    # the heuristic candidate pool (closed over the slot count so memory
    # feasibility is KV-aware); the throughput objective adds the
    # bottleneck-balancing scheduler and switches GETF and m-SCT to their
    # bottleneck-criterion modes (ETF keeps chasing earliest finish)
    def _h_msct(g_):
        return msct(g_, cost, objective=cfg.objective, serving_slots=slots)

    def _h_etf(g_):
        return etf(g_, cost, serving_slots=slots)

    def _h_getf(g_):
        return getf(g_, cost, objective=cfg.objective, serving_slots=slots)

    def _h_bneck(g_):
        return bottleneck_balance(g_, cost, serving_slots=slots)

    heuristic_pool = (_h_msct, _h_etf, _h_getf)
    if cfg.objective == "throughput":
        heuristic_pool = heuristic_pool + (_h_bneck,)

    # ------------------------------------------------ step 2: coarsening
    work = gcof(graph, rules) if cfg.coarsen else graph
    # map coarse node -> original members for lifting back
    members = {
        nid: (node.fused_ids if node.fused_ids else (nid,))
        for nid, node in work.nodes.items()
    }

    # ------------------------------------------- steps 3+4: model & solve
    if cfg.method == "moirai":
        target = work
        member_to_super = None
        if len(work) > cfg.max_exact_nodes:
            # two-stage decomposition: chain contraction first (keeps parallel
            # branches placeable — topo windows would collapse them), exact
            # MILP if the unordered-pair count stays tractable, windows only
            # as the last resort
            chained, chain_map = chain_contract(work)
            pairs = _count_unordered_pairs(chained, cfg.pair_budget)
            if (
                len(chained) <= cfg.max_chain_nodes
                and pairs <= cfg.pair_budget
            ):
                target, member_to_super = chained, chain_map
            else:
                target, member_to_super = cluster_graph(work, cfg.max_exact_nodes)
        # prime the exact solve with the best heuristic schedule: a greedy
        # list schedule satisfies every MILP constraint family (including
        # KV-aware Eq. 5 — its memory caps charge the same resident cost), so
        # its score is a valid incumbent bound (T ≤ UB) in the MILP's OWN
        # objective units: makespan for "latency", bottleneck busy time for
        # "throughput".  (The horizon is NOT clamped to a heuristic makespan
        # in throughput mode: the throughput-optimal placement may need a
        # longer single-query schedule than any latency heuristic's.)
        ub = None
        for h in heuristic_pool:
            r = h(target)
            if r.status != "feasible":
                continue
            val = (
                _bneck_cfg(target, r.placement)
                if cfg.objective == "throughput"
                else _sim(target, r.placement, cost).makespan
            )
            ub = val if ub is None else min(ub, val)
        res = solve_placement(
            target,
            cost,
            time_limit=cfg.time_limit,
            mip_rel_gap=cfg.mip_rel_gap,
            congestion=cfg.congestion,
            upper_bound=ub,
            objective=cfg.objective,
            serving_slots=slots,
            prompt_len=prompt,
            prefill_chunk=cfg.prefill_chunk,
            graph_seq_len=graph_seq_len,
            fused_prefill=bool(getattr(cfg, "fused_prefill", True)),
        )
        if member_to_super is not None and res.placement:
            coarse_placement = lift_placement(member_to_super, res.placement)
            res.extra["hierarchical"] = True
            res.extra["supernodes"] = len(target)
        else:
            coarse_placement = res.placement

        # envelope on the UNCONTRACTED work graph: under a bounded solver
        # budget (and through lossy contraction) the MILP route may not beat
        # a plain list schedule — Moirai returns whichever placement SCORES
        # best under the configured objective (makespan for "latency",
        # bottleneck-stage time for "throughput"), so Moirai ≥ best
        # heuristic always holds (with unbounded budget the exact MILP alone
        # is makespan-optimal, as in the paper)
        sc_milp = (
            _score(work, coarse_placement)
            if coarse_placement
            else float("inf")
        )
        best_h, sc_h = None, float("inf")
        for h in heuristic_pool:
            r = h(work)
            if r.status != "feasible":
                continue
            sc = _score(work, r.placement)
            if sc < sc_h:
                best_h, sc_h = r, sc
        if best_h is not None and sc_h < sc_milp:
            best_h.method = f"moirai[envelope={best_h.method}]"
            best_h.extra["milp_score"] = sc_milp
            best_h.extra["envelope_score"] = sc_h
            res = best_h
            coarse_placement = res.placement
        else:
            res.extra["envelope_score"] = sc_milp
            res.extra["heuristic_best"] = sc_h
    elif cfg.method == "etf":
        res = etf(work, cost, serving_slots=slots)
        coarse_placement = res.placement
    elif cfg.method == "getf":
        res = getf(work, cost, objective=cfg.objective, serving_slots=slots)
        coarse_placement = res.placement
    elif cfg.method == "msct":
        res = msct(work, cost, serving_slots=slots)
        coarse_placement = res.placement
    elif cfg.method == "bottleneck_balance":
        res = bottleneck_balance(work, cost, serving_slots=slots)
        coarse_placement = res.placement
    elif cfg.method == "placeto":
        from .placeto import placeto  # lazy: pulls in torch

        res = placeto(
            work,
            cost,
            iters=cfg.placeto_iters,
            seed=cfg.seed,
            objective=cfg.objective,
            serving_slots=slots,
            device=cfg.placeto_device,
        )
        coarse_placement = res.placement
    elif cfg.method == "round_robin":
        res = round_robin(work, cost, serving_slots=slots)
        coarse_placement = res.placement
    elif cfg.method == "single":
        res = single_device(work, cost, serving_slots=slots)
        coarse_placement = res.placement
    else:
        raise ValueError(f"unknown placement method {cfg.method!r}")

    # ------------------------------------------------- lift to original ids
    # the solve and every heuristic came back without a placement that fits
    # (the reference fails here with a bare ``KeyError``)
    unplaced = [cid for cid in members if cid not in coarse_placement]
    if unplaced:
        raise NoFeasiblePlacement(
            f"no placement of {len(work)} nodes fits {cluster.name!r} "
            f"({len(unplaced)} unplaced; {res.method}: {res.status})"
        )
    placement = {
        orig: coarse_placement[cid]
        for cid, origs in members.items()
        for orig in origs
    }
    res.placement = placement
    res.solve_time = _time.perf_counter() - t0
    res.extra["coarsened"] = cfg.coarsen
    res.extra["objective"] = cfg.objective
    res.extra["serving_slots"] = slots
    res.extra["prompt_len"] = prompt
    res.extra["n_original"] = len(graph)
    res.extra["n_coarse"] = len(work)
    return res


def replan(
    graph: OpGraph,
    cluster: ClusterSpec,
    failed_device=(),
    config: Optional[PlanConfig] = None,
    *,
    derate: Optional[Mapping[int, float]] = None,
    link_derate: Optional[Mapping[tuple, float]] = None,
) -> PlacementResult:
    """Elastic re-placement: hard device failures, soft derates, or both.

    Args:
        graph: the computation graph to (re-)place.
        cluster: the ORIGINAL cluster spec — never mutated.
        failed_device: one failed device index (int), an iterable of
            accumulated failures, or empty (the default) for a derate-only
            replan. Failed devices are removed from the planning cluster.
        config: planning knobs (objective, method, slots — see
            :class:`PlanConfig`); the replan runs under the SAME configured
            objective as the original plan.
        derate: optional map of device index → observed speed factor
            (1.0 = nominal, 0.5 = running at half speed). The plan is
            computed on ``cluster.with_derate(derate)`` — the cluster as it
            is actually behaving — closing the serving engine's
            observe → derate → replan loop. Indices are ORIGINAL cluster
            indices; derates for failed devices are ignored.
        link_derate: optional map of ``(src, dst)`` device pair → bandwidth
            factor of that direct link (0.125 = an 8×-degraded NIC, 0.0 =
            partitioned).  Threaded into ``cluster.with_derate(links=...)``
            so the cost model — and through it the MILP's comm prices, every
            heuristic, and candidate scoring — sees the degraded channel and
            routes tensor flows AROUND it instead of derating both endpoint
            devices.  Pairs touching failed devices are dropped.

    Returns:
        A :class:`PlacementResult` whose placement maps node ids to
        SURVIVING device indices of the *original* cluster (so the executor
        can keep its device handles). ``extra`` records
        ``failed_devices`` and, when given, the applied ``derate`` /
        ``link_derate`` maps.
    """
    failed = (
        [failed_device]
        if isinstance(failed_device, int)
        else sorted(set(failed_device))
    )
    if not all(0 <= i < cluster.k for i in failed):
        raise ValueError(f"failed devices {failed} out of range for k={cluster.k}")
    surviving = [i for i in range(cluster.k) if i not in failed]
    if not surviving:
        raise NoSurvivingDevices("no surviving devices to re-plan on")
    derate = {
        i: float(f)
        for i, f in (derate or {}).items()
        if i not in failed and float(f) != 1.0
    }
    link_derate = {
        (int(a), int(b)): float(f)
        for (a, b), f in (link_derate or {}).items()
        if a not in failed and b not in failed and float(f) != 1.0
    }
    # plan on the cluster as observed: derated speeds and links, minus failed
    # devices (remove in descending index order so earlier indices stay
    # stable — with_derate runs first, while link pairs are still original)
    sub = (
        cluster.with_derate(derate, links=link_derate)
        if derate or link_derate
        else cluster
    )
    for i in sorted(failed, reverse=True):
        sub = sub.without_device(i)
    res = plan(graph, sub, config)
    res.placement = {nid: surviving[k] for nid, k in res.placement.items()}
    res.extra["failed_devices"] = failed
    if derate:
        res.extra["derate"] = dict(derate)
    if link_derate:
        res.extra["link_derate"] = {f"{a}-{b}": f for (a, b), f in link_derate.items()}
    if len(failed) == 1:
        res.extra["failed_device"] = failed[0]
    return res


METHODS = (
    "moirai",
    "etf",
    "getf",
    "msct",
    "bottleneck_balance",
    "placeto",
    "round_robin",
    "single",
)


# service-level replica partitioning rides on plan(): imported last because
# core.replica itself imports PlanConfig/plan from this module
from .replica import ReplicaSpec, ServicePlan, plan_replicas  # noqa: E402,F401
