"""Moirai's MILP device-placement model (paper §III-D, Eq. 4–8).

Faithful construction of the paper's model over the augmented DAG Ḡ:

  min  T                      (= max_i C_i, the makespan / end-to-end latency)
  s.t. (4a) C_i ≤ S_j                       ∀ edges of Ḡ (transitively closed)
       (4b) C_i = S_i + Σ_k p_ik x_ik       ∀ ops
       (4c) Σ_k x_ik = 1                    ∀ ops
       (5)  Σ_i m_i x_ik ≤ Mem_k            ∀ devices           [memory]
       (6)  big-M disjunctive non-overlap   ∀ op pairs w/o precedence, ∀k
       (7)  z_q / u_{qk'k''} channel selection + C_q coupling    [comm]
       (8)  big-M congestion control        ∀ comm pairs w/o precedence, ∀k

Throughput-native mode (``objective="throughput"``)
---------------------------------------------------
The paper's T is a single query's end-to-end latency.  A saturated serving
pipeline instead completes one request per *bottleneck interval* — the busy
time of the most loaded resource (``core.simulate.bottleneck_time``).  In
throughput mode the objective is replaced by per-resource busy-time
accumulators:

  min  T
  s.t. T ≥ Σ_i p_ik x_ik                    ∀ devices k          [busy(dev)]
       T ≥ Σ_q p^comm_{q,k',k''} u_{qk'k''} ∀ channels (k',k'')  [busy(chan)]

while every scheduling family (4/6/7/8) is kept as a *feasibility* check —
the solution must still admit a valid one-query schedule within the horizon,
but the makespan is no longer what is minimized.  The two objectives diverge
whenever latency-optimal packing (everything on the fastest device to avoid
hops) serializes requests on that device: throughput mode accepts longer
single-query critical paths in exchange for balanced per-resource busy time,
which is exactly the pipelined-partitioning objective (Tarnawski et al.).

Eq. 5 is extended with a per-slot KV-cache resident cost in BOTH modes:
``m_i = param_bytes_i + serving_slots × kv_bytes_i`` — each concurrently
served request keeps its own KV cache resident on the device hosting the op,
so memory-tight placements that fit one query can be infeasible under
``serving_slots > 1`` (the slot-unaware model wrongly admits them).

Solved with HiGHS branch-and-cut via ``scipy.optimize.milp`` (Gurobi is not
available offline — see DESIGN.md §7).  Times are internally rescaled so the
schedule horizon is O(1e3), keeping the big-M coefficients well-conditioned.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp

from .costmodel import CostModel
from .graph import AugmentedDAG, OpGraph, augment


@dataclass
class PlacementResult:
    """Outcome of any planner (MILP or heuristic): the placement itself
    (op id → device index), the objective value in the configured
    objective's units (makespan seconds for "latency", bottleneck busy-time
    seconds for "throughput"), solver status/gap/time, the producing
    ``method`` name, the solver's schedule (``start_times``/``end_times``,
    per-flow ``channels``) when available, and an ``extra`` dict of
    method-specific annotations (objective, serving_slots, derate map,
    failed devices, envelope scores…)."""

    placement: Dict[int, int]            # op id -> device
    objective: float                     # solver objective (seconds): makespan
                                         # in latency mode, bottleneck busy
                                         # time in throughput mode
    status: str                          # "optimal" | "feasible" | "infeasible" | "timeout"
    mip_gap: float
    solve_time: float
    method: str = "moirai-milp"
    start_times: Dict[int, float] = field(default_factory=dict)
    end_times: Dict[int, float] = field(default_factory=dict)
    channels: Dict[int, Tuple[int, int]] = field(default_factory=dict)  # comm id -> (k', k'')
    extra: dict = field(default_factory=dict)


class _Builder:
    """Row-wise sparse constraint accumulator for scipy.optimize.milp."""

    def __init__(self, nvars: int):
        self.nvars = nvars
        self.rows: List[int] = []
        self.cols: List[int] = []
        self.vals: List[float] = []
        self.lb: List[float] = []
        self.ub: List[float] = []
        self._r = 0

    def add(self, coeffs: Mapping[int, float], lb: float, ub: float):
        for c, v in coeffs.items():
            if v != 0.0:
                self.rows.append(self._r)
                self.cols.append(c)
                self.vals.append(v)
        self.lb.append(lb)
        self.ub.append(ub)
        self._r += 1

    def constraint(self) -> LinearConstraint:
        a = sp.csr_matrix(
            (self.vals, (self.rows, self.cols)), shape=(self._r, self.nvars)
        )
        return LinearConstraint(a, np.array(self.lb), np.array(self.ub))


def solve_placement(
    graph: OpGraph,
    cost: CostModel,
    *,
    time_limit: float = 120.0,
    mip_rel_gap: float = 1e-3,
    congestion: bool = True,
    aug: Optional[AugmentedDAG] = None,
    upper_bound: Optional[float] = None,
    congestion_min_frac: float = 0.005,
    objective: str = "latency",
    serving_slots: int = 1,
    prompt_len: float = 0.0,
    prefill_chunk: Optional[int] = None,
    graph_seq_len: Optional[int] = None,
    fused_prefill: bool = False,
    horizon: Optional[float] = None,
    tighten_horizon: bool = True,
    verbose: bool = False,
) -> PlacementResult:
    """Solve the Moirai MILP for ``graph`` on ``cost.cluster``.

    ``objective``: ``"latency"`` minimizes the makespan (paper Eqs. 4–8);
    ``"throughput"`` minimizes the max per-resource busy time (the
    steady-state bottleneck interval — see module docstring).

    ``serving_slots``: Eq. 5 charges each op ``param_bytes + serving_slots ×
    kv_bytes`` resident memory (one KV-cache copy per concurrent request).

    ``prompt_len > 0`` (throughput mode): each request's chunked-prefill
    work — ceil(prompt_len / prefill_chunk) passes of every op at its
    chunk's token count (relative to ``graph_seq_len``, default
    ``graph.seq_len``) — is added to the per-device and per-channel
    busy-time accumulators, so the solver balances the work the serving
    engine actually runs (prefill + decode), not decode alone.  The Eq.
    4/6/7/8 feasibility families stay on the single decode pass (prefill
    passes reuse the same placement; they add busy time, not new
    scheduling variables).  ``fused_prefill`` accumulates that prefill work
    at the fused mixed-batch marginal rate (the engine packs chunks into
    the live decode batch — no second weight stream or launch; see
    ``simulate.fused_prefill_compute_time``); comm accumulators are
    unchanged.

    ``upper_bound`` (seconds): a known-feasible value of the *configured
    objective* (e.g. from a heuristic schedule, which satisfies every MILP
    constraint family — see simulate.validate_schedule).  It is used as
    ``T ≤ UB``; in latency mode it also caps the big-M horizon, which shrinks
    every disjunctive constraint's relaxation — an optimality-preserving
    beyond-paper speedup over the paper's sum-of-all-costs big-Ms.  In
    throughput mode a bottleneck UB does not bound the makespan directly,
    but (``tighten_horizon``) it bounds every RESOURCE's busy time: any
    placement with bottleneck ≤ UB admits a list schedule no longer than the
    sum of per-resource busy times — some resource is always running — so

        H ≤ Σ_k min(UB, Σ_i p_ik) + Σ_{(k',k'')} min(UB, Σ_q p^comm_{q,k',k''})

    is a valid **per-device / per-channel** horizon.  Each channel's term is
    capped at UB individually (a single slow channel no longer inflates
    every big-M the way the per-flow worst-channel sum did), which is where
    the solve-time win comes from on heterogeneous-link clusters — measured
    in ``benchmarks/milp_throughput.py``.  ``horizon`` (a feasible makespan
    in seconds) can still be passed explicitly and composes via min.

    ``congestion_min_frac``: congestion (Eq. 8) pairs are built only for
    flows whose worst-channel transfer time exceeds this fraction of the
    horizon; sub-microsecond flows cannot shift the makespan but would add
    O(β²·K) rows.
    """
    if objective not in ("latency", "throughput"):
        raise ValueError(f"unknown objective {objective!r}")
    t0 = _time.perf_counter()
    K = cost.cluster.k
    aug = aug or augment(graph)
    ops = sorted(graph.nodes.keys())
    comms = sorted(aug.comm.keys())
    nops, ncomm = len(ops), len(comms)
    op_pos = {o: i for i, o in enumerate(ops)}
    cm_pos = {q: i for i, q in enumerate(comms)}

    # ---------------------------------------------------------------- costs
    p = {o: np.array([cost.compute_time(graph.nodes[o], k) for k in range(K)]) for o in ops}
    pcomm = {q: cost.comm_matrix(aug.comm[q].bytes) for q in comms}

    # per-request prefill work added to the throughput busy accumulators:
    # Σ over chunks of each op at the chunk's token count (same device),
    # and of each flow's chunk-scaled payload (same channel)
    p_pre = {o: np.zeros(K) for o in ops}
    pcomm_pre = {q: np.zeros((K, K)) for q in comms}
    if objective == "throughput" and prompt_len and prompt_len > 0:
        from .simulate import (
            fused_prefill_compute_time,
            prefill_chunk_sizes,
            prefill_compute_time,
            resolve_graph_seq_len,
            scale_edge_bytes,
        )

        pct = fused_prefill_compute_time if fused_prefill else prefill_compute_time
        s_graph = resolve_graph_seq_len(graph, graph_seq_len)
        # chunks are costed as (size, KV-context) pairs — chunk i attends
        # over every prior chunk's cache plus itself — matching
        # simulate.prefill_busy's iteration exactly (objective parity)
        counts: Dict[Tuple[int, int], int] = {}
        run = 0
        for toks in prefill_chunk_sizes(int(prompt_len), prefill_chunk):
            run += toks
            counts[(toks, run)] = counts.get((toks, run), 0) + 1
        for (toks, ctx), n in counts.items():
            for o in ops:
                p_pre[o] = p_pre[o] + n * np.array([
                    pct(cost, graph.nodes[o], k, toks, s_graph, ctx)
                    for k in range(K)
                ])
            frac = float(toks) / float(s_graph)
            cfrac = float(ctx) / float(s_graph)
            for q in comms:
                c = aug.comm[q]
                payload = scale_edge_bytes(graph.nodes[c.src], c.bytes, frac, cfrac)
                pcomm_pre[q] = pcomm_pre[q] + n * cost.comm_matrix(payload)

    # schedule horizon (valid big-M): a feasible UB if given, else every task
    # once at its worst cost
    H_dev_loose = sum(float(v.max()) for v in p.values())
    H_comm_loose = sum(float(np.max(m)) if m.size else 0.0 for m in pcomm.values())
    H_raw = H_dev_loose + H_comm_loose
    # congestion-pair significance is anchored to the STRUCTURAL bound, not
    # the (possibly UB-tightened) horizon: a tighter horizon should shrink
    # the big-M relaxations, never inflate the Eq. 8 pair set / model size
    H_struct = max(H_raw, 1e-9)
    # 20% slack on caller-supplied bounds: T ≤ 1.2·UB still prunes the tree
    # hard, but leaves the solver's feasibility heuristics room to land a
    # first incumbent (scipy's milp cannot take a MIP start)
    if horizon is not None:
        H_raw = min(H_raw, horizon * 1.2)
    if upper_bound is not None and objective == "latency":
        # a makespan UB is also a valid schedule horizon; a bottleneck UB
        # (throughput mode) only bounds T directly — but see below
        H_raw = min(H_raw, upper_bound * 1.2)
    if upper_bound is not None and objective == "throughput" and tighten_horizon:
        # per-channel big-M tightening: T ≤ UB caps EVERY resource's busy
        # time, and a list schedule's makespan is at most the sum of busy
        # times over all resources (at any instant before completion some
        # resource is running).  Each device can contribute at most
        # min(UB', Σ_i p_ik) and each directed channel at most
        # min(UB', Σ_q pcomm[q][a,b]) — so one slow device (or channel) is
        # capped at UB' instead of dragging the whole-schedule horizon with
        # its worst-case per-task term.  Each part composes with its loose
        # counterpart by min (a flow runs on exactly ONE channel, so the
        # per-flow worst-channel sum stays valid too), making the tightened
        # horizon never worse than the legacy bound.  UB' carries the same
        # 20% slack as T's own bound so every incumbent the solver may
        # explore still admits a schedule inside the horizon.
        ub_s = upper_bound * 1.2
        dev_caps = sum(
            min(ub_s, float(sum(p[o][k] for o in ops))) for k in range(K)
        )
        chan_caps = 0.0
        for a in range(K):
            for bb in range(K):
                if a == bb:
                    continue
                tot = float(sum(pcomm[q][a, bb] for q in comms if pcomm[q].size))
                chan_caps += min(ub_s, tot)
        H_raw = min(
            H_raw,
            min(H_dev_loose, dev_caps) + min(H_comm_loose, chan_caps),
        )
    H_raw = max(H_raw, 1e-9)
    scale = 1e3 / H_raw  # rescale seconds so horizon ≈ 1e3
    for o in ops:
        p[o] = p[o] * scale
        p_pre[o] = p_pre[o] * scale
    for q in comms:
        pcomm[q] = pcomm[q] * scale
        pcomm_pre[q] = pcomm_pre[q] * scale
    H = 1e3
    Ms = Ml = Mr = H  # the paper's M^s, M^l, M^r
    # busy time incl. prefill may exceed the (schedule) horizon H — T's own
    # upper bound must leave room for the prefill share
    H_pre = sum(float(v.max()) for v in p_pre.values()) + sum(
        float(np.max(m)) if m.size else 0.0 for m in pcomm_pre.values()
    )

    # ------------------------------------------------------------ variables
    # layout: [x (nops*K)] [S (nops+ncomm)] [C (nops+ncomm)] [z (ncomm)]
    #         [u (ncomm*K*K off-diag)] [δ_ops] [δ_comm] [T]
    off_x = 0
    off_S = off_x + nops * K
    off_C = off_S + nops + ncomm
    off_z = off_C + nops + ncomm
    chan_pairs = [(a, b) for a in range(K) for b in range(K) if a != b]
    nchan = len(chan_pairs)
    chan_pos = {ab: i for i, ab in enumerate(chan_pairs)}
    off_u = off_z + ncomm

    succ = graph.successors_closure()
    op_pairs = [
        (i, j)
        for ii, i in enumerate(ops)
        for j in ops[ii + 1 :]
        if j not in succ[i] and i not in succ[j]
    ]
    aug_succ = aug.succ_closure()
    if congestion:
        sig_thr = congestion_min_frac * H_struct * scale
        sig = {
            q
            for q in comms
            if pcomm[q].size and float(np.max(pcomm[q])) >= sig_thr
        }
        sig_list = sorted(sig)
        comm_pairs = [
            (q, r)
            for qi, q in enumerate(sig_list)
            for r in sig_list[qi + 1 :]
            if r not in aug_succ[q] and q not in aug_succ[r]
        ]
    else:
        comm_pairs = []
    off_d_ops = off_u + ncomm * nchan
    off_d_comm = off_d_ops + len(op_pairs)
    off_T = off_d_comm + len(comm_pairs)
    nvars = off_T + 1

    def xv(o, k):
        return off_x + op_pos[o] * K + k

    def Sv(i):
        return off_S + (op_pos[i] if i in op_pos else nops + cm_pos[i])

    def Cv(i):
        return off_C + (op_pos[i] if i in op_pos else nops + cm_pos[i])

    def zv(q):
        return off_z + cm_pos[q]

    def uv(q, a, b):
        return off_u + cm_pos[q] * nchan + chan_pos[(a, b)]

    b = _Builder(nvars)

    # -------------------------------------------------- (4a) precedence (Ḡ)
    for (i, j), q in aug.edge_to_comm.items():
        b.add({Cv(i): 1.0, Sv(q): -1.0}, -np.inf, 0.0)  # C_i ≤ S_q
        b.add({Cv(q): 1.0, Sv(j): -1.0}, -np.inf, 0.0)  # C_q ≤ S_j

    # ------------------------------------------- (4b) op completion coupling
    for o in ops:
        coeffs = {Cv(o): 1.0, Sv(o): -1.0}
        for k in range(K):
            coeffs[xv(o, k)] = -p[o][k]
        b.add(coeffs, 0.0, 0.0)

    # -------------------------------------------------- (4c) exactly one dev
    for o in ops:
        b.add({xv(o, k): 1.0 for k in range(K)}, 1.0, 1.0)

    # ------------------------------------------------------------ (5) memory
    # KV-aware resident cost: weights + one KV-cache copy per serving slot
    m_res = {o: cost.resident_bytes(graph.nodes[o], serving_slots) for o in ops}
    for k in range(K):
        coeffs = {xv(o, k): m_res[o] for o in ops if m_res[o]}
        if coeffs:
            b.add(coeffs, -np.inf, cost.cluster.devices[k].mem_bytes)

    # ---------------------------------------------------- (6) non-overlap
    for pi, (i, j) in enumerate(op_pairs):
        d = off_d_ops + pi
        for k in range(K):
            # S_i ≥ C_j − Ms·δ − Ml·(2 − x_ik − x_jk)
            b.add(
                {Sv(i): 1.0, Cv(j): -1.0, d: Ms, xv(i, k): -Ml, xv(j, k): -Ml},
                -2.0 * Ml,
                np.inf,
            )
            # S_j ≥ C_i − Ms·(1−δ) − Ml·(2 − x_ik − x_jk)
            b.add(
                {Sv(j): 1.0, Cv(i): -1.0, d: -Ms, xv(i, k): -Ml, xv(j, k): -Ml},
                -Ms - 2.0 * Ml,
                np.inf,
            )

    # --------------------------------------------------- (7) communication
    for q in comms:
        c = aug.comm[q]
        i, j = c.src, c.dst
        for k in range(K):
            # z_q ≤ 2 − x_ik − x_jk
            b.add({zv(q): 1.0, xv(i, k): 1.0, xv(j, k): 1.0}, -np.inf, 2.0)
            # z_q ≥ x_ik − x_jk ; z_q ≥ x_jk − x_ik
            b.add({zv(q): 1.0, xv(i, k): -1.0, xv(j, k): 1.0}, 0.0, np.inf)
            b.add({zv(q): 1.0, xv(j, k): -1.0, xv(i, k): 1.0}, 0.0, np.inf)
        # Σ u = z_q
        coeffs = {uv(q, a, bb): 1.0 for (a, bb) in chan_pairs}
        coeffs[zv(q)] = -1.0
        b.add(coeffs, 0.0, 0.0)
        # u_{qk'k''} ≥ x_ik' + x_jk'' − 1  (k' ≠ k'')
        for (a, bb) in chan_pairs:
            b.add(
                {uv(q, a, bb): 1.0, xv(i, a): -1.0, xv(j, bb): -1.0},
                -1.0,
                np.inf,
            )
        # C_q = S_q + Σ u·p_comm
        coeffs = {Cv(q): 1.0, Sv(q): -1.0}
        for (a, bb) in chan_pairs:
            coeffs[uv(q, a, bb)] = -float(pcomm[q][a, bb])
        b.add(coeffs, 0.0, 0.0)

    # ---------------------------------------------------- (8) congestion
    for pi, (q, r) in enumerate(comm_pairs):
        d = off_d_comm + pi
        ca, cb = aug.comm[q], aug.comm[r]
        a_, b_ = ca.src, ca.dst
        c_, d_ = cb.src, cb.dst
        for k in range(K):
            # accumulate (flows may share endpoint ops, e.g. two fan-out
            # edges of one producer: the ±Mr terms must sum, not overwrite)
            src_term: Dict[int, float] = {}
            dst_term: Dict[int, float] = {}
            for col, val in ((xv(a_, k), Mr), (xv(c_, k), Mr), (xv(b_, k), -Mr), (xv(d_, k), -Mr)):
                src_term[col] = src_term.get(col, 0.0) + val
                dst_term[col] = dst_term.get(col, 0.0) - val
            # S_q ≥ C_r − Ms·δ − Ml(2−z_q−z_r) + Mr(x_ak+x_ck−x_bk−x_dk−2)
            coeffs = {Sv(q): 1.0, Cv(r): -1.0, d: Ms, zv(q): -Ml, zv(r): -Ml}
            for col, val in src_term.items():
                coeffs[col] = coeffs.get(col, 0.0) - val
            b.add(coeffs, -2.0 * Ml - 2.0 * Mr, np.inf)
            # S_r ≥ C_q − Ms(1−δ) − Ml(2−z_q−z_r) + Mr(src_term−2)
            coeffs = {Sv(r): 1.0, Cv(q): -1.0, d: -Ms, zv(q): -Ml, zv(r): -Ml}
            for col, val in src_term.items():
                coeffs[col] = coeffs.get(col, 0.0) - val
            b.add(coeffs, -Ms - 2.0 * Ml - 2.0 * Mr, np.inf)
            # destination-side versions
            coeffs = {Sv(q): 1.0, Cv(r): -1.0, d: Ms, zv(q): -Ml, zv(r): -Ml}
            for col, val in dst_term.items():
                coeffs[col] = coeffs.get(col, 0.0) - val
            b.add(coeffs, -2.0 * Ml - 2.0 * Mr, np.inf)
            coeffs = {Sv(r): 1.0, Cv(q): -1.0, d: -Ms, zv(q): -Ml, zv(r): -Ml}
            for col, val in dst_term.items():
                coeffs[col] = coeffs.get(col, 0.0) - val
            b.add(coeffs, -Ms - 2.0 * Ml - 2.0 * Mr, np.inf)

    # ----------------------------------------------------------- objective T
    if objective == "latency":
        # T is the makespan: T ≥ C_sink
        for o in graph.sinks():
            b.add({off_T: 1.0, Cv(o): -1.0}, 0.0, np.inf)
    else:
        # T is the steady-state bottleneck interval: per-resource busy-time
        # accumulators.  Device k's per-request busy time is Σ_i p_ik x_ik;
        # channel (a,b)'s is Σ_q p^comm_{q,a,b} u_{q,a,b} (u is pinned to the
        # actual endpoint devices by the Eq. 7 lower bounds, so the busy sum
        # cannot be understated by relaxing u).
        # busy time includes the per-request prefill work (chunk passes run
        # on the SAME device/channel the op's decode pass is placed on).
        # Speculative joint graphs scale each op's DECODE term by its
        # meta["pass_rate"] (forwards per committed token: target 1/E,
        # draft k/E) — prefill terms stay unscaled, both models prefill the
        # prompt once per request.  Mirrors simulate.bottleneck_time exactly
        # (the pinned two-graph busy-time parity).
        rate = {
            o: float(graph.nodes[o].meta.get("pass_rate", 1.0)) for o in ops
        }
        for k in range(K):
            coeffs = {off_T: 1.0}
            for o in ops:
                tk = float(p[o][k]) * rate[o] + float(p_pre[o][k])
                if tk:
                    coeffs[xv(o, k)] = -tk
            b.add(coeffs, 0.0, np.inf)
        for (a, bb) in chan_pairs:
            coeffs = {off_T: 1.0}
            for q in comms:
                t = (
                    float(pcomm[q][a, bb]) * rate[aug.comm[q].src]
                    if pcomm[q].size else 0.0
                )
                t += float(pcomm_pre[q][a, bb]) if pcomm_pre[q].size else 0.0
                if t:
                    coeffs[uv(q, a, bb)] = -t
            if len(coeffs) > 1:
                b.add(coeffs, 0.0, np.inf)

    # --------------------------------------------------------- var bounds
    lb = np.zeros(nvars)
    ub = np.ones(nvars)
    ub[off_S : off_z] = H          # S and C ranges
    ub[off_T] = H + H_pre
    if upper_bound is not None and objective == "throughput":
        # bottleneck UB bounds T directly (same 20% incumbent slack as above)
        ub[off_T] = min(H + H_pre, upper_bound * scale * 1.2)
    integrality = np.zeros(nvars)
    integrality[off_x : off_x + nops * K] = 1
    integrality[off_z : off_z + ncomm] = 1
    integrality[off_u : off_u + ncomm * nchan] = 1
    integrality[off_d_ops : off_T] = 1

    c = np.zeros(nvars)
    c[off_T] = 1.0

    res = milp(
        c=c,
        constraints=b.constraint(),
        integrality=integrality,
        bounds=Bounds(lb, ub),
        options={
            "time_limit": time_limit,
            "mip_rel_gap": mip_rel_gap,
            "disp": verbose,
        },
    )
    solve_time = _time.perf_counter() - t0

    if res.x is None:
        return PlacementResult(
            placement={},
            objective=float("inf"),
            status="infeasible" if res.status == 2 else "timeout",
            mip_gap=float("inf"),
            solve_time=solve_time,
            extra={
                "scipy_status": int(res.status),
                "message": str(res.message),
                "milp_objective": objective,
                "serving_slots": serving_slots,
                "prompt_len": float(prompt_len),
                "horizon_s": H_raw,
            },
        )

    x = res.x
    placement = {}
    for o in ops:
        ks = [x[xv(o, k)] for k in range(K)]
        placement[o] = int(np.argmax(ks))
    starts = {i: float(x[Sv(i)]) / scale for i in ops + comms}
    ends = {i: float(x[Cv(i)]) / scale for i in ops + comms}
    channels = {}
    for q in comms:
        if x[zv(q)] > 0.5:
            for (a, bb) in chan_pairs:
                if x[uv(q, a, bb)] > 0.5:
                    channels[q] = (a, bb)
                    break
    gap = float(res.mip_gap) if getattr(res, "mip_gap", None) is not None else 0.0
    status = "optimal" if res.status == 0 and gap <= mip_rel_gap * 1.01 else "feasible"
    return PlacementResult(
        placement=placement,
        objective=float(x[off_T]) / scale,
        status=status,
        mip_gap=gap,
        solve_time=solve_time,
        start_times=starts,
        end_times=ends,
        channels=channels,
        extra={
            "nvars": nvars,
            "nrows": len(b.lb),
            "n_op_pairs": len(op_pairs),
            "n_comm_pairs": len(comm_pairs),
            "milp_objective": objective,
            "serving_slots": serving_slots,
            "prompt_len": float(prompt_len),
            "horizon_s": H_raw,
        },
    )
