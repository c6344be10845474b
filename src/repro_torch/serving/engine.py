"""Serving engine: ragged continuous batching over the Moirai stage executor.

* fixed decode slots (classic continuous batching: a finished sequence frees
  its slot for the next queued request; prefill happens into the slot),
* **ragged batches** (default): every slot carries its own cache position —
  the decode batch hands the executor a ``(slots,)`` ``cache_pos`` vector, so
  each row writes KV at its own depth and masks over its own valid length.
  Admission is therefore *continuous*: any free slot is filled immediately,
  regardless of the other slots' depths (mixed prompt lengths, hot-swap
  re-queues mid-generation — no cohort waves).  ``batching="lockstep"``
  keeps the seed engine's shared-``cache_pos`` behavior, where admission
  must hold a request until every active slot sits at exactly its resume
  depth — retained as the benchmark baseline
  (``benchmarks/ragged_batching.py``),
* Moirai placement computed once at startup from the layer-level OpGraph and
  the cluster spec (and re-computed by ``on_device_failure`` — elastic).
  With more than one decode slot the engine serves a *pipeline* of requests,
  so the default planning objective switches from single-query makespan to
  bottleneck-stage time (``PlanConfig.objective="throughput"``) — the
  steady-state completion interval of the pipelined schedule,
* per-stage latency tracking feeds the straggler monitor: observed stage
  times are compared against the cost-model *predictions* for the planned
  placement; a stage running ``straggler_factor``× slower than its
  prediction (normalized by the leave-one-out median of the other stages'
  observed/predicted ratios, so absolute cost-model error cancels) is
  flagged,
* **closed adaptation loop** (observe → derate → replan): every
  ``AdaptationConfig.window_steps`` decode steps (or on an explicit
  :meth:`ServingEngine.observe_window` call) the engine converts the
  window's stage ratios into per-device speed evidence
  (:class:`~repro_torch.core.costmodel.DerateCalibrator`), feeds the
  :class:`~repro_torch.serving.adaptation.DeratePolicy`, and — when the policy's
  streak/hysteresis machinery commits a change — clones the cluster with
  the observed speeds (``ClusterSpec.with_derate``), re-plans under the
  configured objective (latency or throughput, KV-aware Eq. 5 intact) via
  ``replan(..., derate=...)``, and hot-swaps the stage executor.  In-flight
  requests are re-queued with their generated tokens intact (greedy decode
  resumes exactly after re-prefill of prompt+output).  Every decision lands
  in :attr:`ServingEngine.adaptation_events`; every committed swap in
  :attr:`ServingEngine.replan_history`,
* **KV-aware admission**: a request is only admitted when the KV-cache
  residency of ``active+1`` concurrent sequences still fits every planned
  device (runtime Eq. 5) — plan-time ``serving_slots`` sizing is necessary
  but not sufficient after failures/derates shrink the effective cluster,
* **chunked prefill interleaved with ragged decode** (default in ragged
  mode): an admitted request's prompt is consumed ``prefill_chunk`` tokens
  at a time — each chunk is one batch-1 forward into that slot's cache row
  at its ``cache_pos``, run BETWEEN batched decode steps (at most one chunk
  per engine step, round-robin over mid-prefill slots), so a single long
  prompt can no longer head-of-line-block decode on every active slot the
  way the inline whole-prompt prefill did.  ``prefill_chunk=None`` restores
  the blocking whole-prompt prefill (and lockstep batching always uses it —
  the seed baseline).  Re-queued hot-swap requests re-prefill
  prompt+generated through the same chunked state machine.  Prefill
  forwards are tagged so observation windows feed the derate calibrator
  decode samples only — a burst of long prompts must not read as device
  drift,
* **fused mixed prefill/decode steps** (default when chunking is on): the
  pending prefill chunks are packed INTO the batched ragged decode forward
  as rows of the same ``[slots, S]`` batch — per-row ``(cache_pos, q_len)``
  gives decode rows ``q_len=1``, prefill rows ``q_len=chunk``, idle rows
  ``q_len=0``; every row writes KV / advances SSM state over exactly its
  valid span at its own depth.  ONE compiled program serves the whole step
  (S = ``prefill_chunk`` when any prefill is pending, else 1 — two compiled
  shapes total), every mid-prefill slot advances every step (no round-robin
  serialization), and the per-slot cache rows are written in place (the
  legacy interleaved path's O(max_len/chunk) full-row gather/scatter per
  chunk is gone).  Each fused forward's wall time is split into decode and
  prefill shares by the cost model's predicted per-stage fractions before
  it is recorded, so observation-window hygiene is preserved.
  ``fused=False`` restores the earlier interleaved path (one batch-1 chunk
  between decode steps),
* **not yet ported** (ROADMAP A0 and A7): paged KV (``kv_page_tokens``) and
  speculative draft/target serving (``draft_cfg``) raise
  ``NotImplementedError``.

The port runs on ``torch`` devices (default: every visible CUDA card) and
keeps the reference's host-side logic — planning, admission, adaptation,
replan on failure — line for line.
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import cuda_devices
from repro_torch.core.costmodel import CostModel, DerateCalibrator
from repro_torch.core.devices import ClusterSpec
from repro_torch.core.modelgraph import transformer_graph
from repro_torch.core.milp import PlacementResult
from repro_torch.core.placement import PlanConfig, plan, replan
from .adaptation import AdaptationConfig, AdaptationEvent, DeratePolicy
from .stage_executor import StageExecutor, stages_from_placement, stats_from_times


@dataclass
class Request:
    """One generation request.

    ``prompt`` is the token list to prefill; generation appends to
    ``out_tokens`` until ``max_new_tokens``, EOS, or the engine's
    ``max_len``.  ``done`` flips when the request reaches ANY terminal
    state; ``rejected`` additionally flips (with ``out_tokens`` left
    empty) when KV-aware admission (``admission="reject"``) or oversize
    validation (``oversize="reject"``) turned the request away — check it
    before reading ``out_tokens``.  ``truncated`` flips when
    ``oversize="truncate"`` had to drop the prompt's oldest tokens to fit
    ``prompt + max_new_tokens`` inside the engine's cache capacity.

    ``state`` is the TYPED terminal state every submission must reach —
    no request is ever silently dropped:

    * ``"pending"`` — not terminal yet (queued or in flight),
    * ``"finished"`` — served to completion,
    * ``"shed"`` — turned away by admission/oversize rejection or by the
      router's rate limiting / SLO load shedding (``rejected`` also flips),
    * ``"expired"`` — its ``deadline`` passed before it could be served,
    * ``"failed"`` — lost to replica crashes more times than
      ``max_retries`` allowed.

    ``deadline`` (router steps since submission, ``None`` = none) and the
    ``max_retries`` budget are enforced by the router; the engine itself
    only distinguishes finished vs shed.
    """

    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    rejected: bool = False
    truncated: bool = False
    # request class: the router stamps its priority tier here at submit;
    # the engine's speculative decoder keys its per-class acceptance-rate
    # tracking on it (None = "default" class)
    tier: Optional[int] = None
    # flips on first admission to a slot: a draining engine keeps serving
    # started requests (including hot-swap re-queues) but hands
    # never-started ones back to the caller (see ServingEngine.drain)
    started: bool = False
    # robustness contract (enforced by the router; see class docstring)
    deadline: Optional[int] = None
    max_retries: int = 2
    retries: int = 0
    state: str = "pending"


class ServingEngine:
    """Continuous-batching engine over a Moirai-placed stage pipeline.

    Args:
        cfg: model configuration (must have per-layer params,
            ``scan_layers=False``).
        params: model parameters (placed onto stage devices at build).
        cluster: the nominal :class:`ClusterSpec` the planner sees; the
            engine never mutates it — observed drift lives in
            :attr:`derate` / :attr:`cluster_effective`.
        devices: torch devices backing the cluster's indices (default:
            every visible CUDA card, reused modulo their count; raises
            when there is none — pass ``[torch.device("cpu")]`` to run on
            the CPU).
        slots: concurrent decode slots (continuous batching width); also
            threaded into planning as ``PlanConfig.serving_slots``.
        max_len: KV-cache capacity per slot (prompt + generated tokens).
        plan_cfg: planning knobs; ``None`` selects the engine default
            (throughput objective when ``slots > 1``, else latency).
        eos_id: token id that retires a sequence (-1 disables).
        straggler_factor: flag threshold for :meth:`straggler_report`.
        adapt: :class:`AdaptationConfig` for the observe → derate → replan
            loop; ``None`` uses the defaults (manual windows only — set
            ``window_steps > 0`` to close the loop automatically).
        admission: ``"queue"`` (default) holds requests in the queue while
            their KV residency would overflow a planned device;
            ``"reject"`` retires them immediately with ``rejected=True``.
        batching: ``"ragged"`` (default) decodes every slot at its own cache
            position (continuous admission into any free slot);
            ``"lockstep"`` shares one position across the batch and admits
            only equal-depth cohorts (the seed-engine behavior, kept as the
            benchmark baseline).
        prefill_chunk: tokens consumed per interleaved prefill chunk;
            ``None`` = blocking whole-prompt prefill at admission (the
            pre-chunking behavior).  Defaults to the plan config's
            ``prefill_chunk`` so the planner scores the prefill schedule
            the engine actually runs.  Chunking engages in ragged batching
            only — lockstep keeps the seed engine's blocking prefill.
        fused: pack pending prefill chunks INTO the batched ragged decode
            forward (per-row ``(cache_pos, q_len)``) so one compiled
            program serves the whole step.  Defaults to the plan config's
            ``fused_prefill`` ("score what the engine runs"); only engages
            when chunked prefill is on (ragged batching + a chunk size).
            ``False`` restores the earlier interleaved path: one batch-1
            chunk forward between decode steps.
        oversize: what to do with a request whose ``prompt +
            max_new_tokens`` cannot fit a ``max_len`` cache row:
            ``"truncate"`` (default) drops the OLDEST prompt tokens to fit
            and flags ``Request.truncated``; ``"reject"`` retires it
            immediately with ``rejected=True``.  Without this check an
            oversized prompt silently clamps/corrupts the slot's cache row
            (``_maybe_retire``'s capacity check only fires post-hoc).
        placement_result: a pre-solved :class:`PlacementResult` to serve
            (e.g. one replica of a :func:`repro_torch.core.replica.plan_replicas`
            service plan, remapped to THIS engine's cluster indices) —
            skips the engine-startup ``plan()`` call entirely.  Must cover
            exactly this engine's block graph at ``max_len``.
        draft_cfg: speculative serving's draft model — not ported yet
            (ROADMAP A7): anything but ``None`` raises
            ``NotImplementedError``.
        draft_params: the draft model's parameters (see ``draft_cfg``).
    """

    # sentinel: "take prefill_chunk from the plan config"
    _FROM_PLAN = object()

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        cluster: ClusterSpec,
        *,
        devices: Optional[List[Any]] = None,
        slots: int = 4,
        max_len: int = 256,
        plan_cfg: Optional[PlanConfig] = None,
        eos_id: int = 0,
        straggler_factor: float = 4.0,
        adapt: Optional[AdaptationConfig] = None,
        admission: str = "queue",
        batching: str = "ragged",
        prefill_chunk: Any = _FROM_PLAN,
        fused: Any = _FROM_PLAN,
        oversize: str = "truncate",
        placement_result: Optional[PlacementResult] = None,
        draft_cfg: Optional[ModelConfig] = None,
        draft_params=None,
    ):
        self.cfg = cfg
        self.params = params
        self.cluster = cluster
        if draft_cfg is not None or draft_params is not None:
            raise NotImplementedError(
                "speculative serving (draft_cfg) is not ported yet (ROADMAP A7)"
            )
        if devices is None:
            devices = cuda_devices()
        self.devices = list(devices)
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.straggler_factor = straggler_factor
        if admission not in ("queue", "reject"):
            raise ValueError(f"admission must be 'queue' or 'reject', got {admission!r}")
        self.admission = admission
        if batching not in ("ragged", "lockstep"):
            raise ValueError(
                f"batching must be 'ragged' or 'lockstep', got {batching!r}"
            )
        self.batching = batching
        if oversize not in ("truncate", "reject"):
            raise ValueError(
                f"oversize must be 'truncate' or 'reject', got {oversize!r}"
            )
        self.oversize = oversize
        # serving >1 slot is a pipelined workload: optimize steady-state
        # throughput (bottleneck-stage time), not single-query makespan, and
        # charge Eq. 5 one resident KV-cache copy per slot so the planner
        # never admits a placement the engine cannot hold at full concurrency
        if plan_cfg is None:
            plan_cfg = PlanConfig(
                method="moirai",
                time_limit=20.0,
                objective="throughput" if slots > 1 else "latency",
                serving_slots=slots,
            )
        elif plan_cfg.serving_slots == 1 and slots > 1:
            # a caller-supplied config (e.g. just raising the solver budget)
            # still gets the engine's real concurrency unless it explicitly
            # chose a slot count — otherwise plan() and replan() would admit
            # placements whose per-slot KV residency overflows device memory
            plan_cfg = dataclasses.replace(plan_cfg, serving_slots=slots)
        self.plan_cfg = plan_cfg

        # interleaved prefill: chunk size comes from the plan config unless
        # overridden, so "score what the engine runs" holds by construction
        if prefill_chunk is ServingEngine._FROM_PLAN:
            prefill_chunk = self.plan_cfg.prefill_chunk
        if prefill_chunk is not None and int(prefill_chunk) <= 0:
            raise ValueError(
                f"prefill_chunk must be a positive int or None, got {prefill_chunk!r}"
            )
        self.prefill_chunk = None if prefill_chunk is None else int(prefill_chunk)

        # fused mixed-batch stepping follows the plan config unless
        # overridden — same "score what the engine runs" contract as
        # prefill_chunk (the planner's fused_prefill flag and this engage
        # together by default)
        if fused is ServingEngine._FROM_PLAN:
            fused = getattr(self.plan_cfg, "fused_prefill", True)
        self.fused = bool(fused)

        # paged KV cache (PlanConfig.kv_page_tokens): the next slice of the
        # port (ROADMAP A0) — dense per-slot rows only for now
        self.kv_page_tokens = getattr(self.plan_cfg, "kv_page_tokens", None)
        if self.kv_page_tokens is not None:
            raise NotImplementedError(
                "paged KV (kv_page_tokens) is not ported yet (ROADMAP A0)"
            )

        # adaptation loop state: the policy owns streaks/hysteresis, the
        # engine owns the applied derate maps and the (derated) cost model.
        # With AdaptationConfig.state_path set, a previously persisted
        # policy state is resumed: the engine plans on the derated cluster
        # it had already learned — MINUS the devices it had already seen
        # die — instead of rediscovering drift and failures from scratch.
        self.policy = DeratePolicy(adapt)
        state_path = self.policy.config.state_path
        if state_path and os.path.exists(state_path):
            self.policy = DeratePolicy.load(state_path, self.policy.config)
        self.derate: Dict[int, float] = self.policy.derate_map()
        self.link_derate: Dict[Tuple[int, int], float] = (
            self.policy.link_derate_map()
        )
        self.failed_devices: List[int] = [
            d for d in self.policy.failed_devices if 0 <= d < cluster.k
        ]
        self._devices_all: Optional[List[Any]] = None  # pre-failure torch devices
        self.cluster_effective: ClusterSpec = self._effective_cluster()
        self.replan_history: List[Dict[str, Any]] = []
        self._steps_since_window = 0

        # chaos-harness state: an optional FaultInjector polled at the top
        # of every step(); injected transient faults stash the pre-fault
        # factor so a recover event can restore it exactly
        self._injector = None
        self._stall_prev: Dict[int, Optional[float]] = {}
        self._link_fault_prev: Dict[Tuple[int, int], Optional[float]] = {}
        self.fault_log: Deque[Dict[str, Any]] = deque(maxlen=4096)

        self.graph = transformer_graph(cfg, seq_len=max_len, granularity="block")
        self._cost = self._make_cost()
        if placement_result is not None:
            # a pre-solved plan (the router hands each replica its slice of
            # the service plan, in THIS engine's cluster indices) — must
            # cover the same block graph this engine builds at max_len
            if set(placement_result.placement) != set(self.graph.nodes):
                raise ValueError(
                    "placement_result does not cover this engine's graph "
                    f"({len(placement_result.placement)} placed ops vs "
                    f"{len(self.graph.nodes)} nodes at max_len={max_len})"
                )
            self.placement_result = placement_result
        else:
            self.placement_result = self._solve_placement()
        self._build_executor(
            self._executor_placement(self.placement_result.placement)
        )

        self.queue: List[Request] = []
        # drain mode: no NEW request may start — submit() refuses, _admit
        # only re-admits started (hot-swap re-queued) work — while in-flight
        # requests run to completion (see begin_drain/drain)
        self.draining = False
        # recent terminal requests (bounded — a long-lived engine must not
        # retain every historical request's token lists forever)
        self.finished: Deque[Request] = deque(maxlen=4096)
        self._finish_sink: Optional[List[Request]] = None
        # requests rejected AT SUBMIT time (oversize validation) — delivered
        # by the next run_until_drained call so its return list never
        # silently drops a rejection; bounded like the finished ring, and
        # deliberately NOT fed by step()-driven completions (those belong to
        # whichever drain call — if any — is active when they retire)
        self._unclaimed_finished: Deque[Request] = deque(maxlen=4096)
        self.active: List[Optional[Request]] = [None] * slots
        self.slot_pos = np.zeros(slots, dtype=np.int64)
        self.caches = None
        # count of terminal requests pushed out of the bounded
        # _unclaimed_finished ring before any drain call claimed them —
        # surfaced in straggler_report() so the loss is visible, not silent
        self._unclaimed_overflow = 0

    # ------------------------------------------------------------------
    def _effective_cluster(self) -> ClusterSpec:
        """The nominal cluster with the applied device AND channel derates
        folded in (original indices; failed devices are excluded at plan
        time, not here — the cost model stays valid in original indices)."""
        if self.derate or self.link_derate:
            return self.cluster.with_derate(self.derate, links=self.link_derate)
        return self.cluster

    # ------------------------------------------------------------------
    def _executor_placement(self, placement: Dict[int, int]) -> Dict[int, int]:
        """Translate a plan in ORIGINAL cluster indices into the compacted
        alive-device indices the executor runs on (and point
        ``self.devices`` at the surviving torch devices).  Identity while no
        device has failed; shared by startup (a restart that resumed
        ``failed_devices`` from persisted policy state) and every
        failure/derate rebuild."""
        if not self.failed_devices:
            return dict(placement)
        alive = [i for i in range(self.cluster.k) if i not in self.failed_devices]
        if self._devices_all is None:
            self._devices_all = list(self.devices)
        self.devices = [
            self._devices_all[i % len(self._devices_all)] for i in alive
        ]
        remap = {orig: j for j, orig in enumerate(alive)}
        return {n: remap[k] for n, k in placement.items()}

    # ------------------------------------------------------------------
    def _make_cost(self) -> CostModel:
        """Cost model over the effective (derated) cluster, paging-aware:
        with ``kv_page_tokens`` set, Eq. 5's KV term charges pages actually
        resident (``ceil(residency · S / P) · P`` tokens per slot) instead
        of dense ``max_len`` rows — the same accounting ``plan()`` applies,
        so "score what the engine runs" holds for memory too."""
        return CostModel(
            self.cluster_effective,
            kv_page_tokens=self.kv_page_tokens,
            kv_seq_tokens=self.max_len if self.kv_page_tokens else None,
            kv_residency=float(
                getattr(self.plan_cfg, "kv_residency", 1.0) or 1.0
            ),
        )

    # ------------------------------------------------------------------
    def _solve_placement(self) -> PlacementResult:
        """Solve THE placement problem this engine serves — one path shared
        by startup and every failure/derate replan."""
        if self.failed_devices or self.derate or self.link_derate:
            return replan(
                self.graph, self.cluster, self.failed_devices, self.plan_cfg,
                derate=self.derate, link_derate=self.link_derate,
            )
        return plan(self.graph, self.cluster, self.plan_cfg)

    # ------------------------------------------------------------------
    def _persist_policy(self):
        """Write the policy's control state to ``state_path`` (when set) so
        an engine restart resumes the learned derates — and the known-dead
        device list, so the restarted engine excludes them from its very
        first plan instead of re-crashing into them."""
        path = self.policy.config.state_path
        if path:
            self.policy.failed_devices = sorted(
                int(d) for d in self.failed_devices
            )
            self.policy.save(path)

    # ------------------------------------------------------------------
    @property
    def adaptation_events(self) -> List[AdaptationEvent]:
        """Chronological log of every adaptation decision (derate,
        underate, hold, replan) made by the policy."""
        return self.policy.events

    # ------------------------------------------------------------------
    def _build_executor(self, placement: Dict[int, int]):
        stages = stages_from_placement(
            self.graph, placement, self.devices, self.cfg.n_layers
        )
        self.executor = StageExecutor(self.cfg, self.params, stages)
        self.caches = None  # caches are invalid after a topology change
        # ...and so is any mid-prefill progress: the chunks written so far
        # lived in the old executor's cache rows
        self._prefill_toks: Dict[int, List[int]] = {}
        self._prefill_done: Dict[int, int] = {}
        self._prefill_rr = 0
        self._pred_stage_s = self._predict_stage_times()
        # per-chunk predictions only make sense when prefill actually runs
        # in chunks — blocking/lockstep prefill forwards span whole prompts
        # of varying length, which no single prediction can anchor
        self._pred_prefill_stage_s = (
            self._predict_prefill_stage_times(self.prefill_chunk)
            if self._chunked_prefill_on()
            else []
        )
        # per-stage op-class weights are fixed between rebuilds — compute
        # once, not every observation window
        self._stage_classes = [
            self._stage_class_weights(i) for i in range(len(stages))
        ]
        # whole-run observation history for reporting (windows DRAIN the
        # executor's recorders; straggler_report must still see the run).
        # Decode and prefill are kept apart: the derate loop consumes only
        # decode samples, prefill shows up in its own report section.
        self._observed_history: List[Deque[float]] = [
            deque(maxlen=4096) for _ in stages
        ]
        self._observed_prefill_history: List[Deque[float]] = [
            deque(maxlen=4096) for _ in stages
        ]
        # KV-aware admission width: memory_ok is monotone in serving_slots,
        # and the placement only changes on rebuild — resolve the max
        # feasible in-flight count ONCE here so per-step admission is an
        # integer compare, not an O(nodes) memory scan
        mem_graph, mem_place = self.graph, self.placement_result.placement
        self._max_in_flight = 0
        for n in range(self.slots, 0, -1):
            if self._cost.memory_ok(mem_graph, mem_place, serving_slots=n):
                self._max_in_flight = n
                break

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        """Enqueue a request; admission happens on the next :meth:`step`.

        Oversize validation happens HERE, not at admission: a prompt whose
        ``prompt + max_new_tokens`` cannot fit a ``max_len`` cache row would
        silently clamp/corrupt the slot's KV (the retirement-time capacity
        check only fires after the damage).  Per the ``oversize`` policy the
        request is either truncated (oldest prompt tokens dropped, flagged
        ``truncated=True``) or rejected outright."""
        if self.draining:
            raise RuntimeError(
                "engine is draining: new requests must go to another replica"
            )
        budget = self.max_len - int(req.max_new_tokens)
        if len(req.prompt) > budget:
            if self.oversize == "reject" or budget < 1:
                # budget < 1: even an empty prompt cannot fit the requested
                # generation — truncation cannot save it
                req.rejected = True
                req.state = "shed"
                req.done = True
                self._record_finished(req)
                if self._finish_sink is None:
                    # no drain call active: hold the reject for the next one
                    if (
                        len(self._unclaimed_finished)
                        == self._unclaimed_finished.maxlen
                    ):
                        self._unclaimed_overflow += 1
                    self._unclaimed_finished.append(req)
                return
            req.prompt = list(req.prompt[-budget:])   # keep the newest context
            req.truncated = True
        self.queue.append(req)

    def _admission_ok(self, n_in_flight: int) -> bool:
        """Runtime Eq. 5: does the KV residency of ``n_in_flight``
        concurrent sequences still fit every planned device?

        Plan-time ``serving_slots`` sizing guarantees this for the ORIGINAL
        plan at full concurrency, but failures and derate-replans can land
        on placements where the envelope's best feasible candidate still
        overflows at ``slots``-wide concurrency — admission then caps the
        effective width instead of OOMing a device.  (The width is resolved
        once per rebuild — see ``_build_executor`` — so this is an integer
        compare on the decode path.)"""
        return n_in_flight <= max(self._max_in_flight, 0)

    def _next_queue_idx(self) -> Optional[int]:
        """Queue index of the next admissible request: the head normally;
        while draining, the first STARTED request (a hot-swap re-queue whose
        accepted work must finish) — never-started requests wait for
        ``begin_drain`` to hand them back."""
        if not self.queue:
            return None
        if not self.draining:
            return 0
        for i, r in enumerate(self.queue):
            if r.started:
                return i
        return None

    def _admit(self):
        for slot in range(self.slots):
            qi = self._next_queue_idx()
            if self.active[slot] is None and qi is not None:
                head = self.queue[qi]
                n_active = sum(r is not None for r in self.active)
                if self.batching == "lockstep":
                    # lockstep cohort check (legacy baseline): batched decode
                    # shares one cache position across slots, so a request
                    # may only join a batch whose active slots sit at
                    # EXACTLY its resume depth (prompt + generated).
                    # Unequal-depth requests — mixed prompt lengths, or
                    # hot-swap re-queues of sequences that were at different
                    # depths — wait for the wave to drain instead of
                    # silently corrupting the laggard's KV rows.  Ragged
                    # batching (the default) has no such constraint: every
                    # slot carries its own cache position.
                    pos_set = {
                        int(self.slot_pos[i])
                        for i, r in enumerate(self.active)
                        if r is not None
                    }
                    depth = len(head.prompt) + len(head.out_tokens)
                    if pos_set and pos_set != {depth}:
                        break
                toks_head = list(head.prompt) + list(head.out_tokens)
                if n_active > 0 and not self._admission_ok(n_active + 1):
                    # one more resident KV copy would overflow a planned
                    # device. (With zero active requests we
                    # admit regardless: if even one sequence does not fit,
                    # holding it forever is a livelock, not protection —
                    # serve best-effort.)
                    # A request with generated tokens was ALREADY admitted
                    # once (re-queued by a hot-swap) — never reject it, or
                    # accepted half-served work would be silently discarded
                    if self.admission == "reject" and not head.out_tokens:
                        req = self.queue.pop(qi)
                        req.rejected = True
                        req.state = "shed"
                        req.done = True
                        self._record_finished(req)
                        continue
                    break  # "queue": retry when a slot's KV frees
                req = self.queue.pop(qi)
                req.started = True
                self.active[slot] = req
                # prompt + out_tokens so a request re-queued by a hot-swap
                # resumes its greedy decode exactly where it was
                toks_list = toks_head
                if self._chunked_prefill_on() and toks_list:
                    # interleaved prefill: only REGISTER the work here — the
                    # prompt is consumed one prefill_chunk per engine step
                    # (between decode batches) by _advance_prefill, directly
                    # into this slot's cache row
                    self._ensure_caches()
                    self._prefill_toks[slot] = toks_list
                    self._prefill_done[slot] = 0
                    self.slot_pos[slot] = 0
                    continue
                # blocking whole-prompt prefill (lockstep baseline, or
                # prefill_chunk=None): batch-1 prefill into the slot's row
                toks = torch.tensor([toks_list], dtype=torch.int32)
                logits, slot_caches = self._prefill_slot(toks)
                nxt = int(torch.argmax(logits[0, -1]))
                req.out_tokens.append(nxt)
                self._write_slot_cache(slot, slot_caches)
                self.slot_pos[slot] = len(toks_list)
                # the prefill-produced token can itself finish the request
                # (EOS, or a re-queued request one token short of budget) —
                # retire NOW or a decode step would overshoot the budget
                self._maybe_retire(slot, nxt)

    def _ensure_caches(self):
        """Lazily allocate the dense ``(slots, max_len)`` device caches."""
        if self.caches is not None:
            return
        self.caches = self.executor.init_caches(self.slots, self.max_len)

    def _chunked_prefill_on(self) -> bool:
        """Interleaved chunked prefill is a ragged-batching feature: the
        lockstep baseline keeps the seed engine's blocking prefill (its
        equal-depth cohort admission is defined around completed prefills)."""
        return self.prefill_chunk is not None and self.batching == "ragged"

    def _fused_on(self) -> bool:
        """Fused mixed-batch stepping rides on chunked prefill: prefill rows
        can only join the decode batch when prompts arrive in fixed-shape
        chunks (ragged batching + a chunk size)."""
        return self.fused and self._chunked_prefill_on()

    def _prefill_slot(self, toks):
        caches = self.executor.init_caches(1, self.max_len)
        logits, new_caches = self.executor.forward(
            toks, caches, cache_pos=0, kind="prefill"
        )
        return logits, new_caches

    def _slot_row_caches(self, slot: int):
        """Batch-1 view of ``slot``'s cache rows (one row per stage layer) —
        the chunk forward reads/writes the live row, not a fresh cache.

        LEGACY interleaved path only (``fused=False``): the gather here
        (and the scatter in ``_write_slot_cache``) copies the full
        ``max_len`` row per layer per chunk — O(max_len/chunk)× more cache
        traffic than the chunk writes.  The fused path never calls either:
        prefill chunks ride as rows of the batched forward and the per-row
        masked KV scatter touches only the written span in place."""
        return [
            [
                {key: layer[key][slot : slot + 1] for key in ("k", "v")}
                for layer in st_caches
            ]
            for st_caches in self.caches
        ]

    def _advance_prefill(self) -> Optional[int]:
        """Consume ONE ``prefill_chunk``-token chunk for the next mid-prefill
        slot (round-robin), forwarded batch-1 into that slot's cache row at
        its current depth.  At most one chunk per engine step, so active
        slots never stall more than one chunk between decode steps.  Returns
        the advanced slot index (None when nothing is mid-prefill)."""
        if not self._prefill_toks:
            return None
        slot = None
        for off in range(self.slots):
            cand = (self._prefill_rr + off) % self.slots
            if cand in self._prefill_toks:
                slot = cand
                break
        self._prefill_rr = (slot + 1) % self.slots
        toks_all = self._prefill_toks[slot]
        done = self._prefill_done[slot]
        n = min(self.prefill_chunk, len(toks_all) - done)
        # fixed-shape chunks: pad the tail chunk to prefill_chunk tokens so
        # EVERY chunk forward shares one compiled (1, chunk) program —
        # whole-prompt prefill recompiles per distinct prompt length, which
        # is its own head-of-line stall on an XLA backend.  Pad KV rows land
        # beyond the prompt: causally masked until the decode steps
        # overwrite them position by position, so they never leak into
        # logits.  (Skipped in the rare case the pad would spill past the
        # cache row — the write start would clamp and corrupt real entries.)
        pad = self.prefill_chunk - n
        if pad and done + self.prefill_chunk > self.max_len:
            pad = 0
        chunk_toks = toks_all[done : done + n] + [0] * pad
        chunk = torch.tensor([chunk_toks], dtype=torch.int32)
        row = self._slot_row_caches(slot)
        logits, row = self.executor.forward(
            chunk, row, cache_pos=int(done), kind="prefill"
        )
        self._write_slot_cache(slot, row)
        done += n
        self._prefill_done[slot] = done
        # a garbage decode row writes (and is later overwritten) at this
        # depth while the prefill is still in flight — see step()
        self.slot_pos[slot] = done
        if done == len(toks_all):
            del self._prefill_toks[slot]
            del self._prefill_done[slot]
            req = self.active[slot]
            # the next token comes from the LAST REAL prompt row (row n-1),
            # not the padded tail
            nxt = int(torch.argmax(logits[0, n - 1]))
            req.out_tokens.append(nxt)
            # the prefill-produced token can itself finish the request
            self._maybe_retire(slot, nxt)
        return slot

    def _write_slot_cache(self, slot: int, slot_caches):
        if self.caches is None:
            self.caches = self.executor.init_caches(self.slots, self.max_len)
        for si, st_caches in enumerate(slot_caches):
            for li, layer_cache in enumerate(st_caches):
                for key in ("k", "v"):
                    dst = self.caches[si][li][key]
                    if dst[slot].data_ptr() != layer_cache[key][0].data_ptr():
                        dst[slot].copy_(layer_cache[key][0])

    # ------------------------------------------------------------------
    def _record_finished(self, req: Request):
        """Log a terminal request: into the bounded :attr:`finished` ring
        and, when a ``run_until_drained`` call is active, its return list."""
        self.finished.append(req)
        if self._finish_sink is not None:
            self._finish_sink.append(req)

    def _maybe_retire(self, slot: int, last_token: int) -> bool:
        """Retire the request in ``slot`` if ``last_token`` finished it
        (EOS, token budget, or cache capacity); frees the slot and records
        the request in :attr:`finished`.  Returns True when retired."""
        req = self.active[slot]
        if req is None:
            return False
        if (
            last_token == self.eos_id
            or len(req.out_tokens) >= req.max_new_tokens
            or self.slot_pos[slot] >= self.max_len - 1
        ):
            req.done = True
            req.state = "finished"
            self.active[slot] = None
            # park the freed slot at depth 0: an inactive row's garbage
            # decode then writes (and attends) at its row's position 0,
            # which the next admission's full-row prefill overwrites anyway
            self.slot_pos[slot] = 0
            self._record_finished(req)
            return True
        return False

    def step(self) -> int:
        """One engine iteration: admit → advance at most one prefill chunk →
        batched decode → retire → (possibly) close an observation window.
        Returns the number of active sequences that made progress this step
        (decoded a token, or advanced a prefill chunk).

        Ragged batching (default): the decode batch carries a ``(slots,)``
        ``cache_pos`` vector — every slot writes KV at its own depth and
        masks over its own valid length, so any mix of depths decodes
        together and admission is continuous (``_admit`` fills any free
        slot immediately).  Slots whose prompt is still being consumed by
        the chunked-prefill state machine sit the decode out (their row
        decodes garbage that the next chunk overwrites); everyone else
        decodes every step — a long prompt no longer stalls the batch.
        ``batching="lockstep"`` shares one position (the max over active
        slots) and relies on ``_admit``'s equal-depth cohort check — the
        seed-engine behavior kept as a baseline.

        With ``fused`` on (the default when chunking is on), the step runs
        ONE fused forward instead: pending prefill chunks pack into the
        decode batch as rows with their own ``(cache_pos, q_len)``, every
        mid-prefill slot advances a chunk every step, and the compiled
        program count per step drops from two to one.

        An attached :class:`~repro_torch.serving.faults.FaultInjector` is polled
        FIRST — scheduled faults land before admission/decode, so a step-N
        fault affects step N, exactly as the schedule says."""
        if self._injector is not None:
            self._injector.on_step(self)
        self._admit()
        if self._fused_on():
            return self._step_fused()
        adv_slot = self._advance_prefill() if self._prefill_toks else None
        # decode-ready slots: active AND fully prefilled
        idx = [
            i for i, r in enumerate(self.active)
            if r is not None and i not in self._prefill_toks
        ]
        # progress count: slots that decoded a token, plus the slot whose
        # prefill advanced — counted once if its final chunk let it do both
        progressed = set(idx)
        if adv_slot is not None:
            progressed.add(adv_slot)
        if not idx:
            return len(progressed)
        # batched single-token decode over ALL slots (inactive and
        # mid-prefill slots decode garbage into their own rows — inactive
        # rows are masked at retirement, mid-prefill rows are overwritten
        # by their next chunk)
        last = [
            (
                self.active[i].out_tokens[-1]
                if self.active[i] and i not in self._prefill_toks
                else 0
            )
            for i in range(self.slots)
        ]
        toks = torch.tensor(last, dtype=torch.int32)[:, None]
        if self.batching == "lockstep":
            pos = int(max(self.slot_pos[i] for i in idx))
        else:
            pos = np.asarray(self.slot_pos, np.int32)   # one depth per slot
        logits, self.caches = self.executor.forward(
            toks, self.caches, cache_pos=pos, kind="decode"
        )
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for i in idx:
            req = self.active[i]
            req.out_tokens.append(int(nxt[i]))
            self.slot_pos[i] += 1
            self._maybe_retire(i, int(nxt[i]))
        # closed loop: every window_steps decode steps, observe and adapt
        ws = self.policy.config.window_steps
        if ws > 0:
            self._steps_since_window += 1
            if self._steps_since_window >= ws:
                self.observe_window()
        return len(progressed)

    def _fused_decode_frac(self, n_prefill_rows: int) -> Optional[List[float]]:
        """Predicted decode share of each stage's wall time in a fused
        forward carrying ``n_prefill_rows`` chunk rows — splits the single
        observed sample into a decode and a prefill part so neither op
        class pollutes the other's observation window."""
        if n_prefill_rows <= 0:
            return None                       # pure decode: 1.0 everywhere
        dec = self._pred_stage_s
        pre = self._pred_prefill_stage_s
        fracs = []
        for i, d in enumerate(dec):
            p = n_prefill_rows * (pre[i] if i < len(pre) else 0.0)
            fracs.append(d / (d + p) if d + p > 0 else 1.0)
        return fracs

    def _step_fused(self) -> int:
        """One FUSED engine iteration: decode-ready slots, mid-prefill
        slots, and idle slots ride one ``[slots, S]`` forward with per-row
        ``(cache_pos, q_len)`` — S is ``prefill_chunk`` when any prefill is
        pending, else 1 (two compiled shapes total).  Decode rows carry
        ``q_len=1`` at their decode depth, prefill rows their chunk at its
        offset, idle rows ``q_len=0`` (they write NOTHING — unlike the
        legacy path's garbage rows).  Every mid-prefill slot advances every
        step, and the slot cache rows are written in place (no
        ``_slot_row_caches`` gather / ``_write_slot_cache`` scatter)."""
        idx = [
            i for i, r in enumerate(self.active)
            if r is not None and i not in self._prefill_toks
        ]
        pf_slots = sorted(self._prefill_toks)
        if not idx and not pf_slots:
            return 0
        self._ensure_caches()
        s = self.prefill_chunk if pf_slots else 1
        tokens = np.zeros((self.slots, s), dtype=np.int32)
        q_lens = np.zeros(self.slots, dtype=np.int32)
        cache_pos = np.zeros(self.slots, dtype=np.int32)
        for i in idx:
            tokens[i, 0] = self.active[i].out_tokens[-1]
            q_lens[i] = 1
            cache_pos[i] = self.slot_pos[i]
        pf_n: Dict[int, int] = {}
        for i in pf_slots:
            done = self._prefill_done[i]
            toks_all = self._prefill_toks[i]
            n = min(self.prefill_chunk, len(toks_all) - done)
            tokens[i, :n] = toks_all[done : done + n]
            q_lens[i] = n
            cache_pos[i] = done
            pf_n[i] = n
        logits, self.caches = self.executor.forward(
            torch.from_numpy(tokens),
            self.caches,
            cache_pos=cache_pos,
            kind="fused",
            q_lens=torch.from_numpy(q_lens),
            fused_decode_frac=self._fused_decode_frac(len(pf_slots)),
        )
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()   # [slots, S]
        for i in idx:
            req = self.active[i]
            req.out_tokens.append(int(nxt[i, 0]))
            self.slot_pos[i] += 1
            self._maybe_retire(i, int(nxt[i, 0]))
        for i in pf_slots:
            n = pf_n[i]
            done = self._prefill_done[i] + n
            self._prefill_done[i] = done
            self.slot_pos[i] = done
            if done == len(self._prefill_toks[i]):
                del self._prefill_toks[i]
                del self._prefill_done[i]
                req = self.active[i]
                # next token from the last REAL prompt row of the chunk
                tok = int(nxt[i, n - 1])
                req.out_tokens.append(tok)
                self._maybe_retire(i, tok)
        # closed loop: fused steps that decoded count toward the window
        ws = self.policy.config.window_steps
        if idx and ws > 0:
            self._steps_since_window += 1
            if self._steps_since_window >= ws:
                self.observe_window()
        return len(set(idx) | set(pf_slots))

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        """Step until the queue and all slots are empty (or ``max_steps``).

        Returns the requests that reached a terminal state during THIS call
        — served to completion, or turned away by ``admission="reject"`` or
        oversize validation (check ``Request.rejected``); oversize rejects
        issued at submit time since the previous call are included too."""
        sink: List[Request] = list(self._unclaimed_finished)
        self._unclaimed_finished.clear()
        self._finish_sink = sink
        try:
            for _ in range(max_steps):
                n = self.step()
                if n == 0 and not self.queue:
                    break
        finally:
            self._finish_sink = None
        return sink

    # ------------------------------------------------------------------
    # drain: stop admission, finish in-flight work, free the devices
    # ------------------------------------------------------------------
    def begin_drain(self) -> List[Request]:
        """Enter drain mode without blocking: ``submit`` starts refusing,
        never-started queued requests are removed and RETURNED (the caller —
        typically the router — re-dispatches them to healthy replicas), and
        in-flight work keeps stepping to completion.  Hot-swap/replan paths
        stay fully functional while draining: ``_requeue_active`` re-queues
        started requests and ``_admit`` re-admits exactly those."""
        self.draining = True
        handed = [r for r in self.queue if not r.started]
        if handed:
            self.queue = [r for r in self.queue if r.started]
        return handed

    def drain(self, max_steps: int = 10_000) -> Dict[str, Any]:
        """Blocking drain: :meth:`begin_drain`, then step until in-flight
        work completes.  Returns::

            {"handed_back":   never-started requests for re-dispatch,
             "finished":      requests that completed during the drain,
             "freed_devices": surviving ORIGINAL cluster device indices now
                              free for a service-level replan,
             "drained":       True when nothing is left in flight}
        """
        handed = self.begin_drain()
        finished = self.run_until_drained(max_steps=max_steps)
        freed = [
            i for i in range(self.cluster.k) if i not in self.failed_devices
        ]
        drained = not self.queue and all(r is None for r in self.active)
        return {
            "handed_back": handed,
            "finished": finished,
            "freed_devices": freed,
            "drained": drained,
        }

    def health(self) -> float:
        """Fraction of the replica's NOMINAL peak flops still effective:
        ``Σ surviving peak × derate ÷ Σ nominal peak``.  1.0 = pristine;
        failures and accumulated derates pull it down.  The router drains a
        replica whose health sinks below its floor."""
        total = sum(d.peak_flops for d in self.cluster.devices)
        if total <= 0:
            return 0.0
        alive = sum(
            d.peak_flops * self.derate.get(i, 1.0)
            for i, d in enumerate(self.cluster.devices)
            if i not in self.failed_devices
        )
        return alive / total

    def pending_prefill_tokens(self) -> int:
        """Prompt tokens queued ahead of a new arrival: unfinished prefill
        of in-flight slots plus every queued request's prompt + resume
        tokens.  The router's shortest-expected-prefill dispatch ranks
        replicas by this."""
        pend = 0
        for slot, toks in self._prefill_toks.items():
            pend += max(len(toks) - self._prefill_done.get(slot, 0), 0)
        for r in self.queue:
            pend += len(r.prompt) + len(r.out_tokens)
        return pend

    # ------------------------------------------------------------------
    # fault tolerance / elasticity
    # ------------------------------------------------------------------
    def _requeue_active(self):
        """Move in-flight requests back to the queue front before a
        hot-swap.  Their generated tokens are kept: on re-admission the
        prefill covers prompt + out_tokens, so greedy decoding resumes
        exactly where it stopped (caches are rebuilt, generated work is not
        lost).  With chunked prefill on, the re-prefill runs through the
        same interleaved state machine — chunk by chunk, never as one
        monolithic prompt+generated pass — so a hot-swap cannot reintroduce
        the head-of-line stall it is supposed to avoid.  Mid-prefill
        progress itself cannot survive (the chunks written so far live in
        the old topology's cache rows), so those requests restart their
        prefill from token 0."""
        pending = [r for r in self.active if r is not None]
        self.active = [None] * self.slots
        self.slot_pos = np.zeros(self.slots, dtype=np.int64)
        self._prefill_toks = {}
        self._prefill_done = {}
        self.queue[:0] = pending

    def _replan_and_rebuild(self, reason: str):
        """Re-plan on the observed cluster (minus failures, with device AND
        channel derates) and hot-swap the executor; one path shared by
        failure handling, fault injection, and the adaptation loop."""
        res = self._solve_placement()
        self.placement_result = res
        self.cluster_effective = self._effective_cluster()
        self._cost = self._make_cost()
        self._requeue_active()
        self._build_executor(self._executor_placement(res.placement))
        if len(self.replan_history) >= 4096:  # bounded, like every other log
            del self.replan_history[:-2048]
        self.replan_history.append({
            "reason": reason,
            "window": self.policy.windows,
            "failed_devices": list(self.failed_devices),
            "derate": dict(self.derate),
            "link_derate": {
                f"{a}-{b}": f for (a, b), f in sorted(self.link_derate.items())
            },
            "method": res.method,
            "stages": len(self.executor.stages),
        })

    def on_device_failure(self, device_idx: int):
        """Re-plan on the surviving devices and rebuild stages (weights
        migrate; in-flight sequences are re-queued and resume after
        re-prefill).

        ``device_idx`` is an ORIGINAL cluster index; repeated failures
        accumulate — the re-plan always excludes every failed device (and
        keeps any active derates on the survivors), and ``placement_result``
        stays in original indices so the startup cost model (and stage
        predictions) remain valid."""
        if device_idx in self.failed_devices or not 0 <= device_idx < self.cluster.k:
            raise ValueError(f"bad or already-failed device {device_idx}")
        self.failed_devices.append(device_idx)
        # a dead device needs no derate — drop it from the applied maps AND
        # from the policy, or the next committed factor change would
        # resurrect the dead device's derate into engine state.  Channels
        # touching the dead device go with it (no endpoint, no channel).
        self.derate.pop(device_idx, None)
        self._stall_prev.pop(device_idx, None)
        for chan in [c for c in self.link_derate if device_idx in c]:
            del self.link_derate[chan]
        for chan in [c for c in self._link_fault_prev if device_idx in c]:
            del self._link_fault_prev[chan]
        self.policy.forget(device_idx)
        self._persist_policy()
        self._replan_and_rebuild(reason=f"device {device_idx} failed")

    # ------------------------------------------------------------------
    # chaos harness: scheduled fault injection (see serving.faults)
    # ------------------------------------------------------------------
    def attach_fault_injector(self, injector) -> None:
        """Attach a :class:`~repro_torch.serving.faults.FaultInjector`; it is
        polled at the top of every :meth:`step` (device/link indices in the
        schedule are THIS engine's cluster indices)."""
        self._injector = injector

    def apply_fault(self, ev) -> str:
        """Apply one :class:`~repro_torch.serving.faults.FaultEvent` to this
        engine.  Crashes route through :meth:`on_device_failure`; transient
        faults (stall/degrade/partition) stash the pre-fault factor so the
        matching ``recover`` restores it exactly, and each application
        replans + hot-swaps so the placement reflects the faulted cluster.
        Returns a status string (logged by the injector and in
        :attr:`fault_log`); out-of-scope events are reported as ignored
        rather than raising, so one schedule can drive many targets."""
        status = self._apply_fault(ev)
        self.fault_log.append({"kind": ev.kind, "status": status})
        return status

    def _apply_fault(self, ev) -> str:
        if ev.kind == "device_crash":
            dev = int(ev.device)
            if dev in self.failed_devices or not 0 <= dev < self.cluster.k:
                return f"ignored: device {dev} out of range or already failed"
            self.on_device_failure(dev)
            return f"crashed device {dev}"
        if ev.kind == "device_stall":
            dev = int(ev.device)
            if dev in self.failed_devices or not 0 <= dev < self.cluster.k:
                return f"ignored: device {dev} out of range or failed"
            self._stall_prev.setdefault(dev, self.derate.get(dev))
            self.derate[dev] = float(ev.factor)
            self._replan_and_rebuild(
                reason=f"injected stall on device {dev} (×{ev.factor:g})"
            )
            return f"stalled device {dev} at ×{ev.factor:g}"
        if ev.kind in ("link_degrade", "link_partition"):
            chan = (int(ev.link[0]), int(ev.link[1]))
            if any(d in self.failed_devices for d in chan) or not all(
                0 <= d < self.cluster.k for d in chan
            ):
                return f"ignored: link {chan} endpoint out of range or failed"
            factor = 0.0 if ev.kind == "link_partition" else float(ev.factor)
            self._link_fault_prev.setdefault(chan, self.link_derate.get(chan))
            self.link_derate[chan] = factor
            self._replan_and_rebuild(
                reason=f"injected link fault {chan} (bw ×{factor:g})"
            )
            return f"degraded link {chan} to ×{factor:g}"
        if ev.kind == "recover":
            if ev.device is not None:
                dev = int(ev.device)
                if dev not in self._stall_prev:
                    return f"ignored: device {dev} has no injected stall"
                prev = self._stall_prev.pop(dev)
                if prev is None:
                    self.derate.pop(dev, None)
                else:
                    self.derate[dev] = prev
                self._replan_and_rebuild(reason=f"device {dev} recovered")
                return f"recovered device {dev}"
            chan = (int(ev.link[0]), int(ev.link[1]))
            if chan not in self._link_fault_prev:
                return f"ignored: link {chan} has no injected fault"
            prev = self._link_fault_prev.pop(chan)
            if prev is None:
                self.link_derate.pop(chan, None)
            else:
                self.link_derate[chan] = prev
            self._replan_and_rebuild(reason=f"link {chan} recovered")
            return f"recovered link {chan}"
        return f"ignored: unknown fault kind {ev.kind!r}"

    # ------------------------------------------------------------------
    # adaptation loop: observe → derate → replan
    # ------------------------------------------------------------------
    def _stage_devices(self) -> List[int]:
        """ORIGINAL-cluster device index hosting each executor stage."""
        pl = self.placement_result.placement
        return [pl[st.node_ids[0]] for st in self.executor.stages]

    def _decode_batch(self) -> int:
        """The decode batch the executor actually runs: EVERY step decodes
        all ``slots`` rows in one batched forward (inactive rows decode
        garbage), so observed stage times are whole-batch times at this
        width — predictions must use the batch-aware cost model at the same
        width or the per-class amortization skews the obs/pred ratios."""
        return max(int(self.slots), 1)

    def _stage_class_weights(self, stage_idx: int) -> Dict[str, float]:
        """Op class → predicted-time share of one stage (calibrator input),
        at the live decode batch — per-class amortization differs per stage,
        so batch-1 weights would misattribute the evidence."""
        pl = self.placement_result.placement
        batch = self._decode_batch()
        w: Dict[str, float] = {}
        for n in self.executor.stages[stage_idx].node_ids:
            node = self.graph.nodes[n]
            w[node.op_type] = w.get(node.op_type, 0.0) + self._cost.compute_time(
                node, pl[n], batch=batch
            )
        return w

    def _drain_window(self) -> List[List[float]]:
        """DECODE stage times recorded since the last window (the executor's
        recorders reset; samples are retained in the bounded reporting
        histories) — each observation window sees only fresh samples.

        Prefill samples are split off into their own history and NEVER fed
        to the calibrator: a prefill forward's cost scales with prompt
        length, so comparing it against per-token decode predictions would
        read a burst of long prompts as device drift (spurious derates)."""
        pre = self.executor.stage_times(kind="prefill")
        fresh = self.executor.drain_stage_times(kind="decode")
        for hist, t in zip(self._observed_prefill_history, pre):
            hist.extend(t)
        for hist, t in zip(self._observed_history, fresh):
            hist.extend(t)
        return fresh

    def observe_window(
        self, observed: Optional[List[List[float]]] = None
    ) -> Dict[str, Any]:
        """Close one observation window of the adaptation loop.

        Converts the window's per-stage observed/predicted ratios into
        per-device speed evidence (fleet-normalized with a leave-one-out
        median so absolute cost-model error cancels, attributed across op
        classes by the :class:`DerateCalibrator`), feeds the
        :class:`DeratePolicy`, and — when the policy commits a factor
        change — re-plans on the derated cluster and hot-swaps stages.

        Args:
            observed: per-stage lists of stage seconds overriding the
                executor's recorded window (tests / external monitors);
                ``None`` drains the executor's samples since the last
                window.

        Returns:
            A summary dict: ``window`` (policy window count), ``ratios``
            (device → normalized ratio observed this window), ``derate``
            (the applied derate map after this window), ``replanned``
            (whether a hot-swap happened), and ``stragglers`` (the flagged
            stage indices of this window's report).
        """
        self._steps_since_window = 0
        if observed is None:
            observed = self._drain_window()
        rep = self.straggler_report(observed=observed)
        cfg = self.policy.config
        stats = rep["stages"]
        finite = {
            i: s["obs_over_pred"]
            for i, s in enumerate(stats)
            if s["n"] >= cfg.min_samples and np.isfinite(s["obs_over_pred"])
        }
        devs = self._stage_devices()
        cal = DerateCalibrator()
        for i, r in finite.items():
            # fleet baseline: ratios of stages on OTHER, NON-derated
            # devices.  Leave-DEVICE-out (not just leave-stage-out): a slow
            # device hosting several stages must not inflate its own
            # baseline and shield itself from derating.  Derated devices
            # are excluded too — a recovering (still-derated) device runs
            # "fast" against its derated predictions, and letting it into a
            # healthy device's baseline would make the healthy device look
            # like a straggler (and ping-pong the derate between the two
            # forever).  Only a stage ITSELF on a derated device may fall
            # back to derated peers (so recovery still works when the whole
            # fleet is derated); a device with no usable peers gets no
            # evidence — like the single-stage case, it cannot be
            # separated from absolute cost-model error.
            others = [
                v for j, v in finite.items()
                if devs[j] != devs[i] and devs[j] not in self.derate
            ]
            if not others and devs[i] in self.derate:
                others = [v for j, v in finite.items() if devs[j] != devs[i]]
            if not others:
                continue
            baseline = float(np.median(others))
            if baseline <= 0:
                continue
            rel = r / baseline
            # channel attribution: the executor times the inter-stage
            # device_put INSIDE the receiving stage's sample, so a degraded
            # link reads as a slow downstream stage.  Split the evidence by
            # the prediction's compute/comm shares — the compute share is
            # device evidence, the comm share is evidence against the
            # INCOMING channel — so correlated two-endpoint drift lands on
            # the connecting channel instead of derating both devices.
            total = self._pred_stage_s[i] if i < len(self._pred_stage_s) else 0.0
            comm = (
                self._pred_stage_comm_s[i]
                if i < len(self._pred_stage_comm_s)
                else 0.0
            )
            chan = (
                self._stage_in_channel[i]
                if i < len(self._stage_in_channel)
                else None
            )
            comm_frac = comm / total if total > 0 else 0.0
            if chan is None or comm_frac <= 0.0:
                cal.add_stage_sample(devs[i], rel, self._stage_classes[i])
            else:
                cal.add_stage_sample(
                    devs[i], rel, self._stage_classes[i], weight=1.0 - comm_frac
                )
                cal.add_channel_sample(chan[0], chan[1], rel, weight=comm_frac)
        ratios = {**cal.device_ratios(), **cal.channel_ratios()}
        new_map = self.policy.observe(ratios)
        # every window mutates control state (streaks, EMAs, window count) —
        # persist now so a restart resumes mid-confirmation, not just after
        # a committed derate
        self._persist_policy()
        replanned = False
        if new_map is not None:
            dev_map = {
                k: v for k, v in new_map.items() if not isinstance(k, tuple)
            }
            link_map = {k: v for k, v in new_map.items() if isinstance(k, tuple)}
            # actively injected faults are ground truth, not inference — a
            # policy commit must not wash them out before their recover event
            for d in self._stall_prev:
                if d in self.derate:
                    dev_map[d] = self.derate[d]
            for c in self._link_fault_prev:
                if c in self.link_derate:
                    link_map[c] = self.link_derate[c]
            if dev_map != self.derate or link_map != self.link_derate:
                self.derate = dev_map
                self.link_derate = link_map
                self._replan_and_rebuild(reason="adaptive derate")
                replanned = True
        return {
            "window": self.policy.windows,
            "ratios": ratios,
            "derate": dict(self.derate),
            "link_derate": dict(self.link_derate),
            "replanned": replanned,
            "stragglers": rep["stragglers"],
        }

    # ------------------------------------------------------------------
    def _predict_stage_times(self) -> List[float]:
        """Simulator-predicted per-stage seconds for the current placement.

        Whole-BATCH time of each stage at the live decode batch: the engine
        decodes all ``slots`` rows in one batched kernel, so each node is
        charged ``batch × compute_time(batch=batch)`` (the batch-aware
        roofline's whole-batch cost) plus the batch's inter-stage activation
        transfer into the stage.  Placement indices are ORIGINAL cluster
        indices (kept so by on_device_failure), so the cost model — rebuilt
        from the derated cluster after every adaptation — stays valid after
        any number of failures, and predictions track the OBSERVED device
        speeds: after a correct derate, a slowed device's obs/pred ratio
        returns to ~1.

        Side effects (consumed by ``observe_window``'s channel
        attribution): ``self._pred_stage_comm_s`` — the comm seconds inside
        each stage's prediction — and ``self._stage_in_channel`` — the
        ``(src, dst)`` ORIGINAL-index endpoints of the inter-stage transfer
        that lands in each stage's wall-clock sample (``StageExecutor``
        times the incoming ``device_put`` inside the RECEIVING stage), or
        ``None`` for the first stage / same-device boundaries."""
        pl = self.placement_result.placement
        batch = self._decode_batch()
        preds: List[float] = []
        comm_preds: List[float] = []
        channels: List[Optional[Tuple[int, int]]] = []
        prev_last: Optional[int] = None
        for st in self.executor.stages:
            t = sum(
                batch * self._cost.compute_time(
                    self.graph.nodes[n], pl[n], batch=batch
                )
                for n in st.node_ids
            )
            c = 0.0
            chan: Optional[Tuple[int, int]] = None
            if prev_last is not None and st.node_ids:
                src, dst = pl[prev_last], pl[st.node_ids[0]]
                c = self._cost.comm_time(
                    self.graph.nodes[prev_last].output_bytes * batch, src, dst
                )
                if src != dst:
                    chan = (src, dst)
            if st.node_ids:
                prev_last = st.node_ids[-1]
            preds.append(t + c)
            comm_preds.append(c)
            channels.append(chan)
        self._pred_stage_comm_s = comm_preds
        self._stage_in_channel = channels
        return preds

    def _predict_prefill_stage_times(self, tokens: int) -> List[float]:
        """Predicted per-stage seconds of ONE ``tokens``-token prefill chunk
        (batch-1 — the chunk forward runs a single slot's row), from the
        same cost model the decode predictions use: each stage node is
        rescaled to the chunk's token count relative to the graph's build
        seq_len (``core.simulate.scale_node_to_tokens``).  The prediction
        anchors attention's quadratic share at a chunk-local KV context
        (one prediction serves every chunk of the prompt; late chunks
        attending a longer cache show up as obs/pred ratio > 1 in the
        report, which is the point of surfacing them).  Feeds the
        ``straggler_report``'s prefill section so prompt work is visible,
        without ever entering the derate calibrator."""
        from repro_torch.core.simulate import prefill_compute_time

        pl = self.placement_result.placement
        s_graph = self.graph.seq_len or self.max_len
        frac = float(tokens) / float(s_graph)
        preds: List[float] = []
        prev_last: Optional[int] = None
        for st in self.executor.stages:
            t = sum(
                prefill_compute_time(
                    self._cost, self.graph.nodes[n], pl[n], tokens, s_graph
                )
                for n in st.node_ids
            )
            if prev_last is not None and st.node_ids:
                t += self._cost.comm_time(
                    self.graph.nodes[prev_last].output_bytes * frac,
                    pl[prev_last],
                    pl[st.node_ids[0]],
                )
            if st.node_ids:
                prev_last = st.node_ids[-1]
            preds.append(t)
        return preds

    def straggler_report(
        self, observed: Optional[List[List[float]]] = None
    ) -> Dict[str, Any]:
        """Compare observed stage times against simulator predictions.

        A stage is a straggler when its observed p95 exceeds
        ``straggler_factor`` × its *expected* p95, where expected = predicted
        stage time × the median of the OTHER stages' observed/predicted
        ratios (leave-one-out: the fleet baseline absorbs the cost model's
        absolute scale error without letting a straggler inflate its own
        baseline — with a plain median a 2-stage pipeline could never flag).
        What is flagged is a stage slow RELATIVE to what the placement says
        it should cost — a stage that legitimately owns more layers is not.

        Args:
            observed: per-stage lists of seconds overriding the executor's
                recorded latencies — used by tests and by external monitors.

        Returns:
            A dict with ``stages`` (per-stage DECODE stats incl.
            ``predicted_s`` and ``obs_over_pred``), ``median_p95``,
            ``median_ratio``, the flagged ``stragglers`` stage indices, and
            a ``prefill`` section (per-stage prefill-forward stats with
            per-chunk predictions when chunking is on) — prompt work is
            visible in the report but never mixed into the decode ratios
            that drive the derate loop.
        """
        if observed is None:
            # whole-run DECODE view: drained window history + not-yet-drained
            # executor samples (observation windows reset the recorders).
            # Prefill forwards are reported separately below — their cost
            # scales with prompt length and must not skew decode ratios.
            observed = [
                list(h) + t
                for h, t in zip(
                    self._observed_history,
                    self.executor.stage_times(kind="decode"),
                )
            ]
        stats = [stats_from_times(times) for times in observed]
        preds = self._pred_stage_s
        for i, s in enumerate(stats):
            # observed may outnumber predictions (e.g. a monitor still holding
            # samples from a pre-failure topology) — those stages get no ratio
            pred = preds[i] if i < len(preds) else 0.0
            s["predicted_s"] = pred
            if s["n"] > 0 and pred > 0:
                s["obs_over_pred"] = s["p95"] / pred
            else:
                s["obs_over_pred"] = float("nan")
        finite = {
            i: s["obs_over_pred"]
            for i, s in enumerate(stats)
            if np.isfinite(s["obs_over_pred"])
        }
        p95s = [s["p95"] for s in stats if s["n"] > 0]
        stragglers = []
        for i, s in enumerate(stats):
            if s["n"] <= 3 or not np.isfinite(s["obs_over_pred"]):
                continue
            others = [r for j, r in finite.items() if j != i]
            baseline = float(np.median(others)) if others else s["obs_over_pred"]
            if baseline > 0 and s["obs_over_pred"] > self.straggler_factor * baseline:
                stragglers.append(i)
        # prefill visibility: per-stage stats of the tagged prefill forwards
        # (whole-run: history + undrained), with per-chunk predictions when
        # chunking is on.  Report-only — the derate loop never sees these.
        pre_obs = [
            list(h) + t
            for h, t in zip(
                self._observed_prefill_history,
                self.executor.stage_times(kind="prefill"),
            )
        ]
        pre_stats = [stats_from_times(times) for times in pre_obs]
        pre_preds = self._pred_prefill_stage_s
        for i, s in enumerate(pre_stats):
            pred = pre_preds[i] if i < len(pre_preds) else 0.0
            s["predicted_s"] = pred
            s["obs_over_pred"] = (
                s["p95"] / pred if s["n"] > 0 and pred > 0 else float("nan")
            )
        return {
            "stages": stats,
            "median_p95": float(np.median(p95s)) if p95s else float("nan"),
            "median_ratio": (
                float(np.median(list(finite.values()))) if finite else float("nan")
            ),
            "stragglers": stragglers,
            "prefill": {
                # None = blocking whole-prompt prefill (no per-chunk preds)
                "chunk": (
                    self.prefill_chunk if self._chunked_prefill_on() else None
                ),
                # fused mode: these stats are the PREFILL SHARE of each
                # fused forward (the executor splits one wall-clock sample
                # into decode/prefill parts by the predicted per-stage
                # fractions), so per-chunk predictions stay comparable and
                # the decode section above stays prompt-burst-proof
                "fused": self._fused_on(),
                "stages": pre_stats,
            },
            # terminal requests pushed out of the bounded unclaimed ring
            # before any drain call collected them — nonzero means results
            # were lost to the cap, not silently (satellite: visible loss)
            "overflow": {"unclaimed_finished": self._unclaimed_overflow},
            # paged-KV pool health and speculative acceptance: always None
            # until those paths are ported (ROADMAP A0, A7)
            "kv": None,
            "speculation": None,
        }
