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
* **paged KV with prefix sharing** (``PlanConfig.kv_page_tokens``): per-stage
  page pools and a host-owned page table (:class:`~.kv_pool.StrictKVPool`);
  shared page-aligned prompt prefixes are reused by reference and their
  prefill chunks skipped, a partially matched page is copied at admission,
  and the table rides into each fused step with one host-to-device copy,
* **speculative draft/target serving** (``draft_cfg``): the per-slot step
  becomes a *variable-advance* step — a second stage pipeline runs the
  draft model (placed JOINTLY with the target over the merged pass-rate
  graph, :mod:`repro_torch.core.spec_plan`), proposes ``spec_tokens``
  greedy tokens per ready slot, and ONE fused target forward verifies
  them as ``q_len=spec_tokens+1`` rows mixed with decode, prefill and idle
  rows; each slot advances by its accepted count + 1, token-identical to
  plain greedy decode (:mod:`repro_torch.models.speculative`).
  Per-request-class acceptance rates are reported in
  ``straggler_report()["speculation"]``,
* **not served here**: an SSM or hybrid model (mamba2, zamba2) raises
  ``NotImplementedError``, and an SSM or hybrid draft ``ValueError``: as
  in the reference, those families are served at the model level only
  (``build_model(cfg).fused_step``, ``speculative.spec_generate``), never
  through the engine's stage executor.

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
from repro_torch.core.costmodel import (
    CostModel,
    DerateCalibrator,
    expected_accepted_tokens,
)
from repro_torch.core.devices import ClusterSpec
from repro_torch.core.modelgraph import transformer_graph
from repro_torch.core.milp import PlacementResult
from repro_torch.core.placement import PlanConfig, plan, replan
from repro_torch.core.spec_plan import merge_spec_graphs, split_spec_placement
from repro_torch.models.speculative import greedy_accept, rolled_back_draft_pos
from .adaptation import AdaptationConfig, AdaptationEvent, DeratePolicy
from .kv_pool import StrictKVPool
from .stage_executor import (
    StageExecutor,
    check_servable,
    stages_from_placement,
    stats_from_times,
)


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
        draft_cfg: attach a DRAFT model and serve speculatively: between
            target steps the draft proposes ``plan_cfg.spec_tokens`` greedy
            tokens per ready slot, ONE fused target forward verifies them
            (``q_len=spec_tokens+1`` rows in the mixed batch), and each
            slot advances by its accepted count + 1 — token-identical to
            plain greedy decode by construction.  Placement is solved
            JOINTLY over the merged draft+target graph
            (:mod:`repro_torch.core.spec_plan`): shared Eq. 5 memory,
            per-device busy summed across both models at the plan's
            ``acceptance_rate``.  Requires the fused ragged path and
            ``draft_params``; incompatible with ``placement_result``; a
            dense or MoE draft only.
        draft_params: the draft model's parameters (placed onto the draft
            stages' devices at build; tensors already there are shared,
            not copied).
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
        check_servable(cfg)
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

        # paged KV cache (PlanConfig.kv_page_tokens): fixed-size page pools
        # per stage device + a host-owned per-slot page table (KVPool), with
        # optional hash-based prefix sharing.  Paged serving rides the fused
        # ragged path — every KV write is span-masked through the table, so
        # the legacy full-row gather/scatter paths never see pools
        self.kv_page_tokens = getattr(self.plan_cfg, "kv_page_tokens", None)
        self.prefix_sharing = bool(
            getattr(self.plan_cfg, "prefix_sharing", True)
        )
        if self.kv_page_tokens is not None:
            self.kv_page_tokens = int(self.kv_page_tokens)
            if self.kv_page_tokens <= 0:
                raise ValueError(
                    f"kv_page_tokens must be positive, got {self.kv_page_tokens}"
                )
            if not (self.batching == "ragged" and self.prefill_chunk and self.fused):
                raise ValueError(
                    "paged KV (kv_page_tokens) requires ragged batching with "
                    "chunked + fused prefill"
                )
        # prefill chunks a shared-prefix hit let admission skip (whole run)
        self.prefill_chunks_skipped = 0

        # speculative decoding (variable-advance steps): a draft model
        # proposes plan_cfg.spec_tokens greedy tokens per ready slot between
        # target steps; ONE fused target forward verifies them as q_len=k+1
        # rows and each slot advances by its accepted count + the bonus
        # token.  Spec rides the fused ragged path — the verify row IS a
        # mixed-batch row with a bigger q_len — so it requires it.
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        if draft_cfg is not None:
            if draft_params is None:
                raise ValueError("speculative serving needs draft_params")
            if not (self.batching == "ragged" and self.prefill_chunk and self.fused):
                raise ValueError(
                    "speculative serving (draft_cfg) requires ragged "
                    "batching with chunked + fused prefill"
                )
            if draft_cfg.family not in ("dense", "moe"):
                # the stage executor serves attention-family blocks only
                # (the same constraint the target is under); SSM/hybrid
                # drafts work at the model level (spec_generate) and in
                # joint planning, not behind the executor
                raise ValueError(
                    f"speculative serving needs a dense/moe draft; "
                    f"got family {draft_cfg.family!r}"
                )
            if int(getattr(self.plan_cfg, "spec_tokens", 0) or 0) < 1:
                # a draft without an explicit k gets the conventional 4
                self.plan_cfg = dataclasses.replace(self.plan_cfg, spec_tokens=4)
        self.spec_tokens = (
            int(self.plan_cfg.spec_tokens) if draft_cfg is not None else 0
        )
        # per-request-class acceptance tracking (class = Request.tier when
        # the router stamped one, else "default"); survives rebuilds —
        # it reports the workload, not one executor's lifetime
        self._spec_stats: Dict[str, Dict[str, int]] = {}
        # injection point: ``(req, proposals) -> proposals`` replaces a spec
        # row's k proposals AFTER the draft forwards ran (their cost stays
        # charged).  Verification is oblivious to where proposals came
        # from, so token identity is preserved for ANY hook — a benchmark
        # uses it to pin the acceptance rate with an oracle draft
        self._proposal_hook = None

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
        # joint draft+target planning: ONE merged pass-rate-annotated graph
        # (core.spec_plan) goes through the same plan()/replan() envelope,
        # so Eq. 5 memory is shared and the throughput objective sums both
        # models' decode busy per device — the draft lands on devices the
        # target leaves idle, which is the point of speculation on a
        # heterogeneous cluster
        self._draft_graph = None
        self._spec_merged = None
        self._spec_result: Optional[PlacementResult] = None
        self._draft_placement: Optional[Dict[int, int]] = None
        if draft_cfg is not None:
            self._draft_graph = transformer_graph(
                draft_cfg, seq_len=max_len, granularity="block"
            )
            self._spec_merged, self._spec_tmap, self._spec_dmap = (
                merge_spec_graphs(
                    self.graph,
                    self._draft_graph,
                    spec_tokens=self.spec_tokens,
                    acceptance_rate=float(
                        getattr(self.plan_cfg, "acceptance_rate", 0.75)
                    ),
                )
            )
        self._cost = self._make_cost()
        if placement_result is not None:
            # a pre-solved plan (the router hands each replica its slice of
            # the service plan, in THIS engine's cluster indices) — must
            # cover the same block graph this engine builds at max_len
            if draft_cfg is not None:
                raise ValueError(
                    "placement_result cannot be combined with draft_cfg: "
                    "pre-solved plans do not cover the draft graph (plan "
                    "jointly with core.spec_plan.plan_speculative instead)"
                )
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
        """Solve THE placement problem this engine serves: the target graph
        alone, or — in speculative mode — the merged draft+target graph,
        whose result is split back into the target projection (stored as
        :attr:`placement_result`, what every stage/cost path consumes) and
        the draft projection (:attr:`_draft_placement`).  One path shared by
        startup and every failure/derate replan, so a hot-swap re-solves the
        JOINT problem, never the target alone."""
        graph = self._spec_merged if self._spec_merged is not None else self.graph
        if self.failed_devices or self.derate or self.link_derate:
            res = replan(
                graph, self.cluster, self.failed_devices, self.plan_cfg,
                derate=self.derate, link_derate=self.link_derate,
            )
        else:
            res = plan(graph, self.cluster, self.plan_cfg)
        if self._spec_merged is not None:
            tgt, dft = split_spec_placement(
                res.placement, self._spec_tmap, self._spec_dmap
            )
            self._spec_result = res
            self._draft_placement = dft
            res = dataclasses.replace(res, placement=tgt)
        return res

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
        # speculative mode: the draft runs as a SECOND stage pipeline over
        # the jointly planned draft placement, with its own dense per-slot
        # caches (the draft never pages — its rows are cheap and its
        # rollback is the same overwrite-before-read argument as the
        # target's).  Both pipelines launch on the current stream of each
        # card, one after the other, so the grouped GEMM's per-card scratch
        # (kernels/grouped_gemm.py) is never used by two calls at once.
        # Draft progress dies with the old topology too.
        self._draft_executor = None
        self._draft_caches = None
        self._draft_pos = np.zeros(self.slots, dtype=np.int64)
        if self._draft_graph is not None:
            dstages = stages_from_placement(
                self._draft_graph,
                self._executor_placement(self._draft_placement),
                self.devices,
                self.draft_cfg.n_layers,
            )
            self._draft_executor = StageExecutor(
                self.draft_cfg, self.draft_params, dstages
            )
        # per-slot KV write ceiling for speculative rounds: dense rows allow
        # the full max_len; paged slots may only write inside their mapped
        # pages (set at admission to the sequence's allocated head)
        self._slot_cap = np.full(self.slots, self.max_len, dtype=np.int64)
        # ...and so is any mid-prefill progress: the chunks written so far
        # lived in the old executor's cache rows
        self._prefill_toks: Dict[int, List[int]] = {}
        self._prefill_done: Dict[int, int] = {}
        self._prefill_rr = 0
        # ...and so is the page pool: every mapping pointed into the old
        # executor's device pools (re-prefill repopulates — and re-registers
        # shared prefixes — from scratch).  The port's pool admits exactly
        # what it can map (StrictKVPool, ROADMAP C).
        self._kv_pool = (
            StrictKVPool(
                self.slots,
                self.max_len,
                self.kv_page_tokens,
                prefix_sharing=self.prefix_sharing,
            )
            if self.kv_page_tokens is not None
            else None
        )
        # the table's host buffer: pinned when a stage is on a card, so the
        # one host-to-device copy per step is asynchronous
        self._table_host = None
        if self._kv_pool is not None:
            self._table_host = torch.empty(
                self._kv_pool.table.shape, dtype=torch.int32,
                pin_memory=any(
                    torch.device(st.device).type == "cuda" for st in stages
                ),
            )
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
        # in speculative mode the residency check covers BOTH models: the
        # merged graph with the merged placement, so one admission decision
        # accounts for target KV + draft params + draft KV on shared devices
        if self._spec_result is not None:
            mem_graph, mem_place = self._spec_merged, self._spec_result.placement
        else:
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
                # paged: the sequence's pages (net of reusable shared-prefix
                # pages) must be obtainable from the pool — free now or
                # LRU-evictable — on top of the planner-level Eq. 5 check.
                # Speculative rounds write up to spec_tokens+1 provisional
                # positions past the committed depth before rollback, so the
                # allocation reserves that headroom — a slot near its cap
                # falls back to plain decode (see _step_fused) rather than
                # write into unmapped pages
                total_head = min(
                    len(head.prompt) + int(head.max_new_tokens)
                    + (self.spec_tokens + 1 if self.spec_tokens else 0),
                    self.max_len,
                )
                pool_ok = self._kv_pool is None or self._kv_pool.can_admit(
                    toks_head, total_head
                )
                if (n_active > 0 and not self._admission_ok(n_active + 1)) or (
                    n_active > 0 and not pool_ok
                ):
                    # one more resident KV copy would overflow a planned
                    # device (or the page pool). (With zero active requests we
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
                was_started = req.started
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
                    reuse = 0
                    if self._kv_pool is not None:
                        # map pages; shared-prefix hits skip their prefill
                        # chunks (reuse), a partially matched page is COW'd
                        # on-device before any write can land in it
                        try:
                            reuse, copies = self._kv_pool.alloc_sequence(
                                slot, toks_list, total_head
                            )
                        except RuntimeError:
                            # the pool rolled the mapping back: the request
                            # goes back to the queue front, its slot freed
                            # (the reference loses it from `active` here)
                            self.active[slot] = None
                            req.started = was_started
                            self.queue.insert(qi, req)
                            break
                        if copies:
                            self.caches = self.executor.copy_pages(
                                self.caches, copies
                            )
                        n, c = len(toks_list), self.prefill_chunk
                        self.prefill_chunks_skipped += (n + c - 1) // c - (
                            n - reuse + c - 1
                        ) // c
                    self._prefill_toks[slot] = toks_list
                    self._prefill_done[slot] = reuse
                    self.slot_pos[slot] = reuse
                    # new tenant: the draft re-prefills this slot's stream
                    # from token 0 (old rows are garbage it overwrites), and
                    # spec writes must stay inside the mapped pages
                    self._draft_pos[slot] = 0
                    self._slot_cap[slot] = (
                        total_head if self._kv_pool is not None else self.max_len
                    )
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
        """Lazily allocate device caches: paged pools (+ trash page) when a
        KV pool is configured, dense ``(slots, max_len)`` rows otherwise."""
        if self.caches is not None:
            return
        if self._kv_pool is not None:
            self.caches = self.executor.init_paged_caches(
                self._kv_pool.num_pages, self._kv_pool.page_tokens
            )
        else:
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
            self._draft_pos[slot] = 0
            self._slot_cap[slot] = self.max_len
            if self._kv_pool is not None:
                # deref the slot's pages; registered prefix pages park in
                # the LRU ring for future sharers, private pages free
                self._kv_pool.free_slot(slot)
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

    def _page_table(self) -> Optional[torch.Tensor]:
        """This step's page table (trash-clamped) in the host buffer, or
        None for dense rows; the executor copies it to each stage's device
        once."""
        if self._kv_pool is None:
            return None
        self._table_host.copy_(torch.from_numpy(self._kv_pool.table_array()))
        return self._table_host

    def _step_fused(self) -> int:
        """One FUSED engine iteration: decode-ready slots, mid-prefill
        slots, and idle slots ride one ``[slots, S]`` forward with per-row
        ``(cache_pos, q_len)`` — S is ``prefill_chunk`` when any prefill is
        pending, else 1 (two compiled shapes total).  Decode rows carry
        ``q_len=1`` at their decode depth, prefill rows their chunk at its
        offset, idle rows ``q_len=0`` (they write NOTHING — unlike the
        legacy path's garbage rows).  Every mid-prefill slot advances every
        step, and the slot cache rows are written in place (no
        ``_slot_row_caches`` gather / ``_write_slot_cache`` scatter).

        With a draft (``draft_cfg``) this is the SPECULATIVE, variable-advance
        step: :meth:`_draft_phase` first proposes ``d_1..d_k`` for every
        spec-ready slot, and those slots ride the same forward as verify rows
        (``q_len=k+1``: the pending token + the k proposals at the slot's
        depth), so S is ``k+1`` when no prefill is pending.  Slots whose
        draft is still catching up, or whose cache cannot hold ``k+1``
        provisional writes, stay plain decode rows.  Each verify row advances
        by ``accepted+1`` tokens
        (:func:`~repro_torch.models.speculative.greedy_accept` —
        token-identical to plain greedy by construction); rejected positions
        leave garbage KV that the overwrite-before-read argument retires
        (see :mod:`repro_torch.models.speculative`), and the draft rolls
        back by bookkeeping only
        (:func:`~repro_torch.models.speculative.rolled_back_draft_pos`)."""
        idx = [
            i for i, r in enumerate(self.active)
            if r is not None and i not in self._prefill_toks
        ]
        pf_slots = sorted(self._prefill_toks)
        if not idx and not pf_slots:
            return 0
        self._ensure_caches()
        k = self.spec_tokens
        proposals, committed = self._draft_phase(idx) if self._spec_on() else ({}, {})
        dec_rows = [i for i in idx if i not in proposals]
        s = self.prefill_chunk if pf_slots else 1
        if proposals:
            s = max(s, k + 1)
        tokens = np.zeros((self.slots, s), dtype=np.int32)
        q_lens = np.zeros(self.slots, dtype=np.int32)
        cache_pos = np.zeros(self.slots, dtype=np.int32)
        for i in idx:
            tokens[i, 0] = self.active[i].out_tokens[-1]
            q_lens[i] = 1
            cache_pos[i] = self.slot_pos[i]
        for i, props in proposals.items():
            tokens[i, 1 : k + 1] = props
            q_lens[i] = k + 1
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
            page_table=self._page_table(),
        )
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()   # [slots, S]
        for i in dec_rows:
            req = self.active[i]
            req.out_tokens.append(int(nxt[i, 0]))
            self.slot_pos[i] += 1
            self._maybe_retire(i, int(nxt[i, 0]))
        for i, props in proposals.items():
            req = self.active[i]
            # preds[t] = the target's greedy token after the pending token
            # plus d_1..d_t — row t of the verify span
            preds = [int(nxt[i, t]) for t in range(k + 1)]
            accepted, emitted = greedy_accept(props, preds)
            self._record_acceptance(req, proposed=k, accepted=accepted)
            # draft rollback is bookkeeping: keep the accepted prefix of
            # the proposals it already fed itself
            self._draft_pos[i] = rolled_back_draft_pos(committed[i], accepted, k)
            # variable advance, one token at a time: EOS / budget /
            # capacity truncate the round exactly where plain greedy
            # decoding would have stopped
            for tok in emitted:
                req.out_tokens.append(tok)
                self.slot_pos[i] += 1
                if self._maybe_retire(i, tok):
                    break
        for i in pf_slots:
            n = pf_n[i]
            done = self._prefill_done[i] + n
            self._prefill_done[i] = done
            self.slot_pos[i] = done
            if done == len(self._prefill_toks[i]):
                del self._prefill_toks[i]
                del self._prefill_done[i]
                req = self.active[i]
                if self._kv_pool is not None:
                    # prompt KV is resident: register its page-aligned
                    # prefix so later requests can share it (BEFORE any
                    # retirement — the pages then park in the LRU, reusable)
                    self._kv_pool.commit_prefix(i, req.prompt)
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

    # ------------------------------------------------------------------
    # speculative decoding: variable-advance fused steps
    # ------------------------------------------------------------------
    def _spec_on(self) -> bool:
        """Speculative stepping is active when a draft pipeline was built
        (``draft_cfg`` given; requires the fused ragged path)."""
        return self._draft_executor is not None

    def _ensure_draft_caches(self):
        """Dense ``(slots, max_len)`` draft caches on the draft stages'
        devices — the draft never pages (see ``_build_executor``)."""
        if self._draft_caches is None:
            self._draft_caches = self._draft_executor.init_caches(
                self.slots, self.max_len
            )

    def _record_acceptance(self, req: Request, *, proposed: int, accepted: int):
        """Accumulate one verify round into the per-request-class
        acceptance counters (class = ``tier<t>`` when the router stamped
        :attr:`Request.tier`, else ``"default"``)."""
        tier = getattr(req, "tier", None)
        cls = "default" if tier is None else f"tier{int(tier)}"
        rec = self._spec_stats.setdefault(
            cls, {"rounds": 0, "proposed": 0, "accepted": 0, "emitted": 0}
        )
        rec["rounds"] += 1
        rec["proposed"] += proposed
        rec["accepted"] += accepted
        rec["emitted"] += accepted + 1

    def speculation_report(self) -> Dict[str, Any]:
        """Observed speculative-decoding summary: per-request-class
        acceptance rates and tokens/round next to the planner's assumed
        ``acceptance_rate`` / expected tokens per round — drift between the
        two is the signal to re-plan with a calibrated rate."""
        a_planned = float(getattr(self.plan_cfg, "acceptance_rate", 0.75))
        classes: Dict[str, Dict[str, float]] = {}
        for cls, rec in sorted(self._spec_stats.items()):
            out: Dict[str, float] = dict(rec)
            out["acceptance_rate"] = (
                rec["accepted"] / rec["proposed"] if rec["proposed"] else 0.0
            )
            out["tokens_per_round"] = (
                rec["emitted"] / rec["rounds"] if rec["rounds"] else 0.0
            )
            classes[cls] = out
        return {
            "spec_tokens": self.spec_tokens,
            "planned_acceptance_rate": a_planned,
            "planned_tokens_per_round": expected_accepted_tokens(
                a_planned, self.spec_tokens
            ),
            "classes": classes,
        }

    def _draft_phase(
        self, idx: List[int]
    ) -> Tuple[Dict[int, List[int]], Dict[int, int]]:
        """The draft's half of a speculative step (between target steps):
        one ragged catch-up forward of ``[slots, max(prefill_chunk, 2)]``
        feeds every slot's draft the committed tokens it has not seen yet
        (mid-prefill slots' drafts prefill CONCURRENTLY with the target's
        chunked prefill), producing the first proposal ``d_1`` for every
        spec-ready row; ``k-1`` forwards of ``[slots, 1]`` then extend each
        row's proposal chain to ``d_1..d_k``.  Returns the proposals of each
        spec-ready slot of ``idx`` (the decode-ready slots) and its committed
        length (prompt + output) at the start of the round."""
        k = self.spec_tokens
        self._ensure_draft_caches()
        # catch-up width: covers the steady-state 1–2 token lag after a
        # round (bonus, or rejected tail + bonus) and lets a fresh slot's
        # draft prefill ride at the target's chunk pace
        s0 = max(self.prefill_chunk, 2)
        commit: Dict[int, List[int]] = {}
        spec_rows: List[int] = []
        for i in idx:
            req = self.active[i]
            commit[i] = list(req.prompt) + list(req.out_tokens)
            behind = len(commit[i]) - int(self._draft_pos[i])
            if behind <= s0 and int(self.slot_pos[i]) + k + 1 <= int(
                self._slot_cap[i]
            ):
                spec_rows.append(i)
        d_toks = np.zeros((self.slots, s0), dtype=np.int32)
        d_qlens = np.zeros(self.slots, dtype=np.int32)
        d_pos = np.zeros(self.slots, dtype=np.int32)
        feed_n: Dict[int, int] = {}
        for i in range(self.slots):
            if i in self._prefill_toks:
                stream = self._prefill_toks[i]
            elif self.active[i] is not None:
                stream = commit[i]
            else:
                continue
            dp = int(self._draft_pos[i])
            n = min(s0, len(stream) - dp)
            if n <= 0:
                continue
            d_toks[i, :n] = stream[dp : dp + n]
            d_qlens[i] = n
            d_pos[i] = dp
            feed_n[i] = n
        proposals: Dict[int, List[int]] = {}
        if feed_n:
            logits0, self._draft_caches = self._draft_executor.forward(
                torch.from_numpy(d_toks),
                self._draft_caches,
                cache_pos=d_pos,
                kind="fused",
                q_lens=torch.from_numpy(d_qlens),
            )
            nxt0 = torch.argmax(logits0, dim=-1).cpu().numpy()
            for i, n in feed_n.items():
                self._draft_pos[i] += n
                if i in spec_rows:
                    # the last fed row (the pending token) predicts d_1
                    proposals[i] = [int(nxt0[i, n - 1])]
        # a spec-ready row always has backlog >= 1 (the pending token is
        # never fed ahead of its round), so it always drafted above — the
        # filter is pure defensive hygiene
        spec_rows = [i for i in spec_rows if i in proposals]
        for _ in range(1, k):
            if not spec_rows:
                break
            p_toks = np.zeros((self.slots, 1), dtype=np.int32)
            p_q = np.zeros(self.slots, dtype=np.int32)
            p_pos = np.zeros(self.slots, dtype=np.int32)
            for i in spec_rows:
                p_toks[i, 0] = proposals[i][-1]
                p_q[i] = 1
                # feed the newest proposal at the draft's frontier:
                # committed length + proposals already fed
                p_pos[i] = int(self._draft_pos[i]) + len(proposals[i]) - 1
            logits1, self._draft_caches = self._draft_executor.forward(
                torch.from_numpy(p_toks),
                self._draft_caches,
                cache_pos=p_pos,
                kind="fused",
                q_lens=torch.from_numpy(p_q),
            )
            nxt1 = torch.argmax(logits1, dim=-1).cpu().numpy()
            for i in spec_rows:
                proposals[i].append(int(nxt1[i, 0]))
        if self._proposal_hook is not None:
            for i in spec_rows:
                hooked = list(self._proposal_hook(self.active[i], proposals[i]))
                assert len(hooked) == k, "proposal hook must keep length k"
                proposals[i] = [int(t) for t in hooked]
        return (
            {i: proposals[i] for i in spec_rows},
            {i: len(commit[i]) for i in spec_rows},
        )

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

    def release_caches(self) -> None:
        """Drop the KV caches (the draft's too) from the devices: a retired
        replica serves nothing more, and a replacement spawned on the same
        card needs the memory.  Host state (requests, logs, pool counters,
        health) stays for the reports; the engine is not stepped again."""
        self.caches = None
        self._draft_caches = None

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
        # the draft's progress lived in the old topology's caches too —
        # every re-admitted stream re-prefills the draft from token 0
        self._draft_pos = np.zeros(self.slots, dtype=np.int64)
        self._prefill_toks = {}
        self._prefill_done = {}
        self.queue[:0] = pending

    def _replan_and_rebuild(self, reason: str):
        """Re-plan on the observed cluster (minus failures, with device AND
        channel derates) and hot-swap the executor; one path shared by
        failure handling, fault injection, and the adaptation loop.  In
        speculative mode the re-solve covers the merged draft+target
        problem, so a failure under the draft re-places it jointly."""
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
            # paged-KV pool health (None when serving dense rows): page
            # residency plus the sharing counters — prefix hits, COW
            # copies, LRU evictions — so cache behavior is operator-visible
            "kv": (
                self._kv_pool.stats() if self._kv_pool is not None else None
            ),
            # speculative decoding (None when no draft is attached):
            # per-request-class observed acceptance vs the planner's assumed
            # rate — see speculation_report()
            "speculation": (
                self.speculation_report() if self._spec_on() else None
            ),
        }
