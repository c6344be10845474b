"""Cost model: per-(op, device) processing time and data-flow transfer time.

Paper §III-C "Input profiling": Moirai needs p_ik (compute time of op i on
device k) and p^comm_{q,k',k''} (transfer time of flow q over channel k'→k'').
The paper estimates compute time with a learned predictor (Habitat [41]); in
this container there is no GPU to profile, so we use a calibrated roofline
estimator — time = max(flops / (peak·eff), bytes / hbm_bw) + fixed dispatch
overhead — which is the same family of model Habitat interpolates, and the
estimator can be *re-calibrated* from real ``compiled.cost_analysis()``
numbers via :func:`calibrate_from_cost_analysis` (see launch/roofline.py).

The dispatch overhead term matters: it is what makes operator fusion a win
for short ops (paper Fig. 4: most ops are microseconds).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

import numpy as np

from .devices import ClusterSpec, DeviceSpec
from .graph import AugmentedDAG, OpGraph, OpNode

# MXU/TensorCore-utilization efficiency by op class: matmuls approach peak,
# elementwise ops are bandwidth-bound (handled by the bytes term), irregular
# ops (softmax/sort) fall in between.
DEFAULT_EFFICIENCY: Dict[str, float] = {
    "matmul": 0.70,
    "conv": 0.55,
    "einsum": 0.65,
    "ssd": 0.45,
    "scan": 0.30,
    "softmax": 0.25,
    "default": 0.30,
}

DEFAULT_DISPATCH_OVERHEAD_S = 3e-6  # per-kernel launch overhead

# Fraction of an op class's HBM traffic that is BATCH-INVARIANT (weights /
# routing tables streamed once per batched step, not once per request).
# Used by the batch-aware roofline when a node carries no ``param_bytes``
# split (e.g. serial supernode members): batching a decode step multiplies
# flops and activation bytes by the batch size but streams the invariant
# bytes once, bending arithmetic intensity upward — the reason continuous
# batching raises throughput on memory-bound decode in the first place.
# Values calibrated from compiled cost_analysis() byte counts at batch
# widths 1/2/4/8 (``python -m repro_torch.launch.calibrate_invariant``): the
# classes whose decode traffic is per-request KV/state (attention einsums,
# SSD state updates, scans) fit to ~0 invariant share — only weight-
# carrying classes amortize under batching.
DEFAULT_BATCH_INVARIANT_FRAC: Dict[str, float] = {
    "matmul": 0.99,     # decode GEMVs: weight-dominated traffic (fit 0.998)
    "conv": 0.15,       # depthwise conv weight is tiny vs per-request state
    "einsum": 0.0,      # attention einsums: KV streams per request
    "ssd": 0.0,         # chunked state update: per-request state dominates
    "scan": 0.0,        # associative state scans are pure per-request
    "softmax": 0.0,     # pure activation traffic
    "default": 0.50,    # unmeasured op classes keep the agnostic prior
}


def expected_accepted_tokens(acceptance_rate: float, spec_tokens: int) -> float:
    """Expected tokens committed per speculative verify round.

    With per-token acceptance probability ``a`` and ``k`` draft tokens, the
    round commits the longest accepted prefix plus the target's bonus
    token: ``E = sum_{i=0..k} a^i = (1 - a^{k+1}) / (1 - a)`` (``k+1``
    exactly at ``a = 1``, ``1`` at ``a = 0`` — plain decode never commits
    less).  This is the acceptance-rate parameterization the joint
    draft+target planner scores with: the target graph runs ``1/E`` verify
    forwards per committed token, the draft ``k/E`` proposal forwards."""
    k = max(int(spec_tokens), 0)
    a = min(max(float(acceptance_rate), 0.0), 1.0)
    if k == 0:
        return 1.0
    if a >= 1.0:
        return float(k + 1)
    return float((1.0 - a ** (k + 1)) / (1.0 - a))


def calibrate_invariant_frac(
    bytes_by_batch: Mapping[str, Mapping[int, float]],
    base: Optional[Mapping[str, float]] = None,
) -> Dict[str, float]:
    """Per-op-class batch-invariant traffic fractions from profiled bytes.

    ``bytes_by_batch``: op class → {batch size → HBM bytes accessed by one
    batched step at that width} (two or more widths), e.g. from compiled
    ``cost_analysis`` dumps (``launch.calibrate_invariant`` collects them).
    A linear traffic model ``bytes(B) = invariant + B · per_request`` is
    least-squares fit per class; the returned fraction is
    ``invariant / bytes(1)`` clipped to [0, 1] — exactly the
    :data:`DEFAULT_BATCH_INVARIANT_FRAC` semantics.  Classes with fewer
    than two widths (or a degenerate fit) keep their ``base`` value."""
    out = dict(base or DEFAULT_BATCH_INVARIANT_FRAC)
    for cls, pts in bytes_by_batch.items():
        if len(pts) < 2:
            continue
        bs = np.asarray(sorted(pts), dtype=np.float64)
        ys = np.asarray([pts[int(b)] for b in bs], dtype=np.float64)
        slope, inv = np.polyfit(bs, ys, 1)
        b1 = inv + slope  # fitted bytes at batch 1
        if b1 <= 0:
            continue
        out[cls] = float(np.clip(inv / b1, 0.0, 1.0))
    return out


def paged_kv_factor(
    page_tokens: Optional[int],
    seq_tokens: Optional[int],
    residency: float = 1.0,
) -> float:
    """Ratio of paged to dense per-slot KV residency under Eq. 5.

    A dense slot charges ``seq_tokens`` (S) cache entries; a paged slot
    charges whole pages for the tokens it is *expected* to hold —
    ``ceil(residency · S / P)`` pages of ``P`` tokens (at least one page:
    an admitted sequence always maps its first page).  The factor is the
    multiplier on ``node.kv_bytes`` (which is sized for S tokens):

        factor = ceil(max(residency, eps) · S / P) · P / S

    Exactly 1.0 when paging is off (``page_tokens`` or ``seq_tokens`` is
    None) and when ``P = S`` at ``residency = 1.0`` — the collapse-to-dense
    regression pin.  ``residency < 1`` is the configurable expected-residency
    estimate (typical prompt+generation length as a fraction of max_len);
    prefix sharing reduces true residency further, but the planner charges
    un-shared pages — sharing is headroom, not a promise."""
    if page_tokens is None or seq_tokens is None:
        return 1.0
    P, S = int(page_tokens), int(seq_tokens)
    if P <= 0 or S <= 0:
        return 1.0
    r = min(max(float(residency), 0.0), 1.0)
    pages = max(-(-int(np.ceil(r * S - 1e-9)) // P), 1)
    return pages * P / S


@dataclass
class CostModel:
    """Per-(op, device) compute time, per-flow transfer time, and Eq. 5
    memory accounting for one :class:`ClusterSpec`.

    Compute time is a calibrated roofline — ``max(flops/(peak·eff),
    bytes/hbm_bw) + dispatch overhead`` — with per-op-class efficiencies
    (``efficiency``), an optional multiplicative per-device calibration
    (``device_scale``), and the cluster's widest-path channel model for
    communication.  ``compute_time(..., batch=n)`` gives the **batch-aware**
    per-request cost: flops and activation bytes scale with the decode
    batch while batch-invariant weight traffic is streamed once
    (``batch_invariant_frac`` per op class, or the node's own
    ``param_bytes``), bending arithmetic intensity the way continuous
    batching actually does.  Build one per cluster *as observed*: the
    serving engine's adaptation loop rebuilds its model from
    ``cluster.with_derate(...)`` so predictions track measured speeds."""

    cluster: ClusterSpec
    efficiency: Mapping[str, float] = field(default_factory=lambda: dict(DEFAULT_EFFICIENCY))
    dispatch_overhead_s: float = DEFAULT_DISPATCH_OVERHEAD_S
    # multiplicative per-device calibration (from profiling real lowerings)
    device_scale: Optional[np.ndarray] = None
    # per-op-class share of HBM traffic streamed once per batched decode
    # step (weights) rather than once per request — the batch-aware roofline
    batch_invariant_frac: Mapping[str, float] = field(
        default_factory=lambda: dict(DEFAULT_BATCH_INVARIANT_FRAC)
    )
    # paged-KV accounting (Eq. 5 page term): with kv_page_tokens set, the KV
    # term per slot charges ceil(residency · S / P) · P tokens — pages
    # actually resident under the expected-residency estimate — instead of
    # the dense max_len row.  kv_seq_tokens is the graph's per-slot token
    # capacity S (node.kv_bytes is sized for S tokens); kv_residency is the
    # expected fill fraction of a slot's row (1.0 = worst case; pinned so
    # page_tokens = S at residency 1.0 reproduces dense numbers exactly)
    kv_page_tokens: Optional[int] = None
    kv_residency: float = 1.0
    kv_seq_tokens: Optional[int] = None

    def __post_init__(self):
        if self.device_scale is None:
            self.device_scale = np.ones(self.cluster.k)

    # ------------------------------------------------------------- compute
    def _eff(self, op_type: str) -> float:
        # a fused op "a∘b∘c" uses the max-efficiency member as the anchor
        # (the dominant-cost member is the matmul/conv when present)
        parts = op_type.split("∘")
        effs = [self.efficiency.get(p, self.efficiency["default"]) for p in parts]
        return max(effs)

    def _batch_invariant_frac(self, op_type: str) -> float:
        parts = op_type.split("∘")
        fracs = [
            self.batch_invariant_frac.get(
                p, self.batch_invariant_frac["default"]
            )
            for p in parts
        ]
        return max(fracs)

    def _roofline(
        self,
        flops: float,
        nbytes: float,
        op_type: str,
        dev: DeviceSpec,
        batch: int,
        param_bytes: Optional[float] = None,
    ) -> float:
        """Per-REQUEST roofline seconds of one op at decode batch ``batch``.

        ``batch == 1`` reproduces the classic single-request roofline
        bit-for-bit.  At ``batch > 1`` flops and activation bytes scale with
        the batch while batch-invariant bytes (weights — ``param_bytes``
        when the node carries the split, else the per-op-class
        :data:`DEFAULT_BATCH_INVARIANT_FRAC` share) are streamed once; the
        whole-batch time is then amortized over the batch.  Monotone: the
        per-request time never increases with batch size, and saturates at
        the flops roof (arithmetic intensity stops helping once the op
        turns compute-bound)."""
        eff = self._eff(op_type)
        if batch <= 1:
            t_f = flops / (dev.peak_flops * eff) if flops else 0.0
            t_b = nbytes / dev.hbm_bw if nbytes else 0.0
            return max(t_f, t_b) + self.dispatch_overhead_s
        if param_bytes is not None and param_bytes > 0:
            inv = min(float(param_bytes), nbytes)
        else:
            inv = nbytes * self._batch_invariant_frac(op_type)
        act = max(nbytes - inv, 0.0)
        t_f = batch * flops / (dev.peak_flops * eff) if flops else 0.0
        t_b = (inv + batch * act) / dev.hbm_bw if nbytes else 0.0
        return (max(t_f, t_b) + self.dispatch_overhead_s) / batch

    def compute_time(
        self, node: OpNode, device_idx: int, *, batch: int = 1
    ) -> float:
        """p_ik — processing time of ``node`` on device ``device_idx`` (s).

        ``batch`` is the decode batch size (concurrently decoded serving
        slots): the returned value is the amortized per-request time, with
        batch-invariant weight traffic streamed once per batched step (the
        batch-aware roofline — see :meth:`_roofline`).  ``batch=1`` is the
        paper's single-request cost."""
        dev = self.cluster.devices[device_idx]
        serial = node.meta.get("serial") if node.meta else None
        if serial:
            # hierarchy supernode: members execute sequentially (NOT fused) —
            # the serial sum of per-member roofline maxima
            t = 0.0
            for flops, nbytes, op_type in serial:
                t += self._roofline(flops, nbytes, op_type, dev, batch)
            return t * float(self.device_scale[device_idx])
        t = self._roofline(
            node.flops, node.bytes_accessed, node.op_type, dev, batch,
            param_bytes=node.param_bytes,
        )
        return t * float(self.device_scale[device_idx])

    def marginal_compute_time(self, node: OpNode, device_idx: int) -> float:
        """Marginal seconds of adding ``node``'s work to a kernel launch
        that is ALREADY running on this device — the fused mixed-batch cost
        of a prefill-chunk row riding the batched decode forward.

        Two terms of the full roofline vanish at the margin: the
        batch-invariant weight traffic (the decode pass sharing the launch
        streams the weights regardless) and the dispatch overhead (one
        launch per step, already charged to decode).  What remains is the
        row's own flops against the compute roof and its activation bytes
        against HBM."""
        dev = self.cluster.devices[device_idx]
        serial = node.meta.get("serial") if node.meta else None
        if serial:
            t = 0.0
            for flops, nbytes, op_type in serial:
                act = max(nbytes * (1.0 - self._batch_invariant_frac(op_type)), 0.0)
                t_f = flops / (dev.peak_flops * self._eff(op_type)) if flops else 0.0
                t += max(t_f, act / dev.hbm_bw)
            return t * float(self.device_scale[device_idx])
        nbytes = node.bytes_accessed
        if node.param_bytes is not None and node.param_bytes > 0:
            inv = min(float(node.param_bytes), nbytes)
        else:
            inv = nbytes * self._batch_invariant_frac(node.op_type)
        act = max(nbytes - inv, 0.0)
        t_f = (
            node.flops / (dev.peak_flops * self._eff(node.op_type))
            if node.flops
            else 0.0
        )
        t_b = act / dev.hbm_bw if act else 0.0
        return max(t_f, t_b) * float(self.device_scale[device_idx])

    def compute_matrix(self, graph: OpGraph) -> Dict[int, np.ndarray]:
        """p_ik for all ops: node id -> [K] array of seconds."""
        return {
            nid: np.array(
                [self.compute_time(n, k) for k in range(self.cluster.k)]
            )
            for nid, n in graph.nodes.items()
        }

    # ---------------------------------------------------------------- comm
    def comm_time(self, nbytes: float, src_dev: int, dst_dev: int) -> float:
        """p^comm over the (src,dst) channel; 0 on the same device."""
        return self.cluster.comm_time(nbytes, src_dev, dst_dev)

    def comm_matrix(self, nbytes: float) -> np.ndarray:
        """[K, K] transfer times of an ``nbytes`` flow for every channel."""
        k = self.cluster.k
        out = np.zeros((k, k))
        for s in range(k):
            for d in range(k):
                if s != d:
                    out[s, d] = self.comm_time(nbytes, s, d)
        return out

    # ---------------------------------------------------------- memory fit
    def kv_bytes(self, node: OpNode) -> float:
        """Per-request resident KV-cache bytes of ``node`` (0 for stateless ops)."""
        return node.kv_bytes * self._kv_factor()

    def _kv_factor(self) -> float:
        return paged_kv_factor(
            self.kv_page_tokens, self.kv_seq_tokens, self.kv_residency
        )

    def resident_bytes(self, node: OpNode, serving_slots: int = 1) -> float:
        """Eq. 5 resident cost of hosting ``node``: weights plus one KV-cache
        copy per concurrently served request (serving slot).  With
        ``serving_slots=1`` this is the paper's single-query memory model plus
        the one in-flight request's cache.  With paging configured
        (``kv_page_tokens``), each slot's copy charges resident *pages*
        rather than the dense ``max_len`` row — see :func:`paged_kv_factor`."""
        return node.param_bytes + max(serving_slots, 1) * self.kv_bytes(node)

    def memory_ok(
        self,
        graph: OpGraph,
        placement: Mapping[int, int],
        *,
        serving_slots: int = 1,
    ) -> bool:
        usage = self.memory_usage(graph, placement, serving_slots=serving_slots)
        caps = np.array([d.mem_bytes for d in self.cluster.devices])
        return bool(np.all(usage <= caps))

    def memory_usage(
        self,
        graph: OpGraph,
        placement: Mapping[int, int],
        *,
        serving_slots: int = 1,
    ) -> np.ndarray:
        usage = np.zeros(self.cluster.k)
        for nid, dev in placement.items():
            usage[dev] += self.resident_bytes(graph.nodes[nid], serving_slots)
        return usage

    # ------------------------------------------------------------ bounds
    def critical_path_lower_bound(self, graph: OpGraph) -> float:
        """Lower bound on makespan: longest path with best-device op times and
        zero communication.  Any feasible schedule's makespan is ≥ this."""
        best = {
            nid: min(self.compute_time(n, k) for k in range(self.cluster.k))
            for nid, n in graph.nodes.items()
        }
        dist: Dict[int, float] = {}
        for nid in graph.topo_order():
            node = graph.nodes[nid]
            start = max((dist[p] for p in node.inputs), default=0.0)
            dist[nid] = start + best[nid]
        return max(dist.values()) if dist else 0.0

    def total_work_lower_bound(self, graph: OpGraph) -> float:
        """Lower bound: total work / aggregate throughput (perfect balance)."""
        total = sum(
            min(self.compute_time(n, k) for k in range(self.cluster.k)) *
            self.cluster.devices[
                int(np.argmin([self.compute_time(n, k) for k in range(self.cluster.k)]))
            ].peak_flops
            for n in graph.nodes.values()
        )
        agg = sum(d.peak_flops for d in self.cluster.devices)
        return total / agg if agg else 0.0

    def lower_bound(self, graph: OpGraph) -> float:
        return max(
            self.critical_path_lower_bound(graph), self.total_work_lower_bound(graph)
        )


class DerateCalibrator:
    """Turns stage-level observed/predicted time ratios into per-device
    speed ratios, attributed across op classes (paper §III-C calibration,
    runtime edition).

    The serving engine observes whole *stages* (one scalar ratio per stage
    per window), but a device may be slow only on some op classes — e.g. a
    throttled MXU hurts matmul-bound blocks more than bandwidth-bound ones.
    Each stage sample is therefore attributed to the op classes executing in
    that stage, weighted by their predicted share of the stage time; the
    device-level ratio is then the weight-averaged (log-space) ratio over
    everything observed on that device.  The resulting ratio feeds the
    adaptive derate policy: ratio r > 1 means "device runs r× slower than
    the current cost model says", so the policy divides the device's speed
    factor by r.

    A stage's wall-clock sample also carries its INCOMING inter-stage
    transfer (the executor times ``device_put`` inside the receiving
    stage), so a degraded channel reads as a slow downstream stage.  The
    caller therefore splits each stage sample by the cost model's predicted
    compute/comm shares: the compute share feeds :meth:`add_stage_sample`
    (device evidence), the comm share feeds :meth:`add_channel_sample`
    (channel evidence keyed by the ``(src, dst)`` device pair) — which is
    what lets the derate policy derate the CHANNEL on comm-heavy stage
    boundaries instead of smearing correlated drift over both endpoint
    devices.

    Usage::

        cal = DerateCalibrator()
        cal.add_stage_sample(device=2, ratio=2.1, class_weights={"block": 1.0})
        cal.device_ratios()       # {2: 2.1}
        cal.op_class_ratios(2)    # {"block": 2.1}
        cal.add_channel_sample(1, 2, ratio=8.0, weight=0.9)
        cal.channel_ratios()      # {(1, 2): 8.0}
    """

    def __init__(self) -> None:
        # (device, op_class) -> [sum of w*log(ratio), sum of w]
        self._acc: Dict[tuple, list] = {}
        # (src, dst) -> [sum of w*log(ratio), sum of w]
        self._chan: Dict[tuple, list] = {}

    def add_stage_sample(
        self,
        device: int,
        ratio: float,
        class_weights: Mapping[str, float],
        *,
        weight: float = 1.0,
    ) -> None:
        """Record one stage observation.

        ``ratio`` is the stage's observed/predicted time (already normalized
        against the fleet baseline by the caller so absolute cost-model error
        cancels); ``class_weights`` maps op class → predicted-time share of
        the stage (weights are normalized internally).  ``weight`` scales
        the whole sample's evidence mass — the caller passes the stage's
        predicted COMPUTE share when the comm share went to
        :meth:`add_channel_sample`, so one wall-clock sample never counts
        twice.  Non-finite or non-positive ratios are ignored.
        """
        if not (ratio > 0.0 and np.isfinite(ratio)) or weight <= 0.0:
            return
        total = sum(w for w in class_weights.values() if w > 0)
        if total <= 0:
            class_weights, total = {"default": 1.0}, 1.0
        for cls, w in class_weights.items():
            if w <= 0:
                continue
            acc = self._acc.setdefault((device, cls), [0.0, 0.0])
            acc[0] += weight * (w / total) * float(np.log(ratio))
            acc[1] += weight * (w / total)

    def add_channel_sample(
        self, src: int, dst: int, ratio: float, *, weight: float = 1.0
    ) -> None:
        """Record one channel observation: the ``(src, dst)`` inter-stage
        transfer ran ``ratio``× its predicted time.  ``weight`` is the
        stage's predicted comm share (the evidence mass this sample carries
        — the compute share went to :meth:`add_stage_sample`)."""
        if not (ratio > 0.0 and np.isfinite(ratio)) or weight <= 0.0:
            return
        if src == dst:
            return
        acc = self._chan.setdefault((int(src), int(dst)), [0.0, 0.0])
        acc[0] += weight * float(np.log(ratio))
        acc[1] += weight

    def channel_ratios(self) -> Dict[tuple, float]:
        """(src, dst) → observed/predicted transfer-time ratio (weighted
        log-space geometric mean); ratio r > 1 means the channel moves
        bytes r× slower than the cost model says, so the derate policy
        divides its bandwidth factor by r."""
        return {
            chan: float(np.exp(s / w))
            for chan, (s, w) in self._chan.items()
            if w > 0
        }

    def op_class_ratios(self, device: int) -> Dict[str, float]:
        """Per-op-class observed/predicted ratio for ``device`` (geometric
        mean of the weighted samples attributed to each class)."""
        return {
            cls: float(np.exp(s / w))
            for (dev, cls), (s, w) in self._acc.items()
            if dev == device and w > 0
        }

    def device_ratios(self) -> Dict[int, float]:
        """Device → overall observed/predicted speed ratio (weight-averaged
        over all op classes observed on that device); the derate policy's
        input."""
        by_dev: Dict[int, list] = {}
        for (dev, _cls), (s, w) in self._acc.items():
            acc = by_dev.setdefault(dev, [0.0, 0.0])
            acc[0] += s
            acc[1] += w
        return {
            dev: float(np.exp(s / w)) for dev, (s, w) in by_dev.items() if w > 0
        }


def calibrate_from_cost_analysis(
    cm: CostModel,
    measured: Mapping[str, float],
    estimated: Mapping[str, float],
) -> CostModel:
    """Scale the cost model so estimator output matches observed per-op costs.

    ``measured``/``estimated``: op_type -> seconds.  Returns a new CostModel
    with updated per-class efficiencies (clipped to (0, 1])."""
    eff = dict(cm.efficiency)
    for op, t_meas in measured.items():
        t_est = estimated.get(op)
        if not t_est or t_meas <= 0:
            continue
        base = eff.get(op, eff["default"])
        eff[op] = float(np.clip(base * (t_est / t_meas), 1e-3, 1.0))
    return CostModel(
        cluster=cm.cluster,
        efficiency=eff,
        dispatch_overhead_s=cm.dispatch_overhead_s,
        device_scale=cm.device_scale.copy(),
        batch_invariant_frac=dict(cm.batch_invariant_frac),
        kv_page_tokens=cm.kv_page_tokens,
        kv_residency=cm.kv_residency,
        kv_seq_tokens=cm.kv_seq_tokens,
    )
