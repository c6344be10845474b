"""Moirai-driven inter-operator model-parallel executor (the paper's runtime),
in PyTorch.

Given a layer-granularity OpGraph placement (node → device), consecutive
co-located blocks become *stages*; each stage's parameters live on its
``torch.device``, and activations hop between stages with ``.to(device)``.
Each Moirai device maps to one physical device.

Supports dense and MoE decoder-only models with per-layer params (the
serving layout; an MoE layer's expert weights move with the rest of its
nested dict).  Each stage's KV cache stays resident on that stage's device and
is **updated in place** by :meth:`StageExecutor.forward` (the returned
caches hold the same tensors; the ``(x, new_caches)`` return is kept for
parity with the reference).  Decode accepts a ``(B,)`` ``cache_pos``
vector — ragged batches where every slot row sits at its own depth —
carried across stage boundaries unchanged.  Paged KV: each stage holds
page pools (:meth:`StageExecutor.init_paged_caches`) and the host-owned
page table rides into :meth:`StageExecutor.forward` as ``page_table``.
With a span recorder (:attr:`StageExecutor.tracer`, set by the serving
engine), each stage of a forward is an ``executor.stage`` span, and its
``torch.cuda.synchronize`` the child ``executor.sync``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import OpGraph
from repro_torch.models import transformer
from repro_torch.models.layers import uses_kernels, rmsnorm, softcap
from . import tracing


@dataclass
class Stage:
    device: Any                      # torch.device
    layer_ids: List[int]             # model layer indices (contiguous)
    first: bool = False              # owns embedding
    last: bool = False               # owns final norm + lm head
    node_ids: List[int] = field(default_factory=list)  # OpGraph nodes in this stage


def stages_from_placement(
    graph: OpGraph,
    placement: Dict[int, int],
    devices: Sequence[Any],
    n_layers: int,
) -> List[Stage]:
    """Layer-graph nodes (embed, blocks…, lm_head) → contiguous stages.

    The layer graph is a chain: topological order maps node k to model layer
    k−1 (node 0 = embed, last = lm_head).  Moirai may interleave devices
    arbitrarily; the executor honors the order, creating a new stage at every
    device change."""
    order = graph.topo_order()
    assert len(order) == n_layers + 2, (len(order), n_layers)
    stages: List[Stage] = []
    for pos, nid in enumerate(order):
        dev = devices[placement[nid] % len(devices)]
        if pos == 0:
            stages.append(Stage(device=dev, layer_ids=[], first=True, node_ids=[nid]))
            continue
        layer_idx = pos - 1
        if pos == len(order) - 1:
            if stages[-1].device is not dev:
                stages.append(Stage(device=dev, layer_ids=[]))
            stages[-1].last = True
            stages[-1].node_ids.append(nid)
            continue
        if stages[-1].device is dev:
            stages[-1].layer_ids.append(layer_idx)
        else:
            stages.append(Stage(device=dev, layer_ids=[layer_idx]))
        stages[-1].node_ids.append(nid)
    return stages


def check_servable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a model the executor cannot serve:
    an SSM, hybrid, enc-dec or VLM one, which runs at the model level only,
    as in the reference (whose executor applies attention blocks to every
    layer of ``params["layers"]`` on token embeddings: it fails on a Mamba
    layer, on the enc-dec model's missing ``"layers"`` and inside M-RoPE)."""
    if cfg.family in ("ssm", "hybrid", "encdec", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the stage executor and the serving engine serve "
            f"decoder-only attention models on tokens; the {cfg.family} family runs at the "
            "model level through repro_torch.models.model.build_model(cfg) and its entry "
            "points prefill, prefill_chunked, decode_step and fused_step"
        )
    transformer.check_family(cfg)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


class StageExecutor:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict[str, Any],
        stages: List[Stage],
    ):
        check_servable(cfg)
        self.cfg = cfg
        self.stages = stages
        self._windows = transformer._layer_windows(cfg)
        self._place_params(params)
        # bounded: a long-lived executor must not retain every forward's
        # timing forever (the adaptation loop drains these per window anyway).
        # Entries are (kind, seconds) — "decode" or "prefill" — so the
        # observation windows can feed the derate calibrator DECODE samples
        # only: prefill forwards scale with prompt length.
        self._stage_times: List[deque] = [
            deque(maxlen=4096) for _ in stages
        ]
        self._fns: Dict[int, Callable] = {}
        self.tracer: Optional[tracing.SpanRecorder] = None

    # ------------------------------------------------------------------
    def _place_params(self, params):
        self.stage_params: List[Dict[str, Any]] = []
        for st in self.stages:
            sp: Dict[str, Any] = {
                "layers": [_to(params["layers"][i], st.device) for i in st.layer_ids]
            }
            if st.first:
                sp["embed"] = params["embed"].to(st.device)
            if st.last:
                sp["ln_final"] = params["ln_final"].to(st.device)
                if not self.cfg.tie_embeddings:
                    sp["lm_head"] = params["lm_head"].to(st.device)
                elif not st.first:
                    sp["embed"] = params["embed"].to(st.device)
            self.stage_params.append(sp)

    # ------------------------------------------------------------------
    def _stage_fn(self, si: int):
        cfg = self.cfg
        st = self.stages[si]
        windows = [self._windows[i] for i in st.layer_ids]
        kernels = uses_kernels(cfg)
        # gemma's embedding scale, made once on the stage's device in the
        # activations' dtype: the scalar is rounded to that dtype first, as
        # the reference rounds it
        embed_scale = None
        if st.first and cfg.scale_embed:
            embed = self.stage_params[si]["embed"]
            embed_scale = torch.tensor(cfg.d_model ** 0.5, dtype=embed.dtype, device=embed.device)

        def run(sp, x, positions, caches, cache_pos, q_lens=None, table=None):
            new_caches = []
            if st.first:
                x = sp["embed"][x.to(torch.int64)]
                if embed_scale is not None:
                    x = x * embed_scale
            for j, layer_p in enumerate(sp["layers"]):
                cache_j = caches[j] if caches is not None else None
                if cache_j is not None and table is not None:
                    # paged KV: one [B, pages_per_slot] table shared by every
                    # layer of every stage; pools stay per-layer per-stage
                    cache_j = dict(cache_j, table=table)
                x, nc = transformer.block_apply(
                    layer_p, x, cfg,
                    positions=positions,
                    window=windows[j],
                    kv_cache=cache_j,
                    cache_pos=cache_pos,
                    q_lens=q_lens,
                )
                if nc is not None and "table" in nc:
                    nc = {"k": nc["k"], "v": nc["v"]}
                new_caches.append(nc)
            if st.last:
                x = rmsnorm(x, sp["ln_final"], kernel=kernels)
                head = sp["embed"].T if cfg.tie_embeddings else sp["lm_head"]
                x = softcap(x @ head, cfg.logit_softcap)
            return x, new_caches

        return run

    # ------------------------------------------------------------------
    def init_caches(self, batch: int, max_len: int):
        hd = self.cfg.resolved_head_dim
        dt = transformer.torch_dtype(self.cfg)
        shape = (batch, max_len, self.cfg.n_kv_heads, hd)
        return [
            [
                {
                    "k": torch.zeros(shape, dtype=dt, device=st.device),
                    "v": torch.zeros(shape, dtype=dt, device=st.device),
                }
                for _ in st.layer_ids
            ]
            for st in self.stages
        ]

    def init_paged_caches(self, num_pages: int, page_tokens: int):
        """Paged-KV pools: per stage, per layer, ``[num_pages+1, P, KV, hd]``
        zeros on that stage's device (the +1 is the reserved trash page).
        The page table is host-owned (``serving.kv_pool``) and rides into
        :meth:`forward` as ``page_table`` each step."""
        hd = self.cfg.resolved_head_dim
        dt = transformer.torch_dtype(self.cfg)
        shape = (num_pages + 1, page_tokens, self.cfg.n_kv_heads, hd)
        return [
            [
                {
                    "k": torch.zeros(shape, dtype=dt, device=st.device),
                    "v": torch.zeros(shape, dtype=dt, device=st.device),
                }
                for _ in st.layer_ids
            ]
            for st in self.stages
        ]

    def copy_pages(self, caches, pairs):
        """Copy-on-write support: copy pages ``(src, dst)`` in every stage's
        every layer pool (K and V), in place with ``index_copy_``.  Called at
        admission when a prompt diverges inside a shared prefix page, before
        any write can land in ``dst``; the table update itself is host-side
        (``KVPool``).  Returns ``caches`` (the same tensors)."""
        if not pairs:
            return caches
        for st_caches in caches:
            if not st_caches:
                continue
            dev = st_caches[0]["k"].device
            src = torch.tensor([s for s, _ in pairs], dtype=torch.int64, device=dev)
            dst = torch.tensor([d for _, d in pairs], dtype=torch.int64, device=dev)
            for c in st_caches:
                for key in ("k", "v"):
                    c[key].index_copy_(0, dst, c[key].index_select(0, src))
        return caches

    def forward(
        self,
        tokens,                       # [B, S] int (prefill) or [B, 1] (decode)
        caches=None,
        cache_pos=None,               # int scalar, or (B,) int vector (ragged
                                      # decode: one cache depth per slot row)
        *,
        kind: Optional[str] = None,   # "decode" | "prefill" | "fused" sample
                                      # tag; None infers from the token count
        q_lens=None,                  # (B,) valid tokens per row — the fused
                                      # mixed-batch ragged shape (decode rows
                                      # 1, prefill chunks n, idle rows 0)
        fused_decode_frac: Optional[List[float]] = None,
                                      # kind="fused": predicted decode share
                                      # of each stage's wall time — one fused
                                      # forward records a ("decode", dt·f) AND
                                      # a ("prefill", dt·(1−f)) sample so the
                                      # calibrator's windows stay clean
        page_table=None,              # [B, pages_per_slot] int32 — paged-KV
                                      # table (caches hold page pools)
    ):
        """Run every stage in order; returns ``(logits, caches)``.  The
        caches are updated in place.  Each stage's wall time is recorded
        after ``torch.cuda.synchronize`` on its device.  The page table
        goes to each stage's device once per call, not once per layer (from
        pinned host memory it is an asynchronous copy)."""
        tokens = torch.as_tensor(tokens)
        b, s = tokens.shape
        if kind is None:
            kind = "prefill" if s > 1 else "decode"
        elif kind not in ("decode", "prefill", "fused"):
            raise ValueError(
                f"kind must be 'decode', 'prefill' or 'fused', got {kind!r}"
            )
        cp = torch.as_tensor(0 if cache_pos is None else cache_pos).to(torch.int32)
        # per-row positions: row b decodes at depth cp[b] (scalar cp → all
        # rows share one depth, the classic lockstep batch)
        positions = torch.arange(s, dtype=torch.int32)[None] + (
            cp[:, None] if cp.ndim else cp
        )
        positions = positions.expand(b, s)
        ql = None if q_lens is None else torch.as_tensor(q_lens).to(torch.int32)
        tbl = None if page_table is None else torch.as_tensor(page_table).to(torch.int32)
        x = tokens
        new_caches = []
        on_dev: Dict[Any, tuple] = {}
        tr = self.tracer
        for si, st in enumerate(self.stages):
            with tracing.span(tr, "executor.stage"):
                t0 = time.perf_counter()
                x = x.to(st.device)                       # inter-stage data flow
                if st.device not in on_dev:
                    on_dev[st.device] = (
                        positions.to(st.device), cp.to(st.device),
                        None if ql is None else ql.to(st.device),
                        None if tbl is None else tbl.to(st.device, non_blocking=True),
                    )
                pos_d, cp_d, ql_d, tbl_d = on_dev[st.device]
                fn = self._fns.get(si)
                if fn is None:
                    fn = self._fns[si] = self._stage_fn(si)
                st_caches = caches[si] if caches is not None else None
                x, nc = fn(self.stage_params[si], x, pos_d, st_caches, cp_d, ql_d, tbl_d)
                if torch.device(st.device).type == "cuda":
                    with tracing.span(tr, "executor.sync"):
                        torch.cuda.synchronize(st.device)
                dt = time.perf_counter() - t0
                if kind == "fused":
                    # split the single wall-clock sample by the cost model's
                    # predicted decode share so neither op class pollutes the
                    # other's observation window
                    f = 1.0 if fused_decode_frac is None else float(fused_decode_frac[si])
                    f = min(max(f, 0.0), 1.0)
                    if f > 0.0:
                        self._stage_times[si].append(("decode", dt * f))
                    if f < 1.0:
                        self._stage_times[si].append(("prefill", dt * (1.0 - f)))
                else:
                    self._stage_times[si].append((kind, dt))
                new_caches.append(nc)
        return x, new_caches

    # stage latency samples (straggler detection feed)
    def _times(self, rec, kind: Optional[str]) -> List[float]:
        return [t for k, t in rec if kind is None or k == kind]

    def stage_times(self, kind: Optional[str] = None) -> List[List[float]]:
        """Per-stage wall-clock seconds of recent forward calls (bounded
        ring, most recent last; copies).  ``kind`` filters to "decode" or
        "prefill" samples (None = all)."""
        return [self._times(rec, kind) for rec in self._stage_times]

    def drain_stage_times(self, kind: Optional[str] = None) -> List[List[float]]:
        """Return the recorded per-stage times and RESET the recorders.
        ``kind`` selects which samples are RETURNED (None = all); the reset
        always clears everything."""
        out = [self._times(rec, kind) for rec in self._stage_times]
        for rec in self._stage_times:
            rec.clear()
        return out


def stats_from_times(times: Sequence[float]) -> Dict[str, float]:
    """mean/p95/n summary of one stage's observed latencies; the single
    aggregation used for executor-recorded and externally-injected samples."""
    import numpy as np

    if not times:
        return {"mean": 0.0, "p95": 0.0, "n": 0}
    arr = np.asarray(times, dtype=np.float64)
    return {
        "mean": float(arr.mean()),
        "p95": float(np.percentile(arr, 95)),
        "n": len(times),
    }
