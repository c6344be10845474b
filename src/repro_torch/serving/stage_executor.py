"""Moirai-driven inter-operator model-parallel executor (the paper's runtime),
in PyTorch.

Given a layer-granularity OpGraph placement (node → device), consecutive
co-located blocks become *stages*; each stage's parameters live on its
``torch.device``, and activations hop between stages with ``.to(device)``.
Each Moirai device maps to one physical device.

Supports dense decoder-only models with per-layer params (the serving
layout).  Each stage's KV cache stays resident on that stage's device and
is **updated in place** by :meth:`StageExecutor.forward` (the returned
caches hold the same tensors; the ``(x, new_caches)`` return is kept for
parity with the reference).  Decode accepts a ``(B,)`` ``cache_pos``
vector — ragged batches where every slot row sits at its own depth —
carried across stage boundaries unchanged.
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
        transformer.check_family(cfg)
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

        def run(sp, x, positions, caches, cache_pos, q_lens=None):
            new_caches = []
            if st.first:
                x = sp["embed"][x.to(torch.int64)]
                if cfg.scale_embed:
                    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
            for j, layer_p in enumerate(sp["layers"]):
                cache_j = caches[j] if caches is not None else None
                x, nc = transformer.block_apply(
                    layer_p, x, cfg,
                    positions=positions,
                    window=windows[j],
                    kv_cache=cache_j,
                    cache_pos=cache_pos,
                    q_lens=q_lens,
                )
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
        page_table=None,              # paged KV: not ported yet
    ):
        """Run every stage in order; returns ``(logits, caches)``.  The
        caches are updated in place.  Each stage's wall time is recorded
        after ``torch.cuda.synchronize`` on its device."""
        if page_table is not None:
            raise NotImplementedError("paged KV is not ported yet (ROADMAP A0, the next slice)")
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
        x = tokens
        new_caches = []
        on_dev: Dict[Any, tuple] = {}
        for si, st in enumerate(self.stages):
            t0 = time.perf_counter()
            x = x.to(st.device)                       # inter-stage data flow
            if st.device not in on_dev:
                on_dev[st.device] = (
                    positions.to(st.device), cp.to(st.device),
                    None if ql is None else ql.to(st.device),
                )
            pos_d, cp_d, ql_d = on_dev[st.device]
            fn = self._fns.get(si)
            if fn is None:
                fn = self._fns[si] = self._stage_fn(si)
            st_caches = caches[si] if caches is not None else None
            x, nc = fn(self.stage_params[si], x, pos_d, st_caches, cp_d, ql_d)
            if torch.device(st.device).type == "cuda":
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

    # stage latency stats (straggler detection feed)
    def _times(self, rec, kind: Optional[str]) -> List[float]:
        return [t for k, t in rec if kind is None or k == kind]

    def stage_latency_stats(self, kind: Optional[str] = None) -> List[Dict[str, float]]:
        """mean/p95/n summary per stage over the RETAINED forward calls (a
        bounded ring that observation windows also drain).  ``kind`` filters
        to "decode" or "prefill" samples (None = all)."""
        return [
            stats_from_times(self._times(rec, kind)) for rec in self._stage_times
        ]

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
