"""The system under test, and the only module of the harness that imports
it: ``repro_torch``'s serving engine, built as its serve CLI builds it
(``launch/serve.py``: per-layer params, the CUDA kernels through
``attention_impl="pallas"``, a plan on the modeled cluster
``h100_cluster(1, heterogeneous=True)``, ``eos_id=-1``, the adaptation loop
at the engine's default, which closes no window by itself).

It also puts the harness's probes on the engine for a traced run: a
wrapper around the executor's ``forward`` (each forward's shape, ``q_lens``,
``cache_pos`` and host wall time, under a profiler label) and one around
the grouped GEMM (a handle to each call's group sizes, read after the
window).  Imports of the program happen inside the functions, so that the
harness's other modules and tests import nothing of it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

from . import weights

PORT_RMS_EPS = 1e-6   # the port's RMSNorm epsilon (models/layers.py)


def port_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration file's dict: the
    port's entry for ``cfg["port"]["arch"]`` with every size taken from the
    file, served in the file's type with the kernels."""
    from repro_torch.configs import get_config

    if cfg["rms_norm_eps"] != PORT_RMS_EPS:
        raise ValueError(f"the port's RMSNorm epsilon is {PORT_RMS_EPS}, the config "
                         f"states {cfg['rms_norm_eps']}")
    if cfg.get("tie_word_embeddings"):
        raise ValueError("tied embeddings: the weight layout has an untied head")
    for key in ("qkv_bias", "shared_expert_gate"):
        if cfg.get(key):
            raise ValueError(f"the config states {key}, which the program does not have")
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    fields: Dict[str, Any] = dict(
        n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv_heads=cfg["num_key_value_heads"], vocab_size=cfg["vocab_size"],
        head_dim=cfg.get("head_dim") or d // h, rope_theta=float(cfg["rope_theta"]),
        qk_norm=any(path[-1] == "q_norm" for path, *_ in weights.layout(cfg)),
        activation=cfg["hidden_act"],
        tie_embeddings=False, dtype=cfg["torch_dtype"],
        scan_layers=False, remat=False, attention_impl="pallas",
    )
    if "num_experts" in cfg:
        f = cfg["moe_intermediate_size"]
        sf = cfg["shared_expert_intermediate_size"]
        fields.update(
            family="moe", d_ff=f, n_experts=cfg["num_experts"],
            n_experts_padded=cfg["port"].get("experts_padded") or cfg["num_experts"],
            top_k=cfg["num_experts_per_tok"], moe_d_ff=f, n_shared_experts=max(1, sf // f),
            shared_d_ff=sf, router_norm_topk=bool(cfg["norm_topk_prob"]),
        )
    else:
        fields.update(family="dense", d_ff=cfg["intermediate_size"], n_experts=0,
                      n_experts_padded=0, top_k=0, moe_d_ff=0, n_shared_experts=0,
                      shared_d_ff=0)
    return dataclasses.replace(get_config(cfg["port"]["arch"]), name=cfg["name"], **fields)


def build_engine(pcfg, params, engine: dict, device):
    """A ``ServingEngine`` for the mix's ``engine`` settings (``slots``,
    ``max_len``, ``prefill_chunk``, ``kv_page_tokens``, ``prefix_sharing``)
    on one modeled H100, serving on ``device``."""
    import torch
    from repro_torch.core.devices import h100_cluster
    from repro_torch.core.placement import PlanConfig
    from repro_torch.serving.engine import ServingEngine

    slots = engine["slots"]
    plan_cfg = PlanConfig(
        method="moirai", time_limit=20, mip_rel_gap=0.05,
        objective="throughput" if slots > 1 else "latency",
        serving_slots=slots, prefill_chunk=engine["prefill_chunk"],
        kv_page_tokens=engine.get("kv_page_tokens") or None,
        prefix_sharing=bool(engine.get("prefix_sharing", False)),
    )
    return ServingEngine(
        pcfg, params, h100_cluster(1, heterogeneous=True), devices=[torch.device(device)],
        slots=slots, max_len=engine["max_len"], plan_cfg=plan_cfg, eos_id=-1,
    )


def make_request(rid: int, prompt: List[int], max_new: int):
    from repro_torch.serving.engine import Request

    return Request(rid=rid, prompt=prompt, max_new_tokens=max_new)


def pool_counters(eng) -> Dict[str, int]:
    """The KV pool's reuse counters (zeros for dense rows)."""
    pool = getattr(eng, "_kv_pool", None)
    if pool is None:
        return {"reused_pages": 0, "page_tokens": 0, "cow_copies": 0}
    st = pool.stats()
    return {"reused_pages": st["reused_pages"], "page_tokens": pool.page_tokens,
            "cow_copies": st["cow_copies"]}


class Probes:
    """The traced run's records, filled by wrappers put on the engine."""

    def __init__(self):
        self.forwards: List[tuple] = []   # (t0, t1, B, S, q_lens, cache_pos)
        self.gg_calls: List[tuple] = []   # (host time, group_sizes tensor, K, N)
        self.on = False
        self._undo: List = []

    def attach(self, eng) -> None:
        import numpy as np
        import torch
        from repro_torch.kernels import grouped_gemm as gg

        executor = eng.executor
        fwd = executor.forward

        def forward(tokens, *args, **kw):
            if not self.on:
                return fwd(tokens, *args, **kw)
            t0 = time.perf_counter()
            with torch.profiler.record_function("portbench.forward"):
                out = fwd(tokens, *args, **kw)
            t1 = time.perf_counter()
            tk = torch.as_tensor(tokens)
            ql = kw.get("q_lens")
            cp = kw.get("cache_pos")
            self.forwards.append((
                t0, t1, int(tk.shape[0]), int(tk.shape[1]),
                None if ql is None else np.asarray(torch.as_tensor(ql)).copy(),
                None if cp is None else np.asarray(cp).copy(),
            ))
            return out

        executor.forward = forward
        self._undo.append(lambda: delattr(executor, "forward"))
        gemm = gg.grouped_gemm

        def grouped_gemm(x, w, group_sizes):
            if self.on:
                self.gg_calls.append((time.perf_counter(), group_sizes, int(w.shape[-2]),
                                      int(w.shape[-1])))
            return gemm(x, w, group_sizes)

        gg.grouped_gemm = grouped_gemm
        self._undo.append(lambda: setattr(gg, "grouped_gemm", gemm))

    def detach(self) -> None:
        while self._undo:
            self._undo.pop()()

    def group_sizes(self) -> List[tuple]:
        """``(host time, sizes ndarray, K, N)`` of every grouped GEMM call
        recorded, the sizes read back from the card once."""
        import torch

        if not self.gg_calls:
            return []
        sizes = torch.stack([g for _, g, _, _ in self.gg_calls]).cpu().numpy()
        return [(t, sizes[i], k, n) for i, (t, _, k, n) in enumerate(self.gg_calls)]


def release(eng) -> None:
    """Free the engine's caches (the program's state on the card)."""
    eng.release_caches()


def device_name(device) -> Optional[str]:
    import torch

    return torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" else None
