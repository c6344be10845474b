"""Parameters for the port: carried over from the JAX reference, or made
fresh at the reference's init distributions.

Both give the layout :class:`~repro_torch.serving.stage_executor.StageExecutor`
and :mod:`repro_torch.models.transformer` take — the reference's keys, one
dict per layer under ``"layers"``, weights in the reference's ``x @ w``
orientation (``[d_in, d_out]``), norm weights fp32 in offset form — so a
conversion is a copy.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import check_family, torch_dtype

Params = Dict[str, Any]


def _to_tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":     # ml_dtypes bf16: go through fp32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_jax(tree, device=None) -> Params:
    """Convert a reference param pytree (arrays, or numpy copies of them)
    into nested dicts of tensors with the same keys and dtypes, on
    ``device`` (default: the first card).  Stacked layer params
    (``scan_layers=True``: one dict of ``[L, ...]`` arrays) are split into
    the per-layer list the port serves from."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_tensor(node, device)

    out = conv(dict(tree))
    layers = out.get("layers")
    if isinstance(layers, dict):
        n = next(iter(_leaves(layers))).shape[0]
        out["layers"] = [_index(layers, i) for i in range(n)]
    return out


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def _index(node, i):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return node[i].contiguous()


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> Params:
    """Fresh dense-decoder params at the reference's distributions: dense
    weights ``normal · 1/√d_in``, embeddings ``normal · 0.02``, norms zero
    (offset form, fp32).  Drawn in fp32 on ``generator``'s device, then
    cast to ``cfg.dtype`` on ``device`` (default: the first card) — no JAX
    needed."""
    check_family(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cfg)
    gdev = generator.device
    hd = cfg.resolved_head_dim

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=gdev, dtype=torch.float32)
        return (w * std).to(device=device, dtype=dt)

    def dense(d_in, d_out):
        return normal((d_in, d_out), 1.0 / math.sqrt(d_in))

    def norm(d):
        return torch.zeros((d,), dtype=torch.float32, device=device)

    def layer():
        attn = {
            "wq": dense(cfg.d_model, cfg.n_heads * hd),
            "wk": dense(cfg.d_model, cfg.n_kv_heads * hd),
            "wv": dense(cfg.d_model, cfg.n_kv_heads * hd),
            "wo": dense(cfg.n_heads * hd, cfg.d_model),
        }
        if cfg.qk_norm:
            attn["q_norm"] = norm(hd)
            attn["k_norm"] = norm(hd)
        p = {
            "ln_attn": norm(cfg.d_model),
            "attn": attn,
            "ln_mlp": norm(cfg.d_model),
            "mlp": {
                "w_gate": dense(cfg.d_model, cfg.d_ff),
                "w_up": dense(cfg.d_model, cfg.d_ff),
                "w_down": dense(cfg.d_ff, cfg.d_model),
            },
        }
        if cfg.post_block_norm:
            p["ln_attn_post"] = norm(cfg.d_model)
            p["ln_mlp_post"] = norm(cfg.d_model)
        return p

    p: Params = {"embed": normal((cfg.vocab_size, cfg.d_model), 0.02)}
    p["ln_final"] = norm(cfg.d_model)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense(cfg.d_model, cfg.vocab_size)
    p["layers"] = [layer() for _ in range(cfg.n_layers)]
    return p
