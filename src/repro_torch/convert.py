"""Parameters for the port: carried over from the JAX reference, or made
fresh at the reference's init distributions; and the reference's
optimizer state carried over (:func:`opt_state_from_jax`).

Both give the layout :class:`~repro_torch.serving.stage_executor.StageExecutor`
and :mod:`repro_torch.models.transformer` take — the reference's keys, one
dict per layer under ``"layers"`` (and the hybrid's ``"mamba_layers"``, the
enc-dec model's ``"encoder"`` and ``"decoder"``),
weights in the reference's ``x @ w`` orientation (``[d_in, d_out]``), norm
weights fp32 in offset form — so a conversion is a copy.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.ssm import mamba2_dims
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
    ``device`` (default: the first card).  Stacked layer params (one dict of
    ``[L, ...]`` arrays: ``layers``, and the enc-dec model's ``encoder`` and
    ``decoder``, at ``scan_layers=True``, and the hybrid's ``mamba_layers``
    always) are split into the per-layer lists the port serves from."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_tensor(node, device)

    out = conv(dict(tree))
    for key in ("layers", "mamba_layers", "encoder", "decoder"):
        layers = out.get(key)
        if isinstance(layers, dict):
            n = next(iter(_leaves(layers))).shape[0]
            out[key] = [_index(layers, i) for i in range(n)]
    return out


def opt_state_from_jax(state, device=None) -> Params:
    """Convert a reference optimizer state (``train.optimizer.
    init_opt_state``'s tree: ``m`` and ``v`` like the params, fp32 or
    quant8 ``{"q", "s"}`` leaves, and the int32 ``step``) into the port's,
    on ``device`` (default: the first card): the moments split per layer
    as :func:`params_from_jax` splits the params."""
    device = resolve_device(device)
    return {
        "m": params_from_jax(state["m"], device),
        "v": params_from_jax(state["v"], device),
        "step": _to_tensor(state["step"], device),
    }


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
    """Fresh params of any family at the reference's
    distributions: dense weights ``normal · 1/√d_in``, embeddings
    ``normal · 0.02``, norms zero (offset form, fp32); an MoE layer's router
    fp32 ``[d, E_pad]`` at ``1/√d``, its experts ``w_gate``/``w_up``
    ``[E_pad, d, f]`` at ``1/√d`` and ``w_down`` ``[E_pad, f, d]`` at
    ``1/√f``, with arctic's parallel dense FFN (``mlp``) and qwen2-moe's
    merged shared experts (``shared_mlp``) as dense MLPs.  A Mamba2 layer
    (``{"ln", "mamba"}``) has its projections at ``1/√d_in``, depthwise
    conv weights ``normal · 0.1`` and zero conv biases in ``cfg.dtype``,
    and fp32 ``A_log = log(linspace(1, 16, H))``, ``D = 1`` and
    ``dt_bias = log(expm1(0.01))``; the hybrid adds ``shared_proj_in``
    ``[2d, d]`` and one shared attention block.  The VLM family has the
    dense layout.  The enc-dec family has ``encoder`` layers (``ln_attn``,
    ``attn``, ``ln_mlp``, ``mlp``), ``decoder`` layers (``ln_self``,
    ``self_attn``, ``ln_cross``, ``cross_attn``, ``ln_mlp``, ``mlp``) and
    ``ln_enc_final`` beside the embedding, head and final norm.  Drawn in fp32 on
    ``generator``'s device, then cast to ``cfg.dtype`` on ``device``
    (default: the first card) — no JAX needed.  On the ``meta`` device
    nothing is drawn: the tree has the shapes and dtypes only."""
    if cfg.family != "encdec":
        check_family(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cfg)
    gdev = generator.device
    hd = cfg.resolved_head_dim

    def normal(shape, std, dtype=dt):
        if device.type == "meta":        # shapes only: nothing drawn
            return torch.empty(shape, dtype=dtype, device=device)
        w = torch.randn(shape, generator=generator, device=gdev, dtype=torch.float32)
        return (w * std).to(device=device, dtype=dtype)

    def dense(d_in, d_out):
        return normal((d_in, d_out), 1.0 / math.sqrt(d_in))

    def mlp(d_ff):
        return {
            "w_gate": dense(cfg.d_model, d_ff),
            "w_up": dense(cfg.d_model, d_ff),
            "w_down": dense(d_ff, cfg.d_model),
        }

    def moe():
        e, d, f = cfg.n_experts_padded or cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        return {
            "router": normal((d, e), 1.0 / math.sqrt(d), torch.float32),
            "w_gate": normal((e, d, f), 1.0 / math.sqrt(d)),
            "w_up": normal((e, d, f), 1.0 / math.sqrt(d)),
            "w_down": normal((e, f, d), 1.0 / math.sqrt(f)),
        }

    def norm(d):
        return torch.zeros((d,), dtype=torch.float32, device=device)

    def attention():
        attn = {
            "wq": dense(cfg.d_model, cfg.n_heads * hd),
            "wk": dense(cfg.d_model, cfg.n_kv_heads * hd),
            "wv": dense(cfg.d_model, cfg.n_kv_heads * hd),
            "wo": dense(cfg.n_heads * hd, cfg.d_model),
        }
        if cfg.qk_norm:
            attn["q_norm"] = norm(hd)
            attn["k_norm"] = norm(hd)
        return attn

    def layer():
        p = {"ln_attn": norm(cfg.d_model), "attn": attention(), "ln_mlp": norm(cfg.d_model)}
        if cfg.post_block_norm:
            p["ln_attn_post"] = norm(cfg.d_model)
            p["ln_mlp_post"] = norm(cfg.d_model)
        if cfg.family == "moe" or cfg.n_experts:
            p["moe"] = moe()
            if cfg.dense_parallel_ff and cfg.d_ff:
                p["mlp"] = mlp(cfg.d_ff)
            if cfg.n_shared_experts and cfg.shared_d_ff:
                p["shared_mlp"] = mlp(cfg.shared_d_ff)
        else:
            p["mlp"] = mlp(cfg.d_ff)
        return p

    def mamba_layer():
        dims = mamba2_dims(cfg)
        d, di, nh = cfg.d_model, dims["d_inner"], dims["nheads"]
        gn = cfg.ngroups * cfg.ssm_state
        zeros = lambda n: torch.zeros((n,), dtype=dt, device=device)  # noqa: E731
        m = {
            "w_z": dense(d, di), "w_x": dense(d, di), "w_B": dense(d, gn),
            "w_C": dense(d, gn), "w_dt": dense(d, nh),
            "conv_x": normal((cfg.ssm_conv, di), 0.1),
            "conv_B": normal((cfg.ssm_conv, gn), 0.1),
            "conv_C": normal((cfg.ssm_conv, gn), 0.1),
            "b_x": zeros(di), "b_B": zeros(gn), "b_C": zeros(gn),
            "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32)).to(device),
            "D": torch.ones((nh,), dtype=torch.float32, device=device),
            "dt_bias": torch.log(torch.expm1(torch.full((nh,), 0.01))).to(device),
            "norm_w": norm(di),
            "out_proj": dense(di, d),
        }
        return {"ln": norm(d), "mamba": m}

    p: Params = {"embed": normal((cfg.vocab_size, cfg.d_model), 0.02)}
    p["ln_final"] = norm(cfg.d_model)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense(cfg.d_model, cfg.vocab_size)
    if cfg.family == "encdec":
        p["ln_enc_final"] = norm(cfg.d_model)
        p["encoder"] = [
            {"ln_attn": norm(cfg.d_model), "attn": attention(), "ln_mlp": norm(cfg.d_model),
             "mlp": mlp(cfg.d_ff)}
            for _ in range(cfg.n_encoder_layers)
        ]
        p["decoder"] = [
            {"ln_self": norm(cfg.d_model), "self_attn": attention(),
             "ln_cross": norm(cfg.d_model), "cross_attn": attention(),
             "ln_mlp": norm(cfg.d_model), "mlp": mlp(cfg.d_ff)}
            for _ in range(cfg.n_layers)
        ]
    elif cfg.family == "hybrid":
        p["mamba_layers"] = [mamba_layer() for _ in range(cfg.n_layers)]
        # one SHARED attention block (weights reused at every occurrence)
        p["shared_proj_in"] = dense(2 * cfg.d_model, cfg.d_model)
        p["shared_block"] = layer()
    elif cfg.family == "ssm":
        p["layers"] = [mamba_layer() for _ in range(cfg.n_layers)]
    else:
        p["layers"] = [layer() for _ in range(cfg.n_layers)]
    return p
