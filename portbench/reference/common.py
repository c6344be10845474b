"""Plain PyTorch pieces shared by the reference forwards: RMSNorm, RoPE,
causal GQA attention and the linear layer at a chosen precision.

Everything here computes in float32 (TF32 off: the caller sets
``torch.backends.cuda.matmul.allow_tf32 = False``).  Nothing here imports
the program under test, and nothing reads what the program made: the
weights are the benchmark's own tensors, upcast at use.

``Precision`` is the one switch the control uses: ``"fp32"`` is the
reference; ``"fp8"`` rounds both operands of every linear layer to float8
e4m3 (per-row scales for activations, per-output-column scales for weights)
and multiplies them in float32, which is what an fp8 GEMM with float32
accumulation computes.  Attention scores, norms, RoPE and the router stay
in float32 under both.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn
NORM_STD = 0.1    # norm weights, around the offset form's 1
EMBED_STD = 0.02
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (float32) rounded to float8 e4m3 with one scale per slice
    along ``dim`` (the slice's absolute maximum maps to 448)."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    """How a linear layer multiplies: ``fp32`` (the reference) or ``fp8``
    (the control)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {name!r}")
        self.name = name

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A weight ``[..., d_in, d_out]`` in float32, as this precision
        multiplies it (fp8: one scale per output column)."""
        w = w.to(torch.float32)
        return _fp8_round(w, dim=-2) if self.name == "fp8" else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """Activations ``[T, d_in]`` as this precision multiplies them
        (fp8: one scale per row)."""
        return _fp8_round(x, dim=-1) if self.name == "fp8" else x

    def linear(self, x: torch.Tensor, w32: torch.Tensor) -> torch.Tensor:
        """``x @ w`` with ``w32`` already from :meth:`weight`."""
        return self.act(x) @ w32


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · (1 + w)`` over the last axis, float32.
    The weight is stored in offset form (a weight of 0 scales by 1)."""
    x = x.to(torch.float32)
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w.to(torch.float32))


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x [T, H, D]`` at positions ``pos [T]``: the
    two halves of each head rotated (the Hugging Face ``rotate_half``
    convention), float32."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
    ang = (pos.to(torch.float64)[:, None] * inv[None, :]).to(torch.float32)  # [T, D/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor, block: int = 512
) -> torch.Tensor:
    """Causal GQA attention, float32: ``q [T, H, D]`` at absolute positions
    ``q_pos [T]`` over keys ``k, v [Tk, KV, D]`` at positions ``0..Tk-1``.
    Queries go in blocks of ``block`` rows to bound the score matrix."""
    t, h, d = q.shape
    kv = k.shape[1]
    rep = h // kv
    scale = 1.0 / math.sqrt(d)
    kk = k.permute(1, 0, 2)                       # [KV, Tk, D]
    vv = v.permute(1, 0, 2)
    k_pos = torch.arange(k.shape[0], device=q.device)
    out = torch.empty((t, h, d), dtype=torch.float32, device=q.device)
    for s in range(0, t, block):
        n = min(block, t - s)
        qb = q[s : s + n].reshape(n, kv, rep, d).permute(1, 2, 0, 3).reshape(kv, rep * n, d)
        scores = (qb @ kk.transpose(1, 2)) * scale                 # [KV, rep·n, Tk]
        visible = k_pos[None, :] <= q_pos[s : s + n, None]          # [n, Tk]
        scores = scores.reshape(kv, rep, n, -1).masked_fill(~visible, float("-inf"))
        p = torch.softmax(scores, dim=-1).reshape(kv, rep * n, -1)
        ob = (p @ vv).reshape(kv, rep, n, d).permute(2, 0, 1, 3).reshape(n, h, d)
        out[s : s + n] = ob
    return out


def lm_head_rows(
    x: torch.Tensor, w: torch.Tensor, prec: Precision, cols: int = 32768
) -> torch.Tensor:
    """Logits ``[T, V]`` float32 of final hidden rows ``x [T, d]`` through
    the head ``w [d, V]``, taken ``cols`` vocabulary columns at a time so
    the float32 copy of the head never exists whole."""
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    xa = prec.act(x)
    for c in range(0, w.shape[1], cols):
        out[:, c : c + cols] = xa @ prec.weight(w[:, c : c + cols])
    return out


def split_heads(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(t.shape[0], n, -1)


class KV:
    """The float32 keys (after RoPE) and values of every layer for the
    tokens processed so far: what a later piece of the same sequence
    attends to.  Built and read only by the reference itself."""

    def __init__(self, n_layers: int):
        self.k = [None] * n_layers
        self.v = [None] * n_layers
        self.length = 0

    def extend(self, i: int, k: torch.Tensor, v: torch.Tensor):
        if self.k[i] is None:
            self.k[i], self.v[i] = k, v
        else:
            self.k[i] = torch.cat([self.k[i], k])
            self.v[i] = torch.cat([self.v[i], v])
        return self.k[i], self.v[i]

    def copy(self) -> "KV":
        out = KV(len(self.k))
        out.k, out.v, out.length = list(self.k), list(self.v), self.length
        return out


def attention_block(
    p: dict, x: torch.Tensor, pos: torch.Tensor, cfg: dict, kv: KV, i: int,
    prec: Precision, w32: Optional[dict] = None,
) -> torch.Tensor:
    """Self-attention of one layer on the new rows ``x [T, d]`` (already
    normed) at positions ``pos``: projections, optional per-head q/k norm,
    RoPE, causal GQA attention over the cached and new keys, output
    projection.  ``w32`` holds the layer's weights as ``prec`` multiplies
    them."""
    h, g = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    eps = cfg["rms_norm_eps"]
    q = split_heads(prec.linear(x, w32["wq"]), h)
    k = split_heads(prec.linear(x, w32["wk"]), g)
    v = split_heads(prec.linear(x, w32["wv"]), g)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], eps)
        k = rmsnorm(k, p["k_norm"], eps)
    q = rope(q, pos, cfg["rope_theta"])
    k = rope(k, pos, cfg["rope_theta"])
    kc, vc = kv.extend(i, k, v)
    o = causal_attention(q, kc, vc, pos)
    return prec.linear(o.reshape(o.shape[0], -1), w32["wo"])


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """``(silu(x @ wg) · (x @ wu)) @ wd`` with float32 weights from
    ``prec.weight``."""
    return prec.linear(torch.nn.functional.silu(prec.linear(x, wg)) * prec.linear(x, wu), wd)


def decoder_forward(
    weights: dict, cfg: dict, tokens: torch.Tensor, rows: torch.Tensor, prec: Precision,
    ffn, past: Optional[KV] = None,
):
    """A pre-norm decoder over the new ``tokens [T]`` (int64, on the
    weights' device) after the sequence ``past`` already holds: embedding,
    then per layer ``x += attn(norm(x))`` and ``x += ffn(norm(x))``, then
    the final norm and the head on the rows ``rows`` (indices into the new
    tokens) only.  ``ffn(layer_params, h, prec)`` is the family's
    feed-forward.  Layer by layer, so one layer's float32 weights exist at a
    time.  Returns ``(logits [len(rows), V] float32, kv)``, ``kv`` holding
    the keys and values of ``past`` and the new tokens."""
    kv = past.copy() if past is not None else KV(len(weights["layers"]))
    eps = cfg["rms_norm_eps"]
    pos = torch.arange(kv.length, kv.length + tokens.shape[0], device=tokens.device)
    x = weights["embed"][tokens].to(torch.float32)
    for i, p in enumerate(weights["layers"]):
        a = p["attn"]
        w32 = {name: prec.weight(a[name]) for name in ("wq", "wk", "wv", "wo")}
        x = x + attention_block(a, rmsnorm(x, p["ln_attn"], eps), pos, cfg, kv, i, prec, w32)
        del w32
        x = x + ffn(p, rmsnorm(x, p["ln_mlp"], eps), prec)
    kv.length += tokens.shape[0]
    h = rmsnorm(x[rows], weights["ln_final"], eps)
    return lm_head_rows(h, weights["lm_head"], prec), kv


def decoder_layout(cfg: dict, ffn) -> list:
    """The leaves ``(path, shape, dtype, std)`` of a pre-norm decoder in the
    order the weights are drawn: embedding, final norm, head, then per layer
    the two norms, the attention projections (``[d_in, d_out]``, scale
    ``1/sqrt(d_in)``, in the configuration's type), then ``ffn(layer_path,
    mat)``'s leaves.  Norm weights are float32."""
    dt = DTYPES[cfg["torch_dtype"]]
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h, g = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h

    def mat(path, d_in, d_out, lead=()):
        return (path, lead + (d_in, d_out), dt, 1.0 / math.sqrt(d_in))

    f32 = torch.float32
    out = [(("embed",), (v, d), dt, EMBED_STD), (("ln_final",), (d,), f32, NORM_STD),
           mat(("lm_head",), d, v)]
    for i in range(cfg["num_hidden_layers"]):
        L = ("layers", i)
        out += [(L + ("ln_attn",), (d,), f32, NORM_STD), (L + ("ln_mlp",), (d,), f32, NORM_STD),
                mat(L + ("attn", "wq"), d, h * hd), mat(L + ("attn", "wk"), d, g * hd),
                mat(L + ("attn", "wv"), d, g * hd), mat(L + ("attn", "wo"), h * hd, d)]
        out += ffn(L, mat)
    return out


def mlp_layout(prefix: tuple, mat, d: int, ff: int) -> list:
    return [mat(prefix + ("w_gate",), d, ff), mat(prefix + ("w_up",), d, ff),
            mat(prefix + ("w_down",), ff, d)]
