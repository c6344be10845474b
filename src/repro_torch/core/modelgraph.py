"""OpGraph builders: architectures → placement-ready computation graphs.

Two granularities:

* ``fine``   — one vertex per primitive op (matmul / bias_add / softmax /
  conv / bn / …), the granularity the paper's Table IV counts and GCOF
  coarsens.  Used by the benchmark harness (Swin / GPT-3 / AlphaFold2
  generators reproduce the paper's models) and by the fusion tests.
* ``layer``  — one vertex per transformer block sub-module (attention, mlp),
* ``block``  — one vertex per transformer block (attention+FFN fused), the
  granularity the serving stage-executor places across devices.

Each vertex carries FLOPs / HBM bytes / resident param bytes / output
payload so the cost model can specialize per device.  Counts are for
single-batch inference (the paper's setting: makespan of ONE input).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from .graph import OpGraph

BF16 = 2


def _matmul(g, name, x_in, m, k, n, batch=1, dtype=BF16, **kw):
    """Append a [m,k]@[k,n] matmul node; returns node id."""
    flops = 2.0 * batch * m * k * n
    out_b = batch * m * n * dtype
    return g.add(
        "matmul",
        inputs=[x_in] if x_in is not None else [],
        flops=flops,
        bytes_accessed=batch * (m * k + k * n + m * n) * dtype,
        param_bytes=k * n * dtype,
        output_bytes=out_b,
        meta={"name": name},
        **kw,
    )


def _elt(g, op, x_in, elems, dtype=BF16, extra_inputs=(), params=0.0):
    return g.add(
        op,
        inputs=[x_in, *extra_inputs] if x_in is not None else list(extra_inputs),
        flops=elems * 2.0,
        # params (norm gains etc.) are streamed with the activations — kept
        # inside bytes_accessed so token rescaling's invariant-weight share
        # (min(param_bytes, bytes_accessed)) is a true subset of the traffic
        bytes_accessed=elems * dtype * (2 + len(extra_inputs)) + params,
        param_bytes=params,
        output_bytes=elems * dtype,
    )


# --------------------------------------------------------------------------
# transformer families (the assigned archs + paper GPT-3)
# --------------------------------------------------------------------------


def transformer_graph(
    cfg: ModelConfig, *, seq_len: int, granularity: str = "fine"
) -> OpGraph:
    g = OpGraph(name=f"{cfg.name}-{granularity}")
    g.seq_len = seq_len
    s, d = seq_len, cfg.d_model
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    elems = s * d

    embed = g.add(
        "embed",
        flops=0.0,
        bytes_accessed=s * d * BF16,
        param_bytes=cfg.vocab_size * d * BF16,
        output_bytes=s * d * BF16,
    )
    x = embed

    # per-layer KV-cache residency: K and V tensors for the full sequence,
    # kept alive per in-flight request (multiplied by serving slots in Eq. 5)
    layer_kv_bytes = 2.0 * s * kv * hd * BF16

    if granularity in ("layer", "block"):
        for i in range(cfg.n_layers):
            # the 4·s²·h·hd score/context term is quadratic in the attended
            # span; recorded in meta so token rescaling (chunked prefill
            # costing) can bill it queries × keys instead of linearly
            attn_quad = 4.0 * s * s * h * hd
            attn_flops = 2.0 * s * d * (h * hd + 2 * kv * hd) + attn_quad + 2.0 * s * h * hd * d
            attn_params = (d * (h + 2 * kv) * hd + h * hd * d) * BF16
            a = g.add(
                "attention",
                inputs=[x],
                flops=attn_flops,
                bytes_accessed=4 * elems * BF16 + attn_params,
                param_bytes=attn_params,
                kv_bytes=layer_kv_bytes,
                output_bytes=elems * BF16,
                meta={"quad_flops": attn_quad},
            )
            if cfg.n_experts:
                e_act = cfg.top_k
                ff_flops = 6.0 * s * d * cfg.moe_d_ff * e_act
                ff_params = 3.0 * d * cfg.moe_d_ff * (cfg.n_experts_padded or cfg.n_experts) * BF16
                if cfg.dense_parallel_ff:
                    ff_flops += 6.0 * s * d * cfg.d_ff
                    ff_params += 3 * d * cfg.d_ff * BF16
                if cfg.n_shared_experts:
                    ff_flops += 6.0 * s * d * cfg.shared_d_ff
                    ff_params += 3 * d * cfg.shared_d_ff * BF16
            else:
                ff_flops = 6.0 * s * d * cfg.d_ff
                ff_params = 3.0 * d * cfg.d_ff * BF16
            if granularity == "block":
                # fold attention + FFN into one placeable block
                g.remove_node(a)
                x = g.add(
                    "block",
                    inputs=[x],
                    flops=attn_flops + ff_flops,
                    bytes_accessed=8 * elems * BF16 + attn_params + ff_params,
                    param_bytes=attn_params + ff_params,
                    kv_bytes=layer_kv_bytes,
                    output_bytes=elems * BF16,
                    meta={"quad_flops": attn_quad},
                )
            else:
                f = g.add(
                    "moe" if cfg.n_experts else "mlp",
                    inputs=[a],
                    flops=ff_flops,
                    bytes_accessed=4 * elems * BF16 + ff_params,
                    param_bytes=ff_params,
                    output_bytes=elems * BF16,
                )
                x = f
        g.add(
            "lm_head",
            inputs=[x],
            flops=2.0 * s * d * cfg.vocab_size,
            bytes_accessed=(s * d + d * cfg.vocab_size) * BF16,
            param_bytes=0.0 if cfg.tie_embeddings else d * cfg.vocab_size * BF16,
            output_bytes=s * cfg.vocab_size * BF16,
            # streamed once per pass whether or not the table is tied (tied
            # ⇒ param_bytes 0); token rescaling must not shrink it
            meta={"invariant_bytes": d * cfg.vocab_size * BF16},
        )
        g.validate()
        return g

    # ---- fine granularity --------------------------------------------------
    for i in range(cfg.n_layers):
        ln1 = _elt(g, "rmsnorm", x, elems, params=d * 4)
        q = _matmul(g, f"L{i}.wq", ln1, s, d, h * hd)
        # the K/V projections produce the cached tensors: each carries half the
        # layer's per-request KV residency
        k = _matmul(g, f"L{i}.wk", ln1, s, d, kv * hd, kv_bytes=layer_kv_bytes / 2)
        v = _matmul(g, f"L{i}.wv", ln1, s, d, kv * hd, kv_bytes=layer_kv_bytes / 2)
        qr = _elt(g, "rope", q, s * h * hd)
        kr = _elt(g, "rope", k, s * kv * hd)
        # score/context matmuls and the mask/softmax between them are
        # quadratic in the attended span — meta records each node's
        # quadratic flops/bytes share so token rescaling bills them
        # queries × keys (scale_node_to_tokens)
        scores = g.add(
            "matmul",  # q·kᵀ
            inputs=[qr, kr],
            flops=2.0 * s * s * h * hd,
            bytes_accessed=(2 * s * h * hd + s * s * h) * BF16,
            output_bytes=s * s * h * BF16,
            # quad_out_bytes: the s×s output payload itself is quadratic, so
            # a stage cut right after this node bills its comm queries × keys
            # too (scale_edge_bytes), not linearly in the chunk
            meta={"quad_flops": 2.0 * s * s * h * hd,
                  "quad_bytes": s * s * h * BF16,
                  "quad_out_bytes": s * s * h * BF16},
        )
        msk = _elt(g, "mask", scores, s * s * h)
        sm = _elt(g, "softmax", msk, s * s * h)
        for _q in (msk, sm):   # elementwise over the s×s score matrix
            g.nodes[_q].meta.update(
                quad_flops=g.nodes[_q].flops,
                quad_bytes=g.nodes[_q].bytes_accessed,
                quad_out_bytes=g.nodes[_q].output_bytes,
            )
        ctx = g.add(
            "matmul",  # probs·V
            inputs=[sm, v],
            flops=2.0 * s * s * h * hd,
            bytes_accessed=(s * s * h + 2 * s * h * hd) * BF16,
            output_bytes=s * h * hd * BF16,
            meta={"quad_flops": 2.0 * s * s * h * hd,
                  "quad_bytes": s * s * h * BF16},
        )
        wo = _matmul(g, f"L{i}.wo", ctx, s, h * hd, d)
        res1 = _elt(g, "add", wo, elems, extra_inputs=(x,))

        ln2 = _elt(g, "rmsnorm", res1, elems, params=d * 4)
        if cfg.n_experts:
            router = _matmul(g, f"L{i}.router", ln2, s, d, cfg.n_experts)
            branches = []
            e_pad = cfg.n_experts_padded or cfg.n_experts
            # parallel expert branches (top_k share of tokens each); model a
            # capped number of explicit branches to keep the graph tractable
            n_branch = min(e_pad, 8)
            tok_frac = cfg.top_k / n_branch
            for e in range(n_branch):
                ge = _matmul(g, f"L{i}.e{e}.gate", router, int(s * tok_frac) or 1, d, cfg.moe_d_ff)
                ue = _matmul(g, f"L{i}.e{e}.up", router, int(s * tok_frac) or 1, d, cfg.moe_d_ff)
                act = _elt(g, "silu", ge, int(s * tok_frac * cfg.moe_d_ff) or 1)
                mul = _elt(g, "mul", act, int(s * tok_frac * cfg.moe_d_ff) or 1, extra_inputs=(ue,))
                de = _matmul(g, f"L{i}.e{e}.down", mul, int(s * tok_frac) or 1, cfg.moe_d_ff, d)
                branches.append(de)
            comb = _elt(g, "add", branches[0], elems, extra_inputs=tuple(branches[1:]))
            ff_out = comb
            if cfg.dense_parallel_ff:
                dg = _matmul(g, f"L{i}.dense.gate", ln2, s, d, cfg.d_ff)
                du = _matmul(g, f"L{i}.dense.up", ln2, s, d, cfg.d_ff)
                da = _elt(g, "silu", dg, s * cfg.d_ff)
                dm = _elt(g, "mul", da, s * cfg.d_ff, extra_inputs=(du,))
                dd = _matmul(g, f"L{i}.dense.down", dm, s, cfg.d_ff, d)
                ff_out = _elt(g, "add", comb, elems, extra_inputs=(dd,))
        else:
            gate = _matmul(g, f"L{i}.gate", ln2, s, d, cfg.d_ff)
            up = _matmul(g, f"L{i}.up", ln2, s, d, cfg.d_ff)
            act = _elt(g, "silu" if cfg.activation == "silu" else "gelu", gate, s * cfg.d_ff)
            mul = _elt(g, "mul", act, s * cfg.d_ff, extra_inputs=(up,))
            ff_out = _matmul(g, f"L{i}.down", mul, s, cfg.d_ff, d)
        x = _elt(g, "add", ff_out, elems, extra_inputs=(res1,))

    fln = _elt(g, "rmsnorm", x, elems, params=d * 4)
    _matmul(g, "lm_head", fln, s, d, cfg.vocab_size)
    g.validate()
    return g


# --------------------------------------------------------------------------
# paper models: GPT-3 variants, Swin-Transformer, AlphaFold2 (Table IV)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PaperModel:
    name: str
    layers: int
    hidden: int
    heads: int
    kind: str  # "gpt3" | "swin" | "alphafold2"


PAPER_MODELS: Dict[str, PaperModel] = {
    # GPT-3 {330M, 1.3B, 2.7B, 13B}
    "gpt3-330m": PaperModel("gpt3-330m", 24, 1024, 16, "gpt3"),
    "gpt3-1.3b": PaperModel("gpt3-1.3b", 32, 2048, 32, "gpt3"),
    "gpt3-2.7b": PaperModel("gpt3-2.7b", 32, 2560, 32, "gpt3"),
    "gpt3-13b": PaperModel("gpt3-13b", 40, 5120, 40, "gpt3"),
    # Swin-Transformer {1.8B, 6.6B, 13B}
    "swin-1.8b": PaperModel("swin-1.8b", 32, 512, 16, "swin"),
    "swin-6.6b": PaperModel("swin-6.6b", 48, 768, 24, "swin"),
    "swin-13b": PaperModel("swin-13b", 56, 1024, 32, "swin"),
    # AlphaFold2 {87M, 930M, 2.4B, 3.2B}
    "af2-87m": PaperModel("af2-87m", 48, 256, 8, "alphafold2"),
    "af2-930m": PaperModel("af2-930m", 64, 512, 16, "alphafold2"),
    "af2-2.4b": PaperModel("af2-2.4b", 96, 1024, 32, "alphafold2"),
    "af2-3.2b": PaperModel("af2-3.2b", 128, 1024, 32, "alphafold2"),
}


def gpt3_graph(pm: PaperModel, seq_len: int = 2048) -> OpGraph:
    cfg = ModelConfig(
        name=pm.name, family="dense", n_layers=pm.layers, d_model=pm.hidden,
        n_heads=pm.heads, n_kv_heads=pm.heads, d_ff=4 * pm.hidden,
        vocab_size=50257, activation="gelu",
    )
    return transformer_graph(cfg, seq_len=seq_len)


def swin_graph(pm: PaperModel, img: int = 1100, patch: int = 4, win: int = 7) -> OpGraph:
    """Swin: conv patch-embed + windowed-attention stages with conv/bn
    (patch-merging) between — emits the conv/bn/add/relu chains the paper's
    Eigen rules fuse."""
    g = OpGraph(name=pm.name)
    tokens = (img // patch) ** 2
    d = pm.hidden
    x = g.add(
        "conv",
        flops=2.0 * tokens * d * 3 * patch * patch,
        bytes_accessed=tokens * d * BF16 * 3,
        param_bytes=3 * patch * patch * d * BF16,
        output_bytes=tokens * d * BF16,
    )
    x = _elt(g, "bn", x, tokens * d, params=d * 4 * 2)
    stage_tokens, stage_d = tokens, d
    per_stage = max(pm.layers // 4, 1)
    for stage in range(4):
        for i in range(per_stage):
            s_local = stage_tokens
            elems = s_local * stage_d
            ln1 = _elt(g, "layernorm", x, elems, params=stage_d * 8)
            q = _matmul(g, f"s{stage}L{i}.q", ln1, s_local, stage_d, stage_d)
            k = _matmul(g, f"s{stage}L{i}.k", ln1, s_local, stage_d, stage_d)
            v = _matmul(g, f"s{stage}L{i}.v", ln1, s_local, stage_d, stage_d)
            sc = g.add(
                "matmul", inputs=[q, k],
                flops=2.0 * s_local * win * win * stage_d,
                bytes_accessed=3 * elems * BF16,
                output_bytes=s_local * win * win * pm.heads * BF16,
            )
            sm = _elt(g, "softmax", sc, s_local * win * win * pm.heads)
            ctx = g.add(
                "matmul", inputs=[sm, v],
                flops=2.0 * s_local * win * win * stage_d,
                bytes_accessed=3 * elems * BF16,
                output_bytes=elems * BF16,
            )
            wo = _matmul(g, f"s{stage}L{i}.o", ctx, s_local, stage_d, stage_d)
            res = _elt(g, "add", wo, elems, extra_inputs=(ln1,))
            ln2 = _elt(g, "layernorm", res, elems, params=stage_d * 8)
            f1 = _matmul(g, f"s{stage}L{i}.f1", ln2, s_local, stage_d, 4 * stage_d)
            a1 = _elt(g, "gelu", f1, s_local * 4 * stage_d)
            f2 = _matmul(g, f"s{stage}L{i}.f2", a1, s_local, 4 * stage_d, stage_d)
            x = _elt(g, "add", f2, elems, extra_inputs=(res,))
        if stage < 3:
            # patch merging: conv + bn + relu (the Eigen-fusible chain)
            stage_tokens //= 4
            stage_d *= 2
            c = g.add(
                "conv", inputs=[x],
                flops=2.0 * stage_tokens * stage_d * stage_d * 4,
                bytes_accessed=stage_tokens * stage_d * BF16 * 4,
                param_bytes=4 * stage_d * stage_d * BF16,
                output_bytes=stage_tokens * stage_d * BF16,
            )
            b = _elt(g, "bn", c, stage_tokens * stage_d, params=stage_d * 8)
            x = _elt(g, "relu", b, stage_tokens * stage_d)
    _matmul(g, "head", x, 1, stage_d, 1000)
    g.validate()
    return g


def alphafold2_graph(pm: PaperModel, n_res: int = 128) -> OpGraph:
    """Evoformer-style: parallel MSA-row / MSA-col / pair branches per block
    with triangle updates — the branch-parallel structure that rewards
    multi-device placement (paper §IV-D)."""
    g = OpGraph(name=pm.name)
    d = pm.hidden
    s = n_res
    msa = g.add("embed", flops=0, bytes_accessed=s * d * BF16,
                param_bytes=22 * d * BF16, output_bytes=s * d * BF16)
    pair = g.add("embed", flops=0, bytes_accessed=s * s * BF16,
                 param_bytes=d * d * BF16, output_bytes=s * s * (d // 4) * BF16)
    for i in range(pm.layers):
        # MSA row attention (gated)
        ln_m = _elt(g, "layernorm", msa, s * d, params=d * 8)
        qm = _matmul(g, f"B{i}.rq", ln_m, s, d, d)
        km = _matmul(g, f"B{i}.rk", ln_m, s, d, d)
        vm = _matmul(g, f"B{i}.rv", ln_m, s, d, d)
        scm = g.add("matmul", inputs=[qm, km], flops=2.0 * s * s * d,
                    bytes_accessed=3 * s * d * BF16, output_bytes=s * s * pm.heads * BF16)
        # pair bias joins the MSA branch (cross-branch edge)
        bias = _matmul(g, f"B{i}.bias", pair, s, d // 4, pm.heads)
        scb = _elt(g, "add", scm, s * s * pm.heads, extra_inputs=(bias,))
        smm = _elt(g, "softmax", scb, s * s * pm.heads)
        ctx = g.add("matmul", inputs=[smm, vm], flops=2.0 * s * s * d,
                    bytes_accessed=3 * s * d * BF16, output_bytes=s * d * BF16)
        om = _matmul(g, f"B{i}.ro", ctx, s, d, d)
        msa1 = _elt(g, "add", om, s * d, extra_inputs=(msa,))
        # MSA transition
        t1 = _matmul(g, f"B{i}.t1", msa1, s, d, 4 * d)
        ta = _elt(g, "relu", t1, s * 4 * d)
        t2 = _matmul(g, f"B{i}.t2", ta, s, 4 * d, d)
        msa = _elt(g, "add", t2, s * d, extra_inputs=(msa1,))
        # pair triangle updates (parallel branch)
        lp = _elt(g, "layernorm", pair, s * s * (d // 4), params=d * 2)
        tri1 = _matmul(g, f"B{i}.tri_out", lp, s * s, d // 4, d // 4)
        tri2 = _matmul(g, f"B{i}.tri_in", lp, s * s, d // 4, d // 4)
        trim = _elt(g, "mul", tri1, s * s * (d // 4), extra_inputs=(tri2,))
        trio = _matmul(g, f"B{i}.tri_o", trim, s * s, d // 4, d // 4)
        pair = _elt(g, "add", trio, s * s * (d // 4), extra_inputs=(pair,))
    # structure head
    _matmul(g, "structure", msa, s, d, 3)
    g.validate()
    return g


def paper_graph(name: str, **kw) -> OpGraph:
    pm = PAPER_MODELS[name]
    if pm.kind == "gpt3":
        return gpt3_graph(pm, **kw)
    if pm.kind == "swin":
        return swin_graph(pm, **kw)
    return alphafold2_graph(pm, **kw)
