"""Config schema for the model zoo and the input-shape grid.

One ``ModelConfig`` dataclass covers every assigned architecture family
(dense / MoE / enc-dec / VLM / SSM / hybrid); family-specific fields are
ignored elsewhere.  ``smoke()`` derives the reduced-size variant used by CPU
smoke tests; the full config is only ever traced via ShapeDtypeStruct in the
multi-pod dry-run.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | encdec | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # --- attention flavour -------------------------------------------------
    rope_theta: float = 10000.0
    qk_norm: bool = False                    # qwen3
    attn_softcap: Optional[float] = None     # gemma2 (50.0)
    logit_softcap: Optional[float] = None    # gemma2 (30.0)
    sliding_window: Optional[int] = None     # gemma2 local layers
    local_global_pattern: Optional[str] = None  # e.g. "LG" repeated (gemma2)
    post_block_norm: bool = False            # gemma2 post-norms
    activation: str = "silu"                 # silu | geglu | gelu
    tie_embeddings: bool = False
    scale_embed: bool = False                # gemma family: x *= sqrt(d_model)
    attn_logit_scale: Optional[float] = None  # override 1/sqrt(head_dim)

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_experts_padded: int = 0                # padded for EP divisibility
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0                # qwen2-moe shared experts
    shared_d_ff: int = 0
    dense_parallel_ff: bool = False          # arctic: dense FFN residual ∥ MoE
    router_norm_topk: bool = True
    capacity_factor: float = 1.25

    # --- enc-dec (seamless) --------------------------------------------------
    n_encoder_layers: int = 0

    # --- VLM / audio frontends (stubs per assignment) -------------------------
    frontend: str = "none"                   # none | patch_stub | frame_stub
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE

    # --- SSM (mamba2 / zamba2) -------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ngroups: int = 1

    # --- hybrid (zamba2) -------------------------------------------------------
    shared_attn_every: int = 0               # insert shared attn block every N layers

    # --- parallelism policy --------------------------------------------------
    # pure DP×EP layout: replicate dense trunk, shard batch over (data, model)
    # and experts over data — right for small-active MoE where TP psums
    # dominate (see EXPERIMENTS.md §Perf / qwen2-moe iteration 2)
    prefer_pure_dp: bool = False
    # weight-gathered MoE: slice tokens over the TP axis inside the MoE block
    # and all-gather expert weights instead of running the (identical)
    # all-to-all on every TP rank — wins when tokens·D ≫ expert bytes
    # (see EXPERIMENTS.md §Perf / arctic iteration)
    moe_gather_weights: bool = False

    # --- numerics / impl ---------------------------------------------------------
    dtype: str = "bfloat16"
    attention_impl: str = "chunked"          # chunked | naive | pallas
    attn_chunk: int = 1024
    remat: bool = True
    scan_layers: bool = True

    # --------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM state or hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # no encoder-only arch in the assigned pool

    def smoke(self) -> "ModelConfig":
        """Reduced config of the same family for CPU smoke tests."""
        half = 32 // 2  # smoke head_dim = 32
        smoke_sections = (
            (half // 4, half * 3 // 8, half - half // 4 - half * 3 // 8)
            if self.mrope_sections is not None
            else None
        )
        return replace(
            self,
            mrope_sections=smoke_sections,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_experts_padded=min(self.n_experts_padded, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            n_shared_experts=min(self.n_shared_experts, 2),
            shared_d_ff=128 if self.shared_d_ff else 0,
            sliding_window=64 if self.sliding_window else None,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=16 if self.ssm_state else 128,
            shared_attn_every=min(self.shared_attn_every, 2) if self.shared_attn_every else 0,
            attn_chunk=64,
            dtype="float32",
            scan_layers=False,
            remat=False,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


# The assigned LM shape grid (seq_len × global_batch); decode_* / long_* lower
# serve_step (one new token against a KV cache of seq_len), not train_step.
SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}


def smoke_shape(kind: str = "train") -> ShapeConfig:
    return ShapeConfig(f"smoke_{kind}", seq_len=64, global_batch=2, kind=kind)
