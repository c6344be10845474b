"""Decoder-only transformer stack of the port, with a dense or paged KV
cache and the entry points the serving path calls: ``prefill``,
``prefill_chunked``, ``decode_step`` and ``fused_step``; and the trainer's,
``train_forward`` (no cache, returns the MoE load-balancing loss).

Family wiring:

* dense — llama3.2-1b, qwen3-14b (qk-norm), gemma-7b (GeGLU, head 256),
  gemma2-27b (local/global windows, softcaps, post-norms);
* vlm — qwen2-vl-7b: the dense stack with M-RoPE; the vision tower is a
  stub (as in the reference), so patch and text embeddings arrive
  precomputed as ``batch["embeds"]`` ``[B, S, d_model]``, with optional
  ``batch["positions"]`` ``[3, B, S]`` (t, h, w) streams (default: all
  three equal to the token index);
* moe — qwen2-moe-a2.7b (60 routed experts padded to 64, top-4, plus the
  shared experts merged into one FFN), arctic-480b (128 experts top-2 with
  a dense FFN in parallel): the routed experts go through
  :func:`repro_torch.models.moe.moe_apply`;
* ssm — mamba2-130m (attention-free Mamba2 stack,
  :mod:`repro_torch.models.ssm`);
* hybrid — zamba2-2.7b (Mamba2 trunk in segments of ``shared_attn_every``
  layers, each followed by one *shared-weight* attention block on
  ``concat(hidden, embedding)``, each occurrence with its own KV cache).

Parameters hold one dict per layer (``params["layers"]``, and the
hybrid's ``params["mamba_layers"]``, are lists), the serving layout,
whatever ``cfg.scan_layers`` says; ``remat`` is a training knob: the
training forward, :func:`train_forward`, recomputes each block in the
backward pass when it is set (``torch.utils.checkpoint``, the counterpart
of ``jax.checkpoint``).  The dense/MoE KV cache is ``{"layers": {"k",
"v"}}`` with one ``[L, B, max_len, KV, hd]`` tensor each (dense) or one
``[L, num_pages + 1, P, KV, hd]`` page pool each (paged, with the page
table passed to every forward as ``page_table``).  The SSM cache is
``{"layers": {"conv_x", "conv_B", "conv_C", "ssm"}}`` stacked over the
layers (not paged: the state is O(1) per slot); the hybrid's is
``{"mamba": <that>, "attn": {"k", "v"}}`` with one dense row or page pool
per shared-block occurrence.  Every cache is updated in place.  The enc-dec
family has its own stack, :mod:`repro_torch.models.encdec`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.parallel.context import current_context, is_dtensor, parallel_context, shard_hint
from repro_torch.parallel.sharding import cache_on_mesh
from repro_torch.parallel.vocab import embed_lookup
from .layers import Params, uses_kernels, mlp, multihead_attention, rmsnorm, softcap
from .moe import moe_apply
from .ssm import layer_state, mamba2_block, stacked_init_state, store_state

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _TORCH_DTYPES[cfg.dtype]


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family this decoder-only stack does not run: enc-dec has
    its own (:mod:`repro_torch.models.encdec`), anything else is unknown."""
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid"):
        raise ValueError(
            f"family {cfg.family!r} ({cfg.name}) does not run on the decoder-only stack"
            + (": use repro_torch.models.encdec" if cfg.family == "encdec" else "")
        )


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer attention window.  gemma2 alternates Local/Global; global
    layers get a huge window (≡ full attention)."""
    big = 1 << 30
    if cfg.sliding_window is None:
        return [big] * cfg.n_layers
    pattern = cfg.local_global_pattern or "LG"
    return [
        cfg.sliding_window if pattern[i % len(pattern)] == "L" else big
        for i in range(cfg.n_layers)
    ]


def block_apply(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    window: int,
    kv_cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos=None,
    q_lens: Optional[torch.Tensor] = None,   # [B] fused-batch valid rows
    with_aux: bool = False,
) -> Tuple[Any, ...]:
    """One transformer block; returns (x, new_cache), and the MoE router's
    load-balancing loss third with ``with_aux=True`` (0 for a dense FFN)."""
    kernels = uses_kernels(cfg)
    h = rmsnorm(x, p["ln_attn"], kernel=kernels)
    attn_out, new_cache = multihead_attention(
        p["attn"], h, cfg,
        positions=positions,
        kv_cache=kv_cache,
        cache_pos=cache_pos,
        layer_window=window,
        q_lens=q_lens,
    )
    if cfg.post_block_norm:
        attn_out = rmsnorm(attn_out, p["ln_attn_post"], kernel=kernels)
    x = x + attn_out

    h = rmsnorm(x, p["ln_mlp"], kernel=kernels)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        ff_out = moe_apply(p["moe"], h, cfg, kernel=kernels, with_aux=with_aux)
        if with_aux:
            ff_out, aux = ff_out
        if "mlp" in p:                       # arctic: dense FFN in parallel
            ff_out = ff_out + mlp(p["mlp"], h, cfg.activation)
        if "shared_mlp" in p:                # qwen2-moe shared experts
            ff_out = ff_out + mlp(p["shared_mlp"], h, cfg.activation)
    else:
        ff_out = mlp(p["mlp"], h, cfg.activation)
    if cfg.post_block_norm:
        ff_out = rmsnorm(ff_out, p["ln_mlp_post"], kernel=kernels)
    if with_aux:
        return x + ff_out, new_cache, aux
    return x + ff_out, new_cache


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def _n_shared(cfg: ModelConfig) -> int:
    """Occurrences of the hybrid's shared attention block."""
    return cfg.n_layers // cfg.shared_attn_every


def _zeros_kv(shape, dt, device) -> Dict[str, torch.Tensor]:
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Params:
    """Dense cache, zeros, on ``device`` (default: the first card): KV rows,
    the SSM family's recurrent state, or the hybrid's both.  Under a
    parallel context on a real mesh: DTensors laid out by
    ``cache_pspec_tree``, each rank holding its shard.  That layout holds
    the SSM state's ``ssm`` and ``conv_x`` whole over "model", as the
    reference's step takes them; where the rules cut the Mamba trunk by
    heads, the first forward replaces those two entries of the state dict
    by copies cut over "model" (``_mamba_on_mesh``), the layout in which
    the reference's step leaves its new state, and they stay so."""
    check_family(cfg)
    on_mesh = cache_on_mesh(cfg, _dense_cache(cfg, batch, max_len, "meta"), batch, max_len)
    if on_mesh is not None:
        return on_mesh
    return _dense_cache(cfg, batch, max_len, resolve_device(device))


def _dense_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    dt = torch_dtype(cfg)
    kv_shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.family == "ssm":
        return {"layers": stacked_init_state(cfg, batch, dt, device, cfg.n_layers)}
    if cfg.family == "hybrid":
        return {
            "mamba": stacked_init_state(cfg, batch, dt, device, cfg.n_layers),
            "attn": _zeros_kv((_n_shared(cfg),) + kv_shape, dt, device),
        }
    return {"layers": _zeros_kv((cfg.n_layers,) + kv_shape, dt, device)}


def init_paged_cache(
    cfg: ModelConfig, batch: int, num_pages: int, page_tokens: int, device=None
) -> Params:
    """Paged KV cache, zeros, on ``device`` (default: the first card):
    per-layer page pools ``[num_pages + 1, P, KV, hd]``, the ``+1`` being
    the trash page that absorbs masked and out-of-range writes.  The
    per-slot page table is not part of the cache: it is host-owned
    (``serving.kv_pool``) and rides into each forward as ``page_table``.
    For dense and MoE models ``batch`` is unused (pools are shared by every
    row); it is kept for the reference's signature.  The SSM family's state
    is not paged (it is O(1) per slot): its cache is :func:`init_cache`'s;
    the hybrid pages only its shared-attention KV, and ``batch`` sizes its
    Mamba state."""
    check_family(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cfg)
    pool_shape = (num_pages + 1, page_tokens, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.family == "ssm":
        return init_cache(cfg, batch, 0, device)
    if cfg.family == "hybrid":
        return {
            "mamba": stacked_init_state(cfg, batch, dt, device, cfg.n_layers),
            "attn": _zeros_kv((_n_shared(cfg),) + pool_shape, dt, device),
        }
    return {"layers": _zeros_kv((cfg.n_layers,) + pool_shape, dt, device)}


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------


def _uses_embeds(cfg: ModelConfig) -> bool:
    """Whether the model reads stub-frontend embeddings, not tokens."""
    return cfg.frontend in ("patch_stub", "frame_stub")


def _batch_shape(batch, cfg: ModelConfig) -> Tuple[int, int]:
    return tuple((batch["embeds"] if _uses_embeds(cfg) else batch["tokens"]).shape[:2])


def _embed_in(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Token or stub-frontend embedding + positions (``[3, B, S]`` streams
    for M-RoPE: the batch's own, or the token index in all three)."""
    embed = params["embed"]
    if _uses_embeds(cfg):
        x = batch["embeds"].to(device=embed.device, dtype=torch_dtype(cfg))
    elif is_dtensor(embed):
        # on a mesh: the index gather on each rank's vocab rows
        # (parallel/vocab.py); DTensor's own rule would gather the table
        x = embed_lookup(embed, batch["tokens"])
    else:
        x = embed[batch["tokens"].to(device=embed.device, dtype=torch.int64)]
    b, s = x.shape[0], x.shape[1]
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    if cfg.mrope_sections is not None:
        positions = batch.get("positions")
        if positions is None:
            pos1 = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
            positions = torch.stack([pos1, pos1, pos1])
        positions = torch.as_tensor(positions).to(device=x.device, dtype=torch.int32)
    else:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    return shard_hint(x, "batch", None, "embed"), positions


def _logits_out(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, params["ln_final"], kernel=uses_kernels(cfg))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return shard_hint(softcap(x @ head, cfg.logit_softcap), "batch", None, "vocab")


def _dense_stack(params, x, cfg, positions, caches, cache_pos, q_lens=None, page_table=None):
    """Loop over transformer layers; returns (x, caches)."""
    windows = _layer_windows(cfg)
    for i, layer_p in enumerate(params["layers"]):
        cache_i = (
            {"k": caches["layers"]["k"][i], "v": caches["layers"]["v"][i]}
            if caches
            else None
        )
        if cache_i is not None and page_table is not None:
            # paged KV: one [B, pages_per_slot] table shared by every layer
            # (each layer has its own pool, indexed by the same page ids)
            cache_i["table"] = page_table
        x, _ = block_apply(
            layer_p, x, cfg,
            positions=positions, window=windows[i],
            kv_cache=cache_i, cache_pos=cache_pos, q_lens=q_lens,
        )
    # the per-layer caches are views of the stacked tensors, written in place
    return x, caches


def _mamba_layer(layer_p, x, cfg, stack, i, cont, q_lens):
    """Pre-norm residual Mamba2 layer ``i``.  ``cont`` = continuation
    (decode step or a chunked-prefill chunk): the recurrent state carries
    in from ``stack`` and :func:`mamba2_block` picks the single-token or
    the chunk path from the sequence length; otherwise a fresh prefill
    (zero state).  The new state is written into ``stack`` in place (the
    scan writes its final state straight into the layer's slice)."""
    kernels = uses_kernels(cfg)
    h = rmsnorm(x, layer_p["ln"], kernel=kernels)
    if is_dtensor(h):
        return x + _mamba_on_mesh(layer_p["mamba"], h, cfg, stack=stack, i=i, cont=cont)
    out, new_state = mamba2_block(
        layer_p["mamba"], h, cfg,
        state=layer_state(stack, i) if cont else None,
        seq_lens=q_lens if cont else None, kernel=kernels, ssm_out=stack["ssm"][i],
    )
    store_state(stack, i, new_state)
    return x + out


def _ssm_stack(params, x, cfg, caches, cache_pos=None, q_lens=None):
    """Loop over Mamba2 layers; ``cache_pos`` given = continuation, ``None``
    = fresh whole-prompt prefill."""
    for i, layer_p in enumerate(params["layers"]):
        x = _mamba_layer(layer_p, x, cfg, caches["layers"], i, cache_pos is not None, q_lens)
    return x, caches


def _hybrid_stack(params, x, x_embed, cfg, positions, caches, cache_pos, q_lens=None,
                  page_table=None):
    """Zamba2: the Mamba2 trunk in segments of ``shared_attn_every`` layers,
    each followed by the shared attention block on ``concat(x, x_embed) @
    shared_proj_in`` (full window, its own KV slot per occurrence, the page
    table injected when paged).  ``cache_pos`` as :func:`_ssm_stack`; a
    fresh prefill writes its KV from position 0."""
    every = cfg.shared_attn_every
    cont = cache_pos is not None
    attn_pos = cache_pos if cont else torch.zeros((), dtype=torch.int32, device=x.device)
    for seg in range(_n_shared(cfg)):
        for i in range(seg * every, (seg + 1) * every):
            x = _mamba_layer(params["mamba_layers"][i], x, cfg, caches["mamba"], i, cont, q_lens)
        u = torch.cat([x, x_embed], dim=-1) @ params["shared_proj_in"]
        cache_i = {"k": caches["attn"]["k"][seg], "v": caches["attn"]["v"][seg]}
        if page_table is not None:
            cache_i["table"] = page_table
        u, _ = block_apply(
            params["shared_block"], u, cfg,
            positions=positions, window=1 << 30,
            kv_cache=cache_i, cache_pos=attn_pos, q_lens=q_lens,
        )
        x = x + u
    return x, caches


def forward(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    caches: Optional[Params] = None,
    cache_pos=None,
    q_lens: Optional[torch.Tensor] = None,
    page_table=None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (logits [B,S,V], caches).  ``page_table`` ``[B,
    pages_per_slot]`` int32 switches KV reads and writes to the page pools
    of a paged cache.

    On a mesh, a batch that the ``batch`` rule's mesh axes do not divide
    runs with its activations whole over them: every rank of those axes
    computes every row (``B`` rows where an even cut would give it
    ``⌈B / n⌉``), as its cache (``cache_pspec_tree``: whole over the data
    axes for such a batch) and logits hold them.  The reference's
    partitioner pads such a batch instead."""
    check_family(cfg)
    ctx = current_context()
    if ctx is not None and ctx.mesh is not None and ctx.mesh.device_mesh is not None:
        cut = ctx.rules.get("batch")
        if cut is not None and _batch_shape(batch, cfg)[0] % ctx.axis_size(cut):
            with parallel_context(ctx.with_rules(batch=None)):
                return forward(params, batch, cfg, caches=caches, cache_pos=cache_pos,
                               q_lens=q_lens, page_table=page_table)
    x, positions = _embed_in(params, batch, cfg)
    if cache_pos is not None:
        # a [B] cache_pos carries one depth per row (ragged batches): each
        # row's positions, causal mask and KV write index follow it
        cp = torch.as_tensor(cache_pos).to(device=x.device, dtype=torch.int32)
        if cp.ndim == 0:
            positions = positions + cp
        elif cfg.mrope_sections is not None:       # positions: [3, B, S]
            positions = positions + cp[None, :, None]
        else:                                      # positions: [B, S]
            positions = positions + cp[:, None]
        cache_pos = cp
    if q_lens is not None:
        q_lens = torch.as_tensor(q_lens).to(device=x.device, dtype=torch.int32)
    if page_table is not None:
        page_table = torch.as_tensor(page_table).to(device=x.device, dtype=torch.int32)
    if cfg.family == "ssm":
        if caches is None:
            caches = init_cache(cfg, x.shape[0], 0, device=x.device)
        x, new_caches = _ssm_stack(params, x, cfg, caches, cache_pos, q_lens)
    elif cfg.family == "hybrid":
        if caches is None:
            caches = init_cache(cfg, x.shape[0], x.shape[1], device=x.device)
        x, new_caches = _hybrid_stack(
            params, x, x, cfg, positions, caches, cache_pos, q_lens, page_table
        )
    else:
        x, new_caches = _dense_stack(
            params, x, cfg, positions, caches, cache_pos, q_lens, page_table
        )
    return _logits_out(params, x, cfg), new_caches


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a config whose forward runs the port's hand-written
    kernels: they are forward-only (no autograd rule), and the reference
    has no backward kernel either (no ``custom_vjp``; eager ``jax.grad``
    through its Pallas flash kernel raises, and its jitted step falls back
    to ``chunked``).  Train at ``attention_impl="chunked"`` or
    ``"naive"``."""
    if uses_kernels(cfg):
        raise ValueError(
            f"{cfg.name}: attention_impl='pallas' runs the hand-written CUDA kernels, which "
            "are forward-only (no backward kernel, no autograd rule); the reference's jitted "
            "train step trains on 'chunked' too. Train with attention_impl='chunked'"
        )


def remat(fn, on: bool):
    """``fn``, recomputed in the backward pass when ``on`` (a block's
    activations are not kept for backward).  The recomputation runs under
    the parallel context of the forward pass: the backward of CUDA tensors
    runs on autograd's device thread, which the context (thread-local)
    does not reach."""
    if not on:
        return fn

    def run(*args):
        ctx = current_context()

        def body(*a):
            if ctx is None:
                return fn(*a)
            with parallel_context(ctx):
                return fn(*a)

        return checkpoint(body, *args, use_reentrant=False)

    return run


def _mamba_on_mesh(p: Params, x, cfg: ModelConfig, *, stack=None, i: int = 0,
                   cont: bool = False):
    """A Mamba2 block on a mesh, laid out as the reference's rules lay its
    weights (``parallel/sharding.py``).  Where they cut the trunk over a
    mesh dim (its head count divides it), each rank runs
    :func:`mamba2_block` on its own heads with its own weight shards: z,
    x and dt from its columns of w_z, w_x and w_dt, the causal conv on its
    channels of conv_x, the SSD scan on its heads, B and C whole from the
    replicated w_B, w_C and conv_B/C; the gated norm's sums are
    all-reduced over that dim (:func:`~repro_torch.models.ssm.gated_norm`)
    and ``y @ out_proj`` on the rank's rows of out_proj is a partial sum,
    all-reduced at the ``embed`` hint, as ``mlp``'s.  Where the rules
    replicate the trunk it runs whole on each rank's batch rows, its
    weights whole at rest (nothing is gathered).

    Gradients: a weight cut over the dim keeps its own gradient; a
    replicated one receives a gradient partial over it (each rank
    differentiates its own heads), and every weight's is partial over the
    dims that cut the batch.  The input's gradient is partial over the cut
    dim and is all-reduced at the block's input hint.

    With a ``stack`` (a state cache of DTensors ``[L, B, ...]``, its batch
    laid out as ``x``'s) layer ``i``'s state is read (``cont``: a
    continuation) and written in place.  Each rank holds the state of its
    own heads: the first block that cuts them re-lays the stack's ``ssm``
    ``[L, B, H, P, N]`` and ``conv_x`` ``[L, B, W-1, d_inner]`` (whole over
    the dim by ``cache_pspec_tree``) cut over it, each rank keeping a copy
    of its part — no collective, as in the reference's compiled step,
    which leaves the new state cut where its partitioner computed it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.launch.mesh import group_of

    x = shard_hint(x, "batch", None, "embed")
    mesh = x.device_mesh
    cut = [m for m, pl in enumerate(p["w_x"].placements) if pl.is_shard()]
    rows = [m for m, pl in enumerate(x.placements) if pl.is_shard(0)]
    if len(cut) > 1 or any(not x.placements[m].is_replicate() for m in cut):
        raise NotImplementedError(f"a Mamba2 block cut over {cut} on input {x.placements}")

    def grads(pls):
        return [pl if pl.is_shard() else Partial() if m in rows + cut else Replicate()
                for m, pl in enumerate(pls)]

    local = {k: t.to_local(grad_placements=grads(t.placements)) for k, t in p.items()}
    xl = x.to_local(grad_placements=[Partial() if m in cut else pl
                                     for m, pl in enumerate(x.placements)])
    group = group_of(mesh, (mesh.mesh_dim_names[cut[0]],)) if cut else None
    kernel = uses_kernels(cfg)
    if stack is None:
        out, _ = mamba2_block(local, xl, cfg, kernel=kernel, norm_group=group)
    else:
        if cut:
            stack["ssm"] = _cut_over(stack["ssm"], 2, cut[0])
            stack["conv_x"] = _cut_over(stack["conv_x"], 3, cut[0])
        mine = {k: t.to_local() for k, t in stack.items()}
        if mine["ssm"].shape[1] != xl.shape[0]:
            raise NotImplementedError(f"the state's batch {stack['ssm'].placements} is not "
                                      f"laid out as the block's input {x.placements}")
        out, new_state = mamba2_block(
            local, xl, cfg, state=layer_state(mine, i) if cont else None,
            kernel=kernel, ssm_out=mine["ssm"][i], norm_group=group)
        store_state(mine, i, new_state)
    pls = [Partial() if m in cut else pl for m, pl in enumerate(x.placements)]
    out = DTensor.from_local(out, mesh, pls, run_check=False, shape=x.shape, stride=x.stride())
    return shard_hint(out, "batch", None, "embed")


def _cut_over(t, dim: int, m: int):
    """DTensor ``t``, whole over mesh dim ``m``, cut along ``dim`` over it:
    each rank keeps a copy of its part of its local tensor (no
    collective).  Already cut so: ``t``."""
    from torch.distributed.tensor import DTensor, Shard

    if t.placements[m] == Shard(dim):
        return t
    if not t.placements[m].is_replicate():
        raise NotImplementedError(f"{t.placements}: cut dim {dim} over mesh dim {m}")
    n, r = t.device_mesh.size(m), t.device_mesh.get_local_rank(m)
    loc = t.to_local()
    size = loc.shape[dim] // n
    part = loc.narrow(dim, r * size, size).contiguous()
    pls = [Shard(dim) if k == m else pl for k, pl in enumerate(t.placements)]
    return DTensor.from_local(part, t.device_mesh, pls, run_check=False, shape=t.shape,
                              stride=t.stride())


def train_forward(params, batch, cfg: ModelConfig):
    """The training forward: (logits ``[B, S, V]``, aux loss) over the whole
    sequence, with no cache — nothing is written in place.  The aux loss is
    the sum over blocks of the MoE router's load-balancing term (0 for the
    other families).  Each block (a transformer block, a Mamba layer, the
    hybrid's shared block) is recomputed in the backward pass when
    ``cfg.remat`` is set.  Raises for a kernel config
    (:func:`check_trainable`)."""
    check_family(cfg)
    check_trainable(cfg)
    x, positions = _embed_in(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def mamba(layer_p, x):
        h = rmsnorm(x, layer_p["ln"])
        if is_dtensor(h):
            return x + _mamba_on_mesh(layer_p["mamba"], h, cfg)
        out, _ = mamba2_block(layer_p["mamba"], h, cfg)
        return x + out

    mamba_fn = remat(mamba, cfg.remat)
    if cfg.family == "ssm":
        for layer_p in params["layers"]:
            x = mamba_fn(layer_p, x)
    elif cfg.family == "hybrid":
        def shared(x, x_embed):
            u = torch.cat([x, x_embed], dim=-1) @ params["shared_proj_in"]
            u, _ = block_apply(params["shared_block"], u, cfg, positions=positions, window=1 << 30)
            return x + u

        shared_fn, x_embed = remat(shared, cfg.remat), x
        every = cfg.shared_attn_every
        for seg in range(_n_shared(cfg)):
            for i in range(seg * every, (seg + 1) * every):
                x = mamba_fn(params["mamba_layers"][i], x)
            x = shared_fn(x, x_embed)
    else:
        windows = _layer_windows(cfg)

        def block(layer_p, x, window):
            x, _, a = block_apply(layer_p, x, cfg, positions=positions, window=window,
                                  with_aux=True)
            return x, a

        block_fn = remat(block, cfg.remat)
        for i, layer_p in enumerate(params["layers"]):
            x, a = block_fn(layer_p, x, windows[i])
            aux = aux + a
    return _logits_out(params, x, cfg), aux


def prefill(params, batch, cfg: ModelConfig, max_len: Optional[int] = None):
    """Run the prompt, return (last_logits, caches)."""
    b, s = _batch_shape(batch, cfg)
    max_len = max_len or s
    caches = init_cache(cfg, b, max_len, device=params["embed"].device)
    # SSM/hybrid: cache_pos=None is a fresh recurrent state
    cache_pos = None if cfg.family in ("ssm", "hybrid") else torch.zeros((), dtype=torch.int32)
    logits, caches = forward(params, batch, cfg, caches=caches, cache_pos=cache_pos)
    return logits[:, -1], caches


def prefill_chunked(
    params,
    batch,
    cfg: ModelConfig,
    max_len: Optional[int] = None,
    *,
    chunk: int = 64,
    caches: Optional[Params] = None,
    page_table=None,
    start: int = 0,
):
    """Chunked prefill: the prompt in ``chunk``-token pieces, each written at
    its absolute offset — greedy-token-identical to :func:`prefill`.
    ``caches``/``page_table`` continue an existing (possibly paged) cache;
    ``start`` skips prompt tokens whose KV the cache already holds.

    A batch that carries M-RoPE ``positions`` is refused: the reference
    slices the tokens and embeddings per chunk but not the positions
    (``src/repro/models/transformer.py:579-581``), so its chunks meet
    whole-prompt streams and fail inside M-RoPE; the port copies neither
    the crash nor a position rule the reference lacks.  Chunk a VLM prompt
    at the default streams, or prefill it whole."""
    if "positions" in batch:
        raise ValueError(
            "prefill_chunked takes no batch['positions']: the reference drops them per "
            "chunk (src/repro/models/transformer.py:579-581) and its chunks then fail "
            "inside M-RoPE; prefill the prompt whole, or chunk it at the default streams"
        )
    b, s = _batch_shape(batch, cfg)
    if chunk <= 0:
        raise ValueError(f"chunk must be > 0, got {chunk}")
    if not 0 <= start < s:
        raise ValueError(f"start must be in [0, {s}), got {start}")
    max_len = max_len or s
    if caches is None:
        caches = init_cache(cfg, b, max_len, device=params["embed"].device)
    logits = None
    off = start
    while off < s:
        n = min(chunk, s - off)
        sub = dict(batch)
        for key in ("tokens", "embeds"):
            if key in sub:
                sub[key] = sub[key][:, off : off + n]
        logits, caches = forward(
            params, sub, cfg, caches=caches,
            cache_pos=torch.tensor(off, dtype=torch.int32), page_table=page_table,
        )
        off += n
    return logits[:, -1], caches


def decode_step(params, token_batch, caches, cache_pos, cfg: ModelConfig, *, page_table=None):
    """One-token step: tokens [B,1] (or embeds [B,1,D]); ``cache_pos`` is a
    scalar or a ``(B,)`` int32 vector (ragged batch)."""
    logits, new_caches = forward(
        params, token_batch, cfg, caches=caches, cache_pos=cache_pos,
        page_table=page_table,
    )
    return logits[:, -1], new_caches


def fused_step(
    params, token_batch, caches, cache_pos, q_lens, cfg: ModelConfig, *, page_table=None,
):
    """One FUSED mixed prefill/decode step: tokens [B, S] where row b's first
    ``q_lens[b]`` tokens are valid — decode rows 1, prefill chunks up to S,
    idle rows 0.  Rows write KV only over their valid span.  Returns the
    FULL logits [B, S, V] and the caches."""
    return forward(
        params, token_batch, cfg, caches=caches,
        cache_pos=torch.as_tensor(cache_pos, dtype=torch.int32),
        q_lens=torch.as_tensor(q_lens, dtype=torch.int32),
        page_table=page_table,
    )
