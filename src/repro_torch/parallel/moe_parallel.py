"""Expert-parallel MoE on local shards: capacity-bounded all-to-all dispatch.

Layout (matches parallel/sharding.py):
  tokens  — sharded over the DP axes (pod, data)
  experts — sharded over "data" (EP groups are intra-pod: the all-to-all
            stays inside a pod; experts replicate across pods)
  expert FFN hidden — sharded over "model" (TP inside each expert, partial
            sums reduced with an all-reduce over "model")

Algorithm per rank (GShard-style dropping, capacity factor cf):
  1. route local tokens (top-k), flatten (token, choice) pairs
  2. bucket pairs by owner EP peer; slot = rank within bucket; drop ≥ cap
  3. all_to_all token payloads + local-expert ids to the owners
  4. sort received tokens by local expert, grouped GEMM
     (:mod:`repro_torch.kernels.grouped_gemm`: the CUDA kernel with
     ``kernel=True`` on a card, its plain version otherwise and under
     autograd — the kernel is forward-only)
  5. all_to_all results back (slot-aligned), combine with router weights

The reference runs the body under ``shard_map``; here it runs on each
rank's local shards (``to_local``), with the collectives of
:mod:`repro_torch.parallel.collectives` and their autograd rules, and the
result goes back to a DTensor laid out like the tokens.  The bucketing is
the reference's bit for bit (a stable sort on the owner, ``searchsorted``
for each bucket's first slot, ``keep = slot < cap``, ``cap`` rounded up to
8), so the same tokens drop.  The oracle is
:func:`repro_torch.models.moe.moe_reference`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import grouped_gemm as gg_kernel
from repro_torch.launch.mesh import PartitionSpec as P, placements
from repro_torch.models.moe import router_topk
from repro_torch.parallel import collectives
from repro_torch.parallel.context import ParallelContext


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gathers_weights(cfg: ModelConfig, ctx: ParallelContext, x_shape: Sequence[int]) -> bool:
    """§Perf (arctic): weight-gathered mode — every TP rank otherwise runs
    an IDENTICAL all-to-all on the full local token set.  Instead: slice
    tokens over the TP axis, all-gather the expert weight slices, dispatch
    only the slice, and all-gather results at the end.  The switch is
    COST-BASED on the shapes, as the reference's: gathering loses when the
    (micro)batch is small."""
    tp = ctx.tp_axis
    if not (bool(getattr(cfg, "moe_gather_weights", False)) and tp is not None):
        return False
    b_, s_, d_ = x_shape
    dp = ctx.dp_axes
    ep = ctx.axis_size(ctx.ep_axes)
    e_loc = (cfg.n_experts_padded or cfg.n_experts) // ep
    dp_size = ctx.axis_size(dp) if dp else 1
    t_loc = max(b_ * s_ // max(dp_size, 1), 1)
    tok_bytes = 2.0 * t_loc * cfg.top_k * d_ * 2  # a2a there+back, bf16
    tpsize0 = ctx.axis_size(tp)
    w_bytes = 3.0 * e_loc * d_ * cfg.moe_d_ff * 2 * (tpsize0 - 1) / tpsize0
    return tok_bytes > w_bytes and t_loc % tpsize0 == 0


def _local(t, ctx: ParallelContext, spec, splits_tokens):
    """``t``'s shard under ``spec`` as a plain tensor.  Its gradient is
    partial over the mesh dims in ``splits_tokens`` on which it is whole
    (each rank there used it on other tokens), and laid out as ``spec``
    says elsewhere."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = ctx.mesh
    want = placements(spec, mesh)
    if tuple(t.placements) != tuple(want):
        t = t.redistribute(mesh.device_mesh, want)
    grad = [
        Partial() if (p == Replicate() and mesh.axis_names[m] in splits_tokens) else p
        for m, p in enumerate(want)
    ]
    return t.to_local(grad_placements=grad)


def moe_ep(
    p: Dict[str, Any],
    x,                               # DTensor [B, S, D] (global)
    cfg: ModelConfig,
    ctx: ParallelContext,
    *,
    kernel: bool = False,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[Any, Any]:
    """(y, aux): y a DTensor like ``x`` laid out by the DP axes, aux the
    router's load-balancing loss, averaged over the DP axes (and over the
    TP ranks' token slices in the weight-gathered mode), replicated.  A
    ``stats`` dict receives this rank's ``dropped`` (token, choice) pairs
    (read back to the host)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ctx.mesh
    dm = mesh.device_mesh
    ep_axes = ctx.ep_axes            # ("data",)
    dp = ctx.dp_axes                 # ("pod", "data") or ("data",)
    tp = ctx.tp_axis                 # "model"
    ep = ctx.axis_size(ep_axes)
    e_pad = cfg.n_experts_padded or cfg.n_experts
    e_loc = e_pad // ep

    ep_entry = ep_axes if len(ep_axes) > 1 else ep_axes[0]
    x_spec = P(dp, None, None)
    w_spec = P(ep_entry, None, tp)
    w2_spec = P(ep_entry, tp, None)
    # pure-DP×EP mode (tp None): experts hold full FFN width — no all-reduce
    gather = gathers_weights(cfg, ctx, tuple(x.shape))
    splits_tokens = set(dp) | ({tp} if gather else set())
    ep_group = mesh.group(ep_axes)
    tp_group = mesh.group(tp) if tp is not None else None

    # the tokens feed the experts (each TP rank's gradient a partial sum over
    # its FFN slice) and the router (each TP rank's gradient whole, the same
    # tokens on every one, unless each routes its own slice)
    xl = _local(x, ctx, x_spec, {tp} if tp is not None else set())
    xr = xl if gather or tp is None else _local(x, ctx, x_spec, set())
    router = _local(p["router"], ctx, P(), splits_tokens)
    w_gate = _local(p["w_gate"], ctx, w_spec, splits_tokens)
    w_up = _local(p["w_up"], ctx, w_spec, splits_tokens)
    w_down = _local(p["w_down"], ctx, w2_spec, splits_tokens)

    b_loc, s, d = xl.shape
    t = b_loc * s
    xt, xrt = xl.reshape(t, d), xr.reshape(t, d)
    if gather:
        tpsize = ctx.axis_size(tp)
        t_slice = t // tpsize
        xt = xrt = xt.narrow(0, dm.get_local_rank(tp) * t_slice, t_slice)
        t = t_slice
        w_gate = collectives.all_gather(w_gate, 2, tp_group, reduce_grad=True)
        w_up = collectives.all_gather(w_up, 2, tp_group, reduce_grad=True)
        w_down = collectives.all_gather(w_down, 1, tp_group, reduce_grad=True)
    weights, experts, aux = router_topk(router, xrt, cfg, with_aux=True)  # [t,k]
    k = cfg.top_k
    dev = xt.device

    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)          # [t*k]
    flat_exp = experts.reshape(-1)                                       # global expert id
    flat_w = weights.reshape(-1)
    dest = flat_exp // e_loc                                             # owner peer
    local_exp = flat_exp % e_loc

    cap = _round_up(max(int(math.ceil(t * k / ep * cfg.capacity_factor)), 1), 8)

    # bucket by dest peer; slot = rank within bucket (stable sort keeps
    # token order so drops hit the latest tokens)
    order = torch.argsort(dest, stable=True)
    dest_s = dest[order]
    # rank within each bucket: position - first position of that bucket
    pos = torch.arange(t * k, device=dev)
    first_of_bucket = torch.searchsorted(dest_s, torch.arange(ep, device=dev), side="left")
    slot = pos - first_of_bucket[dest_s]
    keep = slot < cap
    if stats is not None:
        stats["dropped"] = int((~keep).sum())

    tok_idx_s = flat_tok[order]
    lexp_s = local_exp[order]
    slot_c = torch.where(keep, slot, torch.full_like(slot, cap - 1))     # clamp; masked below
    # .add (accumulate, not a plain put): dropped entries contribute zeros
    # and must not clobber a legitimate token occupying slot cap-1
    payload = torch.where(keep[:, None], xt[tok_idx_s], torch.zeros((), dtype=xt.dtype, device=dev))
    send_tok = torch.zeros((ep, cap, d), dtype=xl.dtype, device=dev).index_put(
        (dest_s, slot_c), payload.to(xl.dtype), accumulate=True)
    flat_slot = dest_s * cap + slot_c

    def slot_max(values):
        out = torch.zeros(ep * cap, dtype=torch.int32, device=dev)
        return out.scatter_reduce(0, flat_slot, values.to(torch.int32), "amax").reshape(ep, cap)

    send_exp = slot_max(torch.where(keep, lexp_s, torch.zeros_like(lexp_s)))
    send_valid = slot_max(keep)

    # ---- exchange to expert owners ----------------------------------------
    recv_tok = collectives.all_to_all(send_tok, ep_group)
    recv_exp = collectives.all_to_all(send_exp, ep_group)
    recv_valid = collectives.all_to_all(send_valid, ep_group)

    rt = recv_tok.reshape(ep * cap, d)
    rv = recv_valid.reshape(ep * cap) > 0
    re = torch.where(rv, recv_exp.reshape(ep * cap).to(torch.int64),
                     torch.full((ep * cap,), e_loc - 1, dtype=torch.int64, device=dev))  # park invalid

    # ---- grouped GEMM over local experts -----------------------------------
    sort_idx = torch.argsort(re, stable=True)
    rt_s = rt[sort_idx]
    ids = torch.arange(e_loc, device=dev)
    group_sizes = (re[:, None] == ids[None, :]).sum(0, dtype=torch.int32)
    gemm = gg_kernel.grouped_gemm if kernel else gg_kernel.grouped_gemm_plain
    gate = gemm(rt_s, w_gate, group_sizes)
    up = gemm(rt_s, w_up, group_sizes)
    h = (F.silu(gate.float()) * up.float()).to(rt_s.dtype)
    y_s = gemm(h, w_down, group_sizes)                                   # partial over tp
    # unsort
    y = torch.zeros_like(y_s).index_copy(0, sort_idx, y_s)
    y = torch.where(rv[:, None], y, torch.zeros((), dtype=y.dtype, device=dev))
    y = y.reshape(ep, cap, d)

    # ---- return (+ reduce TP partial sums in the sliced-FFN mode) ---------
    back = collectives.all_to_all(y, ep_group)
    if tp is not None and not gather:
        back = collectives.all_reduce(back, tp_group)

    # ---- combine at the original sender ------------------------------------
    w_s = torch.where(keep, flat_w[order], torch.zeros((), dtype=flat_w.dtype, device=dev))
    contrib = back[dest_s, slot_c] * w_s[:, None].to(back.dtype)
    y_tok = torch.zeros((t, d), dtype=torch.float32, device=dev).index_add(
        0, tok_idx_s, contrib.to(torch.float32))
    if gather:
        # token slices are disjoint across TP ranks: restore the full set
        y_tok = collectives.all_gather(y_tok, 0, tp_group, reduce_grad=False)
    aux = collectives.mean(aux, mesh.group(tuple(sorted(splits_tokens, key=mesh.axis_names.index))))
    y_out = DTensor.from_local(y_tok.reshape(b_loc, s, d).to(xl.dtype), dm,
                               placements(x_spec, mesh), run_check=False, shape=x.shape,
                               stride=x.stride())
    aux_out = DTensor.from_local(aux, dm, [Replicate()] * len(mesh.axis_names), run_check=False)
    return y_out, aux_out
