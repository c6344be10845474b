"""AdamW optimizer, hand-rolled as in the reference (no ``torch.optim``), on
the port's param trees.

State: first/second moments in fp32 (+ step counter), or 8-bit moments
(int8 ``q`` + per-row fp32 scales ``s``).  The update is functional — new
tensors for the params and the state, the old ones untouched — so a caller
can drop a step (the train loop's NaN breaker) by keeping what it had.

ZeRO-1 (``zero1_shardings``): on a mesh the fp32 moments are DTensors
spread over ALL mesh axes on the largest dimensions of each param —
optimizer state is pure elementwise, so any sharding is valid; sharding it
over DP too removes the 8·N bytes of replicated state.  The update then
runs on each rank's moment shard: the gradient's partial sums are reduced
straight into the moments' layout, the param is sliced to it, and the new
param goes back to the param's own (TP) layout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Tuple

import torch

from repro_torch.launch.mesh import Mesh, PartitionSpec as P, placements
from repro_torch.parallel.context import is_dtensor
from .tree import is_quant_leaf, leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def init_opt_state(params, *, quant8: bool = False, mesh=None) -> Dict[str, Any]:
    """quant8: store moments as int8 + per-row fp32 scales (8-bit Adam à la
    Dettmers) — 2 bytes/param of optimizer state instead of 8.  Every
    tensor lives on its param's device.  With a ``mesh`` (DTensor params)
    the fp32 moments are made in their ZeRO-1 layout (:func:`_zero1_spec`),
    each rank allocating its shard only; the step counter stays a plain
    0-dim tensor on every rank.  8-bit moments on a mesh keep ``q`` and
    ``s`` each in the ZeRO-1 layout of its own shape, as the reference's
    ``zero1_shardings`` lays out every leaf of the state."""
    some = leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=some.device)
    if mesh is not None:
        from torch.distributed.tensor import zeros as dzeros

        def zero1(shape, dtype=torch.float32):
            pl = placements(_zero1_spec(tuple(shape), mesh), mesh)
            return dzeros(tuple(shape), dtype=dtype, device_mesh=mesh.device_mesh, placements=pl)

        def moment(p):
            if not quant8:
                return zero1(p.shape)
            # q and s each in the ZeRO-1 layout of its own shape
            return {"q": zero1(p.shape, torch.int8), "s": zero1(_scale_shape(p), torch.float32)}

        return {"m": tree_map(moment, params), "v": tree_map(moment, params), "step": step}
    if not quant8:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": step}

    def qzeros(p):
        return {
            "q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
            "s": torch.zeros(_scale_shape(p), dtype=torch.float32, device=p.device),
        }

    return {"m": tree_map(qzeros, params), "v": tree_map(qzeros, params), "step": step}


def _scale_shape(p) -> Tuple[int, ...]:
    """An 8-bit moment's per-row scales: one for each row of the last dim."""
    return tuple(p.shape[:-1]) + (1,) if p.ndim >= 1 else (1,)


def is_quant_state(state) -> bool:
    """Whether the moments are 8-bit."""
    return any(is_quant_leaf(x) for x in leaves(state["m"], is_quant_leaf))


def _dequant(qs) -> torch.Tensor:
    return qs["q"].to(torch.float32) * qs["s"]


def _quant(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    if x.ndim >= 1:
        s = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0
    else:
        s = torch.abs(x) / 127.0
    s = torch.clamp_min(s, 1e-12)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup over ``warmup_steps``, then a cosine down to
    ``min_lr_frac · lr`` at ``total_steps`` (fp32, on ``step``'s device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree) -> torch.Tensor:
    """√(Σ x²) over every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)))


def decay_mask(params, stacked: Iterable[str] = ()) -> Any:
    """Which params take weight decay: the matrices.  The reference applies
    its ``ndim >= 2`` test to its own layout, where the layer groups named
    in ``stacked`` (top-level keys) are one ``[L, ...]`` array each, so
    there a per-layer vector counts as a matrix; the port keeps one dict
    per layer, so such a leaf counts one more dim here."""
    stacked = set(stacked)
    out = {}
    for k in params:
        extra = 1 if k in stacked else 0
        out[k] = tree_map(lambda p, e=extra: p.ndim + e >= 2, params[k])
    return out


def adamw_update(
    cfg: AdamWConfig, params, grads, state, *, decay=None
) -> Tuple[Any, Dict[str, Any], torch.Tensor]:
    """Returns (new_params, new_state, grad_norm).  Gradients are clipped to
    ``grad_clip`` by their global norm and taken in fp32; decoupled weight
    decay on matrices only (or where the ``decay`` tree of bools says,
    :func:`decay_mask`); each new param is cast back to its dtype."""
    quant8 = is_quant_state(state)
    step = state["step"] + 1
    # ZeRO-1: each gradient (its partial sums over the batch's ranks
    # included) reduced into its moments' layout
    grads = tree_map(_like, grads, state["m"], is_leaf=is_quant_leaf)
    gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bias1 = 1 - torch.pow(b1, stepf)
    bias2 = 1 - torch.pow(b2, stepf)

    if decay is None:
        decay = tree_map(lambda p: p.ndim >= 2, params)

    def upd(p, g, m, v, dec):
        if quant8:
            m, v = _dequant(m), _dequant(v)
        p_own = p
        p = _like(p, m)
        g = g.to(torch.float32) * clip
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bias1
        vhat = v / bias2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if dec:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        newp = _like((p.to(torch.float32) - lr * delta).to(p.dtype), p_own)
        if quant8:
            m, v = _quant(m), _quant(v)
        return (newp, m, v)

    out = tree_map(upd, params, grads, state["m"], state["v"], decay)
    is3 = lambda x: isinstance(x, tuple) and len(x) == 3  # noqa: E731
    new_params = tree_map(lambda t: t[0], out, is_leaf=is3)
    new_m = tree_map(lambda t: t[1], out, is_leaf=is3)
    new_v = tree_map(lambda t: t[2], out, is_leaf=is3)
    return new_params, {"m": new_m, "v": new_v, "step": step}, gnorm


def _like(x, ref):
    """``x`` in ``ref``'s DTensor layout (a no-op for plain tensors), its
    shard in storage of its own."""
    if not is_dtensor(ref) or tuple(x.placements) == tuple(ref.placements):
        return x
    return _compact(x.redistribute(ref.device_mesh, ref.placements))


def _compact(x):
    """DTensor ``x`` with a shard that owns its storage.  A redistribution
    may hand back a slice of the buffer it gathered (torch 2.11 does, from
    one shard layout to another); kept as a new param or moment, the slice
    would keep the whole buffer alive (16× the shard on a 16-way axis)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import contiguous_strides

    local = x.to_local()
    if local.untyped_storage().nbytes() <= local.numel() * local.element_size():
        return x
    return DTensor.from_local(local.clone(memory_format=torch.contiguous_format), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=contiguous_strides(x.shape))


# --------------------------------------------------------------------------
# ZeRO-1: shard m/v over every mesh axis along each param's largest dim
# --------------------------------------------------------------------------


def _zero1_spec(shape: Tuple[int, ...], mesh: Mesh) -> P:
    """Shard the largest divisible dims greedily over every mesh axis.
    Optimizer state is elementwise, so ANY sharding is valid; maximal
    sharding (incl. the DP axes) is what ZeRO-1 buys."""
    axes: list = [None] * len(shape)
    for name in mesh.axis_names:
        size = mesh.shape[name]
        cands = [
            (shape[i], i)
            for i in range(len(shape))
            if axes[i] is None and shape[i] % size == 0 and shape[i] >= size
        ]
        if not cands:
            continue
        _, i = max(cands)
        axes[i] = name
    return P(*axes)


def zero1_shardings(mesh: Mesh, opt_state_shape) -> Any:
    """Spec tree matching an opt-state shape tree (fp32 or quant8)."""

    def one(leaf):
        return _zero1_spec(tuple(leaf.shape), mesh)

    return tree_map(one, opt_state_shape)
