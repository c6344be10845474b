"""Logical-axis sharding context (a minimal flax-style axis-rules mechanism).

Models annotate activations with *logical* axis names; the launcher installs
a mapping from logical names to mesh axis names.  Outside any context (unit
tests, single-device runs, serving) every hint is a no-op, so model code
never depends on a mesh being present.

Under a context whose mesh holds a ``DeviceMesh``, a hint on a DTensor
redistributes it to the placements its logical names give — the port's
counterpart of ``with_sharding_constraint``: where the reference lets the
partitioner place a collective, the hint is where DTensor runs it (a
row-parallel product's partial sums are all-reduced at the hint after it).
As that constraint's transpose does, the hint also lays out the gradient
that reaches it: a partial sum arriving there is reduced at the hint.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import Mesh, PartitionSpec as P, placements

MeshAxes = Union[None, str, Tuple[str, ...]]

_state = threading.local()


def _current() -> Optional["ParallelContext"]:
    return getattr(_state, "ctx", None)


class ParallelContext:
    """Holds the mesh + logical→mesh axis rules + feature flags."""

    def __init__(
        self,
        mesh: Optional[Mesh],
        rules: Optional[Dict[str, MeshAxes]] = None,
        *,
        ep_axes: Tuple[str, ...] = (),
        dp_axes: Tuple[str, ...] = (),
        tp_axis: Optional[str] = None,
    ):
        self.mesh = mesh
        self.rules = dict(rules or {})
        self.ep_axes = ep_axes
        self.dp_axes = dp_axes
        self.tp_axis = tp_axis

    def spec_for(self, logical: Sequence[Optional[str]]) -> P:
        axes = []
        for name in logical:
            axes.append(self.rules.get(name) if name is not None else None)
        return P(*axes)

    def with_rules(self, **rules: MeshAxes) -> "ParallelContext":
        """This context with the given logical rules replaced."""
        return ParallelContext(self.mesh, {**self.rules, **rules}, ep_axes=self.ep_axes,
                               dp_axes=self.dp_axes, tp_axis=self.tp_axis)

    # mesh axis sizes the MoE layer needs for static shapes
    def axis_size(self, names: Union[str, Tuple[str, ...]]) -> int:
        if self.mesh is None:
            return 1
        if isinstance(names, str):
            names = (names,)
        size = 1
        for n in names:
            size *= self.mesh.shape[n]
        return size


@contextlib.contextmanager
def parallel_context(ctx: ParallelContext):
    prev = _current()
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


def current_context() -> Optional[ParallelContext]:
    return _current()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class _GradHint(torch.autograd.Function):
    """The identity on a DTensor whose gradient takes the placements
    ``want``: the transpose of ``with_sharding_constraint``, which
    constrains the cotangent to the same sharding.  A gradient that is a
    partial sum is all-reduced (or reduce-scattered) here, once, so that
    the products before the hint meet a gradient laid out like their
    activations (DTensor would resolve a partial sum against a weight cut
    on the same mesh dim by gathering the weight)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.mesh, ctx.want = x.device_mesh, want
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if not is_dtensor(g) or g.device_mesh != ctx.mesh:
            # a gradient that is not laid out on the hint's mesh has no
            # placements to redistribute: treating it as whole on every rank
            # would be a guess
            raise TypeError(f"shard_hint: the gradient arrived as {type(g).__name__} "
                            f"{getattr(g, 'placements', '')}, not as a DTensor on the "
                            f"hint's mesh; it cannot take the placements {ctx.want}")
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        return g, None


def grad_as(x, want) -> torch.Tensor:
    """DTensor ``x`` itself, its gradient redistributed to the placements
    ``want`` in the backward pass (:class:`_GradHint`)."""
    return _GradHint.apply(x, tuple(want)) if x.requires_grad else x


def shard_hint(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute ``x`` to the placements of its logical axis names, and
    its gradient to the same placements in the backward pass; a no-op
    without a context, on an abstract mesh, or on a plain tensor."""
    ctx = _current()
    if ctx is None or ctx.mesh is None or ctx.mesh.device_mesh is None or not is_dtensor(x):
        return x
    want = tuple(placements(ctx.spec_for(logical), ctx.mesh))
    if tuple(x.placements) != want:
        x = x.redistribute(ctx.mesh.device_mesh, want)
    return grad_as(x, want)


# Default logical-axis rule set used by the launcher: batch → data parallel,
# heads/ff/vocab/experts → tensor/expert parallel.
def default_rules(multi_pod: bool) -> Dict[str, MeshAxes]:
    dp: MeshAxes = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp,
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "vocab": "model",
        "embed": None,
        "seq": None,
        "kv_seq": "data",      # long-context decode: KV cache sharded over data
        "experts": dp,          # EP over the data-parallel axes
        "expert_ff": "model",
    }


def like_batch(t: torch.Tensor, x, *, batch_dim: int = 0):
    """``t`` (the same full tensor on every rank, its batch on
    ``batch_dim``) as a DTensor cut over the batch like DTensor ``x``'s
    dim 0, whole on ``x``'s other mesh dims — each rank keeps its rows,
    with no communication."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    pl = [Shard(batch_dim) if p.is_shard(0) else Replicate() for p in x.placements]
    if any(p.is_partial() for p in x.placements):
        raise ValueError(f"{x.placements}: a partial sum has no rows to follow")
    return distribute_tensor(t, x.device_mesh, pl, src_data_rank=None)
