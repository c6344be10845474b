"""Collectives of the port's sharded paths, with their autograd rules.

The sharded program follows DTensor's convention for gradients: a tensor
that every rank of a group holds whole (replicated) receives its whole
gradient on each of those ranks.  So:

* :func:`all_reduce` (the reference's ``psum`` of partial sums into a
  replicated value) sums in the forward pass and passes the gradient
  through unchanged, or sums it too (``reduce_grad=True``: each rank used
  the sum for its own part of the work, as a norm over a dim cut between
  the ranks does);
* :func:`all_to_all` sends block ``j`` of dim 0 to peer ``j`` and its
  gradient back the same way;
* :func:`all_gather` joins the group's shards along a dim: with
  ``reduce_grad=True`` (the shards were used whole on every rank: gathered
  weights) the gradient is summed over the group and each rank keeps its
  shard's part; otherwise (the gathered value is replicated downstream)
  each rank keeps its own part;
* :func:`mean` is the reference's ``pmean`` of a per-rank scalar.

Every collective runs on ``torch.distributed`` in the caller's process
group.  Inside ``with log_collectives() as log:`` each call's count,
bytes and host time are added to ``log`` (``chip_smoke.py`` reads them);
the bytes are an all-gather's gathered result and, for the other kinds,
the input (a reduce-scatter's whole input, not the shard it returns: the
dry-run's counter, ``launch/roofline.py``, counts result bytes).

DTensor runs its own redistributions through PyTorch's *functional*
collectives (``_c10d_functional``).  With ``gloo`` on CUDA tensors (ranks
that share one card) their all-gather segfaults in ``wait_tensor`` (torch
2.11.0+cu128 with an H100), while the eager ``torch.distributed``
calls take CUDA tensors.  :func:`route_functional_collectives` gives the
functional all-reduce, all-gather, reduce-scatter and all-to-all a CUDA
kernel that runs the eager call (gloo stages the bytes through host memory
itself); :func:`~repro_torch.launch.mesh.init_ranks` installs it for gloo
ranks on cards, and only there.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch
import torch.distributed as dist

_logs: List[Dict[str, List[float]]] = []       # the open logs, innermost last


@contextlib.contextmanager
def log_collectives():
    """A fresh log, ``{name: [calls, bytes, host seconds to completion]}``,
    of every collective of this module while the block runs."""
    log: Dict[str, List[float]] = defaultdict(lambda: [0, 0, 0.0])
    _logs.append(log)
    try:
        yield log
    finally:
        _logs.remove(log)


def _run(name: str, fn, nbytes: int):
    if not _logs:
        return fn()
    t0 = time.perf_counter()
    out = fn()
    rec = _logs[-1][name]
    rec[0] += 1
    rec[1] += nbytes
    rec[2] += time.perf_counter() - t0
    return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    _run("all_reduce", lambda: dist.all_reduce(y, group=group), _nbytes(y))
    return y


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    y = torch.empty_like(x)
    _run("all_to_all", lambda: dist.all_to_all_single(y, x, group=group), _nbytes(x))
    return y


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    y = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _run("all_gather", lambda: dist.all_gather_into_tensor(y, x, group=group), _nbytes(y))
    return y.movedim(0, dim)


def _own_part(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, reduce_grad):
        ctx.group, ctx.reduce_grad = group, reduce_grad
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return (_sum(g, ctx.group) if ctx.reduce_grad else g), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce_grad):
        ctx.dim, ctx.group, ctx.reduce_grad = dim, group, reduce_grad
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            g = _sum(g, ctx.group)
        return _own_part(g, ctx.dim, ctx.group), None, None, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return _sum(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def all_reduce(x: torch.Tensor, group, *, reduce_grad: bool = False) -> torch.Tensor:
    """Σ over ``group``; the gradient passes through (the sum is
    replicated, so each rank already holds its whole gradient), or, with
    ``reduce_grad=True`` (each rank uses the sum for its own part of the
    work only, so each holds a partial gradient), is summed over the group
    too."""
    return _AllReduce.apply(x, group, reduce_grad)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of dim 0 (``x.shape[0]`` a multiple of the group size)
    to peer ``j``; block ``i`` of the result came from peer ``i``."""
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group, *, reduce_grad: bool) -> torch.Tensor:
    """The group's shards joined along ``dim``, in rank order."""
    return _AllGather.apply(x, dim, group, reduce_grad)


def mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over ``group`` of each rank's ``x``."""
    return _Mean.apply(x, group)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ``group``, outside autograd."""
    y = x.detach().contiguous().clone()
    _run("all_reduce", lambda: dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group),
         _nbytes(y))
    return y


# --------------------------------------------------------------------------
# DTensor's functional collectives on eager calls
# --------------------------------------------------------------------------

_ROUTED: List = []
_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}


def _pg(group_name):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return group_name if isinstance(group_name, dist.ProcessGroup) else \
        _resolve_process_group(group_name)


def _f_all_reduce(x, reduce_op, group_name):
    pg = _pg(group_name)
    y = x.contiguous().clone()
    _run("all_reduce", lambda: dist.all_reduce(y, op=_OPS[reduce_op.lower()], group=pg),
         _nbytes(y))
    return y / dist.get_world_size(pg) if reduce_op.lower() == "avg" else y


def _f_all_gather(x, group_size, group_name):
    pg = _pg(group_name)
    x = x.contiguous()
    y = torch.empty((group_size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    _run("all_gather", lambda: dist.all_gather_into_tensor(y, x, group=pg), _nbytes(y))
    return y


def _f_reduce_scatter(x, reduce_op, group_size, group_name):
    pg = _pg(group_name)
    x = x.contiguous()
    y = torch.empty((x.shape[0] // group_size,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    _run("reduce_scatter",
         lambda: dist.reduce_scatter_tensor(y, x, op=_OPS[reduce_op.lower()], group=pg),
         _nbytes(x))
    return y / group_size if reduce_op.lower() == "avg" else y


def _f_all_to_all(x, output_split_sizes, input_split_sizes, group_name):
    pg = _pg(group_name)
    x = x.contiguous()
    rows = sum(output_split_sizes) if output_split_sizes else x.shape[0]
    y = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _run("all_to_all", lambda: dist.all_to_all_single(
        y, x, list(output_split_sizes) or None, list(input_split_sizes) or None, group=pg),
        _nbytes(x))
    return y


def route_functional_collectives(device_type: str = "cuda") -> None:
    """Run ``_c10d_functional``'s all-reduce, all-gather, reduce-scatter
    and all-to-all on ``device_type`` tensors through the eager
    ``torch.distributed`` calls (once per process)."""
    if _ROUTED:
        return
    key = {"cuda": "CUDA", "cpu": "CPU"}[device_type]
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_reduce", _f_all_reduce, key)
    lib.impl("all_gather_into_tensor", _f_all_gather, key)
    lib.impl("reduce_scatter_tensor", _f_reduce_scatter, key)
    lib.impl("all_to_all_single", _f_all_to_all, key)
    _ROUTED.append(lib)


def functional_collectives_routed() -> bool:
    """Whether :func:`route_functional_collectives` is installed."""
    return bool(_ROUTED)
