"""Roofline terms of one step, and the counter that measures a step.

Three terms, all in seconds per step on one NVIDIA H100 SXM (the
constants of :mod:`repro_torch.core.devices`):

  compute    = FLOPs_per_device            / H100 peak dense bf16 FLOP/s
  memory     = bytes_per_device            / H100 HBM3 bandwidth
  collective = collective_bytes_per_device / NVLink bandwidth (one direction)

The link figure is NVLink's, the fastest link a card has: peers on other
hosts are reached over slower networks, so ``step_time_lb_s`` (the
largest term) stays a lower bound.  There is one link constant, as in the
reference; no per-axis network model.

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` of the
compiled per-device program and parses collective bytes out of its HLO.
The port has neither: :class:`StepCounter` counts what one rank runs while
the step executes (eagerly, on fake or real tensors):

* FLOPs — ``torch.utils.flop_counter``'s formulas on every ATen op (the
  grouped GEMM's custom op has its own, ``2·M·K·N``);
* bytes — each non-view op's tensor inputs and outputs
  (:class:`ByteCounter`, each input read once, each output written once;
  a gather reads, and an in-place scatter writes, only the elements it
  touches);
* collectives — every collective's result bytes, under the reference's
  kind names: DTensor's functional collectives (``_c10d_functional``) and
  the eager ``torch.distributed`` calls of
  :mod:`repro_torch.parallel.collectives` (``c10d``).  An all-gather counts
  its gathered result, a reduce-scatter its scattered shard.

Counts are per device.  A DTensor op is seen at its global shape; the
counter lets DTensor run it and counts the local ops DTensor issues on the
rank's shards, and the collectives of its redistributions.  The ops that
DTensor's sharding propagation runs on global-shaped stand-ins to learn an
output's shape are not the rank's work and are not counted.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.devices import H100_HBM_BW, H100_NVLINK_BW, H100_PEAK_BF16

# H100 SXM per card
PEAK_FLOPS_BF16 = H100_PEAK_BF16
HBM_BW = H100_HBM_BW
LINK_BW = H100_NVLINK_BW

# ops that alias their input and move no data (the dispatcher does not
# flag every one of them as a view)
_NO_TRAFFIC = {"aten::_unsafe_view", "aten::alias", "aten::lift_fresh", "aten::detach",
               "_c10d_functional::wait_tensor"}

# collective ops -> (reference kind, index of the result among the outputs
# (functional) or the arguments (eager, in place))
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_EAGER = {                      # c10d op -> (kind, argument holding the result)
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_base_": ("all-to-all", 0),
    "alltoall_": ("all-to-all", 0),
    "broadcast_": ("collective-permute", 0),
    "send": ("collective-permute", 0),
}

# the caching allocator hands out blocks in multiples of 512 bytes
_BLOCK = 512

_quiet = threading.local()


def _tensors(tree) -> list:
    """The tensors in nested tuples, lists and dicts (an op's arguments or
    results), in no particular order."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
        elif isinstance(x, dict):
            todo.extend(x.values())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# allocations: storage handed out, nothing written yet
_ALLOCS = {"aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty",
           "aten::new_empty_strided"}
# gathers: the indexed input (the first argument) is read only where the
# index points, as many elements as the output has
_GATHERS = {"aten::index_select", "aten::index", "aten::gather", "aten::embedding"}
# in-place scatters: the destination (the first argument, also the output)
# is written only where the index points, as many elements as the source
_SCATTERS = {"aten::index_copy_", "aten::index_put_", "aten::scatter_", "aten::scatter_add_",
             "aten::index_add_", "aten::scatter_reduce_", "aten::_index_put_impl_"}


def _read_bytes(t: torch.Tensor) -> int:
    """What reading ``t`` moves: its elements, or its storage when that is
    smaller (a broadcast view)."""
    return min(_nbytes(t), t.untyped_storage().nbytes())


def _op_bytes(func, args, ins: list, outs: list) -> int:
    """Bytes an op moves: its tensor inputs ``ins`` read once and outputs
    ``outs`` written once; 0 for a view, an alias, or an op that returns no
    tensor, or an allocation (nothing written yet).  A gather reads of its
    source only what it gathers, and an in-place scatter writes of its
    destination only what it scatters."""
    name = func._schema.name
    if not outs or func.is_view or name in _NO_TRAFFIC or name in _ALLOCS:
        return 0
    first = args[0] if args and isinstance(args[0], torch.Tensor) else None
    if first is not None and name in _GATHERS:
        rest = [t for t in ins if t is not first]
        return 2 * sum(_nbytes(t) for t in outs) + sum(_read_bytes(t) for t in rest)
    if first is not None and name in _SCATTERS:
        rest = [t for t in ins if t is not first]
        return 2 * sum(_read_bytes(t) for t in rest)
    return sum(_read_bytes(t) for t in ins) + sum(_nbytes(t) for t in outs)


def _on_meta(ins: list, outs: list) -> bool:
    """Whether an op runs on ``meta`` tensors: shapes worked out, no
    rank's work (a fake tensor reports its own device, never ``meta``)."""
    ts = ins + outs
    return bool(ts) and all(t.device.type == "meta" for t in ts)


class _RankMode(TorchDispatchMode):
    """A dispatch mode that sees one rank's work: DTensor ops are handed to
    DTensor, whose local ops come back to the mode, and DTensor's sharding
    propagation runs unseen."""

    def __init__(self):
        super().__init__()
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(_quiet_sharding_propagation())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()


class ByteCounter(_RankMode):
    """Sums the bytes of every ATen op's tensor inputs and outputs that
    runs under it; views, aliases and ops that return no tensor move
    nothing.  On DTensors it counts the rank's local ops (see
    :class:`StepCounter`)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not (getattr(_quiet, "depth", 0) or _on_meta(ins, outs)):
            n = _op_bytes(func, args, ins, outs)
            if n:
                self.bytes += n
                self.ops.append((func._schema.name, n))
        return out


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


@contextlib.contextmanager
def _quiet_sharding_propagation():
    """Ops that DTensor's sharding propagation runs on global-shaped
    stand-ins (to learn an output's shape and strides) are not counted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = next((n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        raise RuntimeError("DTensor's sharding propagator has no tensor-meta step to silence")
    inner = getattr(ShardingPropagator, name)

    def quiet(self, *args, **kwargs):
        _quiet.depth = getattr(_quiet, "depth", 0) + 1
        try:
            return inner(self, *args, **kwargs)
        finally:
            _quiet.depth -= 1

    setattr(ShardingPropagator, name, quiet)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, inner)


def _shape(x):
    return x.shape if isinstance(x, torch.Tensor) else x


class StepCounter(_RankMode):
    """Per-device FLOPs, bytes and collectives of what runs under it, and
    the peak of the storage it saw allocated.

    ``flops`` and ``bytes`` are totals; ``collectives`` is the reference's
    ``{"total", "by_kind", "counts"}``.  ``peak_bytes`` is the most storage
    made under the counter that was alive at once (each storage rounded up
    to the caching allocator's 512-byte blocks); storage that existed
    before (params, optimizer state, batch, cache) is not in it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_kind: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.live = 0
        self.peak_bytes = 0
        self._alive: Dict[int, int] = {}

    def snapshot(self) -> tuple:
        """The totals so far, for :meth:`repeat`."""
        return self.flops, self.bytes, dict(self.by_kind), dict(self.counts)

    def repeat(self, since: tuple, times: int) -> None:
        """Count what ran after ``since`` (a :meth:`snapshot`) ``times`` more
        times: a piece of the step that would run again as it ran."""
        flops, nbytes, by_kind, counts = since
        self.flops += (self.flops - flops) * times
        self.bytes += (self.bytes - nbytes) * times
        for k in list(self.by_kind):
            self.by_kind[k] += (self.by_kind[k] - by_kind.get(k, 0.0)) * times
        for k in list(self.counts):
            self.counts[k] += (self.counts[k] - counts.get(k, 0)) * times

    @property
    def collectives(self) -> Dict:
        return {"total": sum(self.by_kind.values()), "by_kind": dict(self.by_kind),
                "counts": dict(self.counts)}

    def _collective(self, func, args, outs: list) -> None:
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            kind, nbytes = _FUNCTIONAL[name], sum(_nbytes(t) for t in outs)
        elif ns == "c10d" and name in _EAGER:
            kind, at = _EAGER[name]
            nbytes = sum(_nbytes(t) for t in _tensors(args[at]))
        else:
            return
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + float(nbytes)
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def _free(self, key: int, n: int) -> None:
        if self._alive.pop(key, None) is not None:
            self.live -= n

    def _track(self, ins: list, outs: list) -> None:
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            s = t.untyped_storage()
            key = s._cdata
            if key in seen or key in self._alive:
                continue
            n = -(-s.nbytes() // _BLOCK) * _BLOCK
            self._alive[key] = n
            self.live += n
            weakref.finalize(s, self._free, key, n)
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            # DTensor runs it: its local ops come back here
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(_quiet, "depth", 0):
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if _on_meta(ins, outs):
            return out
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*tree_map(_shape, args),
                                                    **tree_map(_shape, kwargs),
                                                    out_val=tree_map(_shape, out)))
        self.bytes += _op_bytes(func, args, ins, outs)
        if func.namespace in ("_c10d_functional", "c10d"):
            self._collective(func, args, outs)
        if not func.is_view:
            self._track(ins, outs)
        return out


def roofline_terms(cell: Dict, cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Derive the three terms + MODEL_FLOPS ratio for one dry-run cell."""
    t_compute = cell["flops_per_device"] / PEAK_FLOPS_BF16
    t_memory = cell["bytes_per_device"] / HBM_BW
    t_coll = cell["collective_bytes_per_device"] / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)

    # MODEL_FLOPS: 6·N·D for train, 2·N·D forward (per processed token)
    n_active = cell.get("active_params") or cell.get("params") or 0
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        model_flops = 2.0 * n_active * tokens
    total = cell["flops_per_device"] * cell.get("n_devices", 1)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / total) if total else 0.0,
        "step_time_lb_s": max(terms.values()),
    }
