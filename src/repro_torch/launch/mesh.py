"""Meshes of the port, and the ranks that hold them.

A :class:`Mesh` carries what the sharding rules read — ``.shape`` (axis
name → size, in mesh order) and ``.axis_names`` — and, when the ranks are
up, the ``torch.distributed`` ``DeviceMesh`` that holds the tensors.  One
without a ``DeviceMesh`` is *abstract*: sizes only, for the rules (the
production meshes, which no machine here holds).

* :func:`make_debug_mesh` — the reference's small meshes over the ranks
  that exist: (2, n/2) for n ≥ 4, else (1, n); multi-pod (2, 1, n/2).
* :func:`make_production_mesh` — the reference's (16, 16) or
  (2, 16, 16) production mesh, abstract.
* :func:`init_ranks` — starts this process's rank.  The backend is the
  caller's: ``gloo`` for CPU ranks and for ranks that share one card,
  ``nccl`` only when each rank has a card of its own.  Gloo ranks on cards
  run DTensor's functional collectives through the eager calls
  (:func:`repro_torch.parallel.collectives.route_functional_collectives`).
* :func:`placements` — a spec (one entry per tensor dim: ``None``, an axis
  name, or a tuple of axis names) as DTensor placements, one per mesh dim.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (not sharded), a mesh axis name,
    or a tuple of axis names (sharded over their product, major first) —
    entry for entry the reference's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """Axis names and sizes, and the ``DeviceMesh`` over the ranks when
    there is one (``None``: an abstract mesh)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str], device_mesh=None):
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} sizes for axes {tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = OrderedDict(zip(self.axis_names, (int(s) for s in sizes)))
        self.device_mesh = device_mesh

    @property
    def device(self) -> torch.device:
        """This rank's device: its current card on a CUDA mesh."""
        if self.device_mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_mesh.device_type)

    def group(self, axes) -> Optional[dist.ProcessGroup]:
        """The process group over mesh axes ``axes`` (a name or a tuple of
        names): this rank and its peers along them."""
        return group_of(self.device_mesh, (axes,) if isinstance(axes, str) else tuple(axes))

    def __repr__(self) -> str:
        kind = "abstract" if self.device_mesh is None else self.device_mesh.device_type
        return f"Mesh({dict(self.shape)}, {kind})"


def group_of(device_mesh, axes: Tuple[str, ...]) -> dist.ProcessGroup:
    """The process group over the named dims of ``device_mesh``.  Several
    dims are flattened into one sub-mesh, built with every dispatch mode
    off (the mesh's own bookkeeping tensors are neither fake nor a rank's
    work)."""
    if len(axes) == 1:
        return device_mesh.get_group(axes[0])
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return device_mesh[tuple(axes)]._flatten().get_group()


def _debug_layout(n: int, multi_pod: bool) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod and n % 2 == 0:
        return (2, 1, n // 2), ("pod", "data", "model")
    if n >= 4:
        return (2, n // 2), ("data", "model")
    return (1, n), ("data", "model")


def make_mesh(sizes: Sequence[int], axis_names: Sequence[str], device_type: str) -> Mesh:
    """A mesh over the ranks of the running process group, which must
    number ``prod(sizes)``; ``device_type`` is that of the ranks' tensors
    (``"cuda"`` or ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device_type, tuple(sizes), mesh_dim_names=tuple(axis_names))
    return Mesh(sizes, axis_names, dm)


def make_debug_mesh(n_devices: Optional[int] = None, *, multi_pod: bool = False,
                    device_type: Optional[str] = None) -> Mesh:
    """The reference's small mesh over ``n_devices`` ranks (default: the
    world size).  With the process group up and ``device_type`` given, the
    mesh holds a ``DeviceMesh``; otherwise it is abstract."""
    running = dist.is_available() and dist.is_initialized()
    n = n_devices or (dist.get_world_size() if running else 1)
    sizes, names = _debug_layout(n, multi_pod)
    if running and device_type is not None:
        return make_mesh(sizes, names, device_type)
    return Mesh(sizes, names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, abstract (sizes only)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def init_ranks(rank: int, world: int, init_method: str, *, backend: str,
               device_type: str) -> torch.device:
    """Start this process as ``rank`` of ``world`` and return its device.

    ``init_method`` is ``file://<path>`` or ``tcp://localhost:<port>``.
    ``backend="gloo"`` takes CPU ranks (``device_type="cpu"``) and CUDA
    ranks that share the cards (rank r on card r mod count);
    ``backend="nccl"`` needs a card per rank and raises with more ranks
    than cards."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    if device_type == "cpu":
        if backend != "gloo":
            raise ValueError("CPU ranks run on 'gloo'")
        device = torch.device("cpu")
    else:
        from repro_torch.device import cuda_devices

        cards = len(cuda_devices())
        if backend == "nccl" and world > cards:
            raise ValueError(
                f"nccl needs a card per rank: {world} ranks, {cards} card(s); "
                "ranks that share a card run on 'gloo'"
            )
        device = torch.device("cuda", rank % cards)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    if backend == "gloo" and device_type == "cuda":
        # DTensor's functional collectives fault on gloo with CUDA tensors;
        # the eager calls take them (parallel/collectives.py)
        from repro_torch.parallel.collectives import route_functional_collectives

        route_functional_collectives("cuda")
    return device


def placements(spec: Sequence, mesh: Mesh):
    """DTensor placements (one per mesh dim) for ``spec``: tensor dim ``i``
    with entry ``a`` is ``Shard(i)`` on mesh dim ``a``; a tuple of axes
    shards dim ``i`` over each of them, major first, which is DTensor's
    order when the axes come in mesh order (any other order raises).
    Mesh dims that no entry names are ``Replicate()``, and so are those of
    size 1 (a shard over one rank is the whole tensor; DTensor cannot merge
    or split a dim "sharded" over one rank)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [mesh.axis_names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} is not in mesh order {mesh.axis_names}")
        for m in dims:
            if out[m] != Replicate():
                raise ValueError(f"mesh axis {mesh.axis_names[m]!r} shards two dims of {spec!r}")
            if mesh.shape[mesh.axis_names[m]] > 1:
                out[m] = Shard(i)
    return out


def local_shape_and_offset(shape: Sequence[int], device_mesh, pls):
    """This rank's shard of a tensor of global ``shape`` placed by ``pls``
    on ``device_mesh``: (its shape, where it starts), by DTensor's rule
    (``torch.chunk`` along each sharded dim, one mesh dim after another),
    in plain integers — nothing runs on a tensor."""
    size, start = list(shape), [0] * len(shape)
    coord = device_mesh.get_coordinate()
    for m, p in enumerate(pls):
        if not p.is_shard():
            continue
        d, n = p.dim, device_mesh.size(m)
        chunk = -(-size[d] // n)
        begin = min(coord[m] * chunk, size[d])
        start[d] += begin
        size[d] = max(0, min(chunk, size[d] - begin))
    return tuple(size), tuple(start)


def contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))
