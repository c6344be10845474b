"""Parameter / input / cache PartitionSpec rules for the production mesh.

Axis layout (launch/mesh.py):
  single pod : (data=16, model=16)
  multi-pod  : (pod=2, data=16, model=16)

Policy (the paper-faithful *baseline*; §Perf hillclimbs deviate per-cell):
  * DP  — batch over (pod, data)
  * TP  — attention heads / FFN hidden / vocab over "model"
  * EP  — MoE experts over "data" (all-to-all stays on intra-pod ICI;
          experts replicate across pods), expert FFN hidden over "model"
  * ZeRO-1 — optimizer state additionally sharded over the DP axes
  * SSM (mamba2 trunks) — replicated over "model" (head counts are not
    TP-divisible for mamba2-130m; revisited in §Perf for zamba2)
  * decode caches — batch over DP; KV heads over "model" when divisible,
    else cache *sequence* over "model"; for global_batch=1 (long_500k) the
    cache sequence shards over "data" too.

Rules are name-based over the param-tree paths, right-aligned so stacked
layer params ([L, ...] from scan) get leading None automatically; the
port's per-layer lists add nothing to a path (list indices are skipped, as
the reference skips sequence keys).  The rules are the reference's,
verbatim; they take the port's :class:`~repro_torch.launch.mesh.Mesh`
(abstract or real) and return the port's ``PartitionSpec``.
:func:`param_shardings` places a param tree onto a mesh's ranks.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import Mesh, PartitionSpec as P, placements
from repro_torch.train.tree import tree_map_with_path

MeshAxes = Any


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def pure_dp_active(cfg: ModelConfig, mesh: Mesh, global_batch: int) -> bool:
    """§Perf (qwen2-moe): pure DP×EP layout applies when the arch prefers it
    and the batch covers (data × model) [× pod] replicas exactly."""
    if not getattr(cfg, "prefer_pure_dp", False):
        return False
    full = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    return global_batch % full == 0 or (
        "pod" not in mesh.shape
        and global_batch % (mesh.shape["data"] * mesh.shape["model"]) == 0
    )


def dp_axes_for(cfg: ModelConfig, mesh: Mesh, global_batch: int) -> Tuple[str, ...]:
    if pure_dp_active(cfg, mesh, global_batch):
        return tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    return dp_axes(mesh)


def _divisible(n: int, mesh: Mesh, axis: str) -> bool:
    return axis in mesh.shape and n % mesh.shape[axis] == 0


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

# rule table: innermost param name -> core-dims spec builder
def _param_core_spec(
    path: Tuple[str, ...], shape: Tuple[int, ...], cfg: ModelConfig, mesh: Mesh,
    *, pure_dp: bool = False,
):
    name = path[-1]
    in_moe = any("moe" in n for n in path)
    mamba_names = (
        "w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x", "conv_B", "conv_C",
        "b_x", "b_B", "b_C", "A_log", "D", "dt_bias",
    )
    in_mamba = any("mamba" in n for n in path) or name in mamba_names
    tp = "model"
    if pure_dp:
        # replicate the dense trunk (incl. embed/lm_head — the batch spec
        # already consumes the model axis, so vocab cannot also use it);
        # experts shard over data only
        if in_moe and name in ("w_gate", "w_up", "w_down"):
            ep_ok = _divisible(shape[-3], mesh, "data")
            return ("data" if ep_ok else None, None, None)
        return None
    if in_mamba:
        # §Perf (zamba2): shard the trunk over the TP axis when head counts
        # divide it — d_inner (w_z/w_x out, conv_x ch, norm) over "model" and
        # per-head params over "model"; B/C projections stay replicated (GN
        # is small and shared by all heads).  mamba2-130m (24 heads) keeps
        # the replicated fallback.
        d_inner = cfg.ssm_expand * cfg.d_model
        nheads = d_inner // max(cfg.ssm_headdim, 1)
        ok = cfg.ssm_state > 0 and d_inner % mesh.shape.get(tp, 1) == 0 \
            and nheads % mesh.shape.get(tp, 1) == 0
        if not ok:
            return None
        if name in ("w_z", "w_x"):
            return (None, tp)
        if name == "w_dt":
            return (None, tp)
        if name in ("conv_x",):
            return (None, tp)
        if name in ("b_x",):
            return (tp,)
        if name in ("A_log", "D", "dt_bias"):
            return (tp,)
        if name == "norm_w":
            return (tp,)
        if name == "out_proj":
            return (tp, None)
        return None  # w_B, w_C, conv_B/C, b_B/C: replicate
    if name == "embed":
        return (tp, None) if _divisible(shape[-2] if len(shape) > 1 else 0, mesh, tp) else None
    if name == "lm_head":
        return (None, tp) if _divisible(shape[-1], mesh, tp) else None
    if name in ("wq", "wk", "wv"):
        return (None, tp) if _divisible(shape[-1], mesh, tp) else None
    if name == "wo":
        return (tp, None) if _divisible(shape[-2], mesh, tp) else None
    if name in ("w_gate", "w_up"):
        if in_moe:
            ep_ok = _divisible(shape[-3], mesh, "data")
            tp_ok = _divisible(shape[-1], mesh, tp)
            return ("data" if ep_ok else None, None, tp if tp_ok else None)
        return (None, tp) if _divisible(shape[-1], mesh, tp) else None
    if name == "w_down":
        if in_moe:
            ep_ok = _divisible(shape[-3], mesh, "data")
            tp_ok = _divisible(shape[-2], mesh, tp)
            return ("data" if ep_ok else None, tp if tp_ok else None, None)
        return (tp, None) if _divisible(shape[-2], mesh, tp) else None
    if name == "shared_proj_in":
        return (None, None)
    if name == "router":
        return (None, None)
    return None  # norms, scalars, biases: replicate


def _names(path) -> Tuple[str, ...]:
    return tuple(k for k in path if isinstance(k, str))


def param_pspec_tree(cfg: ModelConfig, mesh: Mesh, params_shape, *, pure_dp: bool = False) -> Any:
    """Map a param tree (tensors, or anything with a ``.shape``) to a
    PartitionSpec tree."""

    def one(path, leaf):
        names = _names(path)
        shape = tuple(leaf.shape)
        core = _param_core_spec(names, shape, cfg, mesh, pure_dp=pure_dp)
        if core is None:
            return P()
        pad = len(shape) - len(core)
        if pad < 0:
            return P()
        return P(*((None,) * pad + tuple(core)))

    return tree_map_with_path(one, params_shape)


def distribute(x, mesh: Mesh, spec: Sequence):
    """``x`` (the same full tensor on every rank, on the host or on the
    mesh's device) as a DTensor laid out by ``spec`` on ``mesh``'s ranks,
    with no communication: each rank cuts its own slice where ``x`` lies,
    as DTensor's ``Shard`` does (``torch.chunk`` along the tensor dim, one
    mesh dim after another), and only that slice reaches the mesh's
    device.  A slice smaller than ``x`` is a copy, so that dropping ``x``
    frees the rest."""
    from torch.distributed.tensor import DTensor, Shard

    dm = mesh.device_mesh
    layout = placements(spec, mesh)
    coord = dm.get_coordinate()
    local = x
    for i, p in enumerate(layout):
        if isinstance(p, Shard):
            pieces = torch.chunk(local, dm.size(i), dim=p.dim)
            local = (pieces[coord[i]] if coord[i] < len(pieces)
                     else local.narrow(p.dim, local.size(p.dim), 0))
    if local.device != mesh.device:
        local = local.to(mesh.device)
    elif local.numel() != x.numel():
        local = local.clone()
    return DTensor.from_local(local.contiguous(), dm, layout, run_check=False,
                              shape=x.shape, stride=x.stride())


def param_shardings(cfg: ModelConfig, mesh: Mesh, params, *, pure_dp: bool = False) -> Any:
    """``params`` (every rank holding the same full tree) distributed onto
    ``mesh``'s ranks by :func:`param_pspec_tree`."""
    specs = param_pspec_tree(cfg, mesh, params, pure_dp=pure_dp)
    return tree_map_with_path(
        lambda path, x: distribute(x, mesh, _spec_at(specs, path)), params
    )


def _spec_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --------------------------------------------------------------------------
# batches
# --------------------------------------------------------------------------


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> Dict[str, P]:
    dp = dp_axes_for(cfg, mesh, shape.global_batch)
    dp_size = int(np.prod([mesh.shape[a] for a in dp]))
    bspec: MeshAxes = dp if shape.global_batch % max(dp_size, 1) == 0 else None
    specs: Dict[str, P] = {}
    if cfg.frontend == "patch_stub":
        specs["embeds"] = P(bspec, None, None)
        specs["positions"] = P(None, bspec, None)
    elif cfg.frontend == "frame_stub":
        specs["frames"] = P(bspec, None, None)
        specs["tokens"] = P(bspec, None)
    else:
        specs["tokens"] = P(bspec, None)
    if shape.kind == "train":
        specs["labels"] = P(bspec, None)
    return specs


def cache_pspec_tree(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, cache_shape) -> Any:
    """Specs for the KV/SSM cache tree (leading dim = layers/occurrences)."""
    dp = dp_axes(mesh)
    dp_size = int(np.prod([mesh.shape[a] for a in dp]))
    batch_sharded = shape.global_batch % max(dp_size, 1) == 0
    bspec: MeshAxes = dp if batch_sharded else None
    kv_tp = _divisible(cfg.n_kv_heads, mesh, "model")

    def one(path, leaf):
        names = tuple(str(k) for k in path)
        shp = tuple(leaf.shape)
        if names and names[-1] in ("k", "v") and len(shp) == 5:
            # [L, B, S, KV, hd]
            if kv_tp:
                seq = None if batch_sharded else "data"
                return P(None, bspec, seq, "model", None)
            seq = "model" if batch_sharded else ("data", "model")
            return P(None, bspec, seq, None, None)
        if names and names[-1] == "ssm" and len(shp) == 5:
            # [L, B, H, P, N] — small; batch-shard if possible
            return P(None, bspec, None, None, None)
        if names and names[-1] == "conv" and len(shp) == 4:
            return P(None, bspec, None, None)
        # fallback: batch-shard dim 1 when it matches
        if len(shp) >= 2 and shp[1] == shape.global_batch and batch_sharded:
            return P(None, bspec, *([None] * (len(shp) - 2)))
        return P(*([None] * len(shp)))

    return tree_map_with_path(one, cache_shape)


def cache_on_mesh(cfg: ModelConfig, cache, global_batch: int, max_len: int):
    """Zeros shaped like ``cache`` (a cache tree; any device, ``meta``
    included) as DTensors on the running context's mesh, laid out by
    :func:`cache_pspec_tree` for a global batch of ``global_batch`` and
    ``max_len`` positions, each rank allocating its shard only; ``None``
    outside a context on a real mesh."""
    from torch.distributed.tensor import zeros as dzeros

    from repro_torch.parallel.context import current_context

    ctx = current_context()
    if ctx is None or ctx.mesh is None or ctx.mesh.device_mesh is None:
        return None
    mesh = ctx.mesh
    shape = ShapeConfig("cache", seq_len=max_len, global_batch=global_batch, kind="decode")
    specs = cache_pspec_tree(cfg, shape, mesh, cache)
    return tree_map_with_path(
        lambda path, x: dzeros(tuple(x.shape), dtype=x.dtype, device_mesh=mesh.device_mesh,
                               placements=placements(_spec_at(specs, path), mesh)),
        cache)


def logical_rules(mesh: Mesh) -> Dict[str, MeshAxes]:
    from repro_torch.parallel.context import default_rules

    return default_rules("pod" in mesh.shape)
