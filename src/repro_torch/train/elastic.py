"""Elastic training: resume on a DIFFERENT mesh/rank count.

Checkpoints store host numpy arrays (layout-free: a DTensor is gathered
whole before it is written), and the data pipeline is deterministic per
(step, host), so elasticity reduces to:

  1. restore the latest checkpoint on the new topology,
  2. recompute shardings for the new mesh (parallel/sharding.py rules are
     mesh-shape-driven),
  3. distribute params/opt under the new layouts and continue at the
     restored step — the stream is identical because batches are a pure
     function of the step index.

``elastic_resume`` packages 1–3.  Its template (the tree's structure,
shapes and dtypes) comes from an init on the ``meta`` device, which
allocates nothing.  The checkpoint is restored to the host, and each rank
moves only its own slice of each tensor to its device.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import init_params
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel.sharding import distribute, param_shardings, pure_dp_active
from repro_torch.train.checkpoint import restore_checkpoint
from repro_torch.train.optimizer import init_opt_state, zero1_shardings
from repro_torch.train.tree import tree_map


def shard_state_for_mesh(
    cfg: ModelConfig,
    mesh: Mesh,
    params: Any,
    opt_state: Any,
    *,
    global_batch: int = 0,
) -> Tuple[Any, Any]:
    """Re-place a full (host-restored, the same on every rank) train state
    onto ``mesh``: params by the param rules, the moments by ZeRO-1, each
    rank's slices only on its device.  The step counter stays a plain
    0-dim tensor, on the mesh's device."""
    pure_dp = pure_dp_active(cfg, mesh, global_batch)
    params = param_shardings(cfg, mesh, params, pure_dp=pure_dp)
    moments = {k: opt_state[k] for k in ("m", "v")}
    specs = zero1_shardings(mesh, moments)
    placed = tree_map(lambda x, s: distribute(x, mesh, s), moments, specs)
    return params, dict(placed, step=opt_state["step"].to(mesh.device))


def elastic_resume(
    cfg: ModelConfig,
    mesh: Mesh,
    checkpoint_dir: str,
    *,
    global_batch: int = 0,
) -> Tuple[int, Any, Any]:
    """Restore latest checkpoint and shard it for ``mesh``.

    Returns (step, params, opt_state); raises FileNotFoundError if no
    committed checkpoint exists."""
    params_t = init_params(cfg, torch.Generator(), device="meta")
    template = {"params": params_t, "opt": init_opt_state(params_t)}
    step, restored = restore_checkpoint(checkpoint_dir, template, device=torch.device("cpu"))
    params, opt = shard_state_for_mesh(
        cfg, mesh, restored["params"], restored["opt"], global_batch=global_batch
    )
    return step, params, opt
