"""The launcher's parallel context for a cell: :func:`make_context`.

The reference's dry-run lowers and compiles every (arch × shape × mesh)
cell on a 512-device host mesh; its ``input_specs``, ``run_cell`` and
``main`` come to the port with the launch tools (``launch/roofline.py``,
``launch/roofline_fd.py``: ROADMAP A13 item 5).  What the sharded trainer
needs now is the context: the logical rules, the expert axes and the DP/TP
split, including qwen2-moe's pure DP × EP layout.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel.context import ParallelContext
from repro_torch.parallel.sharding import dp_axes, logical_rules


def make_context(mesh: Mesh, cfg: ModelConfig = None, global_batch: int = 0) -> ParallelContext:
    from repro_torch.parallel.sharding import dp_axes_for, pure_dp_active

    pure_dp = cfg is not None and pure_dp_active(cfg, mesh, global_batch)
    rules = logical_rules(mesh)
    if pure_dp:
        dp = dp_axes_for(cfg, mesh, global_batch)
        rules = dict(rules)
        rules.update({"batch": dp, "heads": None, "kv_heads": None,
                      "ff": None, "vocab": None, "experts": "data",
                      "expert_ff": None})
        return ParallelContext(mesh, rules, ep_axes=("data",), dp_axes=dp,
                               tp_axis=None)
    return ParallelContext(
        mesh,
        rules,
        ep_axes=("data",),
        dp_axes=dp_axes(mesh),
        tp_axis="model",
    )
