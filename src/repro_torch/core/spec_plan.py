"""Joint draft+target placement for speculative serving.

Moirai's premise is that heterogeneous clusters have weak devices a good
planner should still exploit; a draft model is the ideal tenant for exactly
those devices — but only if the *placement problem* covers draft and target
jointly.  This module merges the two operator graphs into ONE placement
problem:

* the merged graph holds both models' nodes with disjoint ids and no cross
  edges (the draft/target interaction is token-level, not tensor-level);
* every node carries ``meta["pass_rate"]`` — forwards per COMMITTED token.
  With ``k`` draft tokens per round at acceptance rate ``a``, a round
  commits ``E = expected_accepted_tokens(a, k)`` tokens from one target
  verify forward and ``k`` draft forwards, so target nodes run ``1/E``
  and draft nodes ``k/E`` passes per token.  ``bottleneck_time``, the
  pipeline simulator's decode rounds, and the MILP's throughput busy
  accumulators all multiply decode work by this rate (and ONLY decode work
  — both models prefill the prompt exactly once per request);
* memory is shared and unscaled: Eq. 5 charges ``param_bytes +
  serving_slots × kv_bytes`` for every node of BOTH graphs on whatever
  device hosts it, so the draft competes for the same HBM the target's KV
  cache wants.

Because the two subgraphs are disjoint components, ``simulate_pipeline``'s
event loop runs them concurrently — draft busy time naturally overlaps
target verify on other devices, which is the whole point of placing the
draft on otherwise-idle weak devices.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .costmodel import CostModel, expected_accepted_tokens
from .devices import ClusterSpec
from .graph import OpGraph
from .placement import PlanConfig, plan


def merge_spec_graphs(
    target_graph: OpGraph,
    draft_graph: OpGraph,
    *,
    spec_tokens: int,
    acceptance_rate: float,
) -> Tuple[OpGraph, Dict[int, int], Dict[int, int]]:
    """Merge target + draft graphs into one placement problem.

    Returns ``(merged, target_map, draft_map)`` where the maps take each
    original node id to its id in the merged graph.  Target nodes get
    ``meta["pass_rate"] = 1/E`` and draft nodes ``k/E``; all byte counts
    (params, KV, activations) are copied unscaled — rates scale *time*,
    residency is residency.
    """
    e = expected_accepted_tokens(acceptance_rate, spec_tokens)
    merged = OpGraph(name=f"{target_graph.name}+{draft_graph.name}[spec]")
    merged.seq_len = target_graph.seq_len
    maps: Tuple[Dict[int, int], Dict[int, int]] = ({}, {})
    for which, (g, rate) in enumerate(
        ((target_graph, 1.0 / e), (draft_graph, float(spec_tokens) / e))
    ):
        remap = maps[which]
        for nid in g.topo_order():
            node = g.nodes[nid]
            meta = dict(node.meta)
            meta["pass_rate"] = rate
            meta["spec_role"] = "target" if which == 0 else "draft"
            remap[nid] = merged.add(
                node.op_type,
                inputs=[remap[i] for i in node.inputs],
                flops=node.flops,
                bytes_accessed=node.bytes_accessed,
                param_bytes=node.param_bytes,
                kv_bytes=node.kv_bytes,
                output_bytes=node.output_bytes,
                meta=meta,
            )
    merged.validate()
    return merged, maps[0], maps[1]


def split_spec_placement(
    placement: Dict[int, int],
    target_map: Dict[int, int],
    draft_map: Dict[int, int],
) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Project a merged-graph placement back onto the original node ids."""
    tgt = {orig: placement[mid] for orig, mid in target_map.items()}
    dft = {orig: placement[mid] for orig, mid in draft_map.items()}
    return tgt, dft


@dataclass
class SpecPlan:
    """Joint plan: the merged-graph result plus per-model projections."""

    result: object                      # PlacementResult on the merged graph
    merged: OpGraph
    target_placement: Dict[int, int]
    draft_placement: Dict[int, int]
    target_map: Dict[int, int]
    draft_map: Dict[int, int]
    spec_tokens: int
    acceptance_rate: float
    expected_tokens_per_round: float


def plan_speculative(
    target_graph: OpGraph,
    draft_graph: OpGraph,
    cluster: ClusterSpec,
    config: Optional[PlanConfig] = None,
    *,
    cost: Optional[CostModel] = None,
    **overrides,
) -> SpecPlan:
    """Place draft + target jointly on one cluster.

    Runs the full :func:`repro_torch.core.placement.plan` envelope (MILP +
    heuristics, objective-aware) over the merged pass-rate-annotated graph,
    so Eq. 5 memory is shared across both models and the throughput
    objective minimizes the max per-device busy time SUMMED across both
    graphs' decode work (plus each graph's once-per-request prefill).

    Args:
        target_graph, draft_graph: block-granularity model graphs (same
            ``seq_len``).
        cluster: the shared heterogeneous cluster.
        config: plan knobs; ``spec_tokens``/``acceptance_rate`` are read
            from it (``PlanConfig.draft_config`` names the draft for
            callers that build graphs from configs).
        cost: optional pre-built cost model over ``cluster``.
        **overrides: ``PlanConfig`` field overrides.

    Returns:
        A :class:`SpecPlan`; ``result.placement`` stays keyed by merged
        ids, the ``target_placement``/``draft_placement`` projections are
        what executors consume.
    """
    cfg = dataclasses.replace(config) if config is not None else PlanConfig()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    k = int(getattr(cfg, "spec_tokens", 0) or 0)
    if k < 1:
        raise ValueError("plan_speculative needs PlanConfig.spec_tokens >= 1")
    a = float(getattr(cfg, "acceptance_rate", 0.75))
    merged, tmap, dmap = merge_spec_graphs(
        target_graph, draft_graph, spec_tokens=k, acceptance_rate=a
    )
    res = plan(merged, cluster, cfg, cost=cost)
    tgt, dft = split_spec_placement(res.placement, tmap, dmap)
    res.extra["spec_tokens"] = k
    res.extra["acceptance_rate"] = a
    res.extra["expected_tokens_per_round"] = expected_accepted_tokens(a, k)
    return SpecPlan(
        result=res,
        merged=merged,
        target_placement=tgt,
        draft_placement=dft,
        target_map=tmap,
        draft_map=dmap,
        spec_tokens=k,
        acceptance_rate=a,
        expected_tokens_per_round=expected_accepted_tokens(a, k),
    )
