# Moirai device placement: graph IR, GCOF fusion coarsening, heterogeneous
# cluster model, MILP + heuristic + RL planners, event simulator.
from .costmodel import CostModel, expected_accepted_tokens
from .devices import ClusterSpec, DeviceSpec, get_cluster
from .fusion import DEFAULT_RULES, EIGEN_RULES, XLA_RULES, gcof, runtime_fuse
from .graph import AugmentedDAG, OpGraph, OpNode, augment
from .milp import PlacementResult, solve_placement
from .placement import PlanConfig, plan, replan
from .simulate import (
    PipelineResult,
    SimResult,
    bottleneck_time,
    evaluate,
    simulate,
    simulate_pipeline,
    validate_pipeline_schedule,
    validate_schedule,
)
from .spec_plan import SpecPlan, merge_spec_graphs, plan_speculative

__all__ = [
    "AugmentedDAG",
    "ClusterSpec",
    "CostModel",
    "DEFAULT_RULES",
    "DeviceSpec",
    "EIGEN_RULES",
    "OpGraph",
    "OpNode",
    "PipelineResult",
    "PlacementResult",
    "PlanConfig",
    "SimResult",
    "SpecPlan",
    "XLA_RULES",
    "augment",
    "bottleneck_time",
    "evaluate",
    "expected_accepted_tokens",
    "gcof",
    "get_cluster",
    "merge_spec_graphs",
    "plan",
    "plan_speculative",
    "replan",
    "simulate",
    "simulate_pipeline",
    "solve_placement",
    "validate_pipeline_schedule",
    "validate_schedule",
]
