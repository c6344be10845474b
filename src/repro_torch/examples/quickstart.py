"""Quickstart: the four Moirai steps on a real model graph, end to end.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

Host code only (the planner): the same on a machine with a card or
without one.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.core import CostModel, get_cluster, plan, simulate
from repro_torch.core.fusion import DEFAULT_RULES, gcof
from repro_torch.core.modelgraph import transformer_graph

METHODS = ("moirai", "msct", "getf", "round_robin")


def run(methods=METHODS, time_limit=20, mip_rel_gap=0.05) -> dict:
    """The four steps, printed as the reference prints them; returns the
    graph, its coarsened form, and each method's plan and makespan (s) on
    the coarsened graph."""
    # 1. INPUT PROFILING — a heterogeneous 4-GPU cluster (paper Table III)
    #    and the llama3.2-1b computation graph at fine granularity
    cluster = get_cluster("inter_server")
    cost = CostModel(cluster)
    cfg = get_config("llama3.2-1b")
    graph = transformer_graph(cfg, seq_len=2048, granularity="fine")
    print(f"model graph: {len(graph)} operators, {graph.num_edges()} data flows")

    # 2. GRAPH COARSENING — GCOF merges backend-fusible chains
    coarse = gcof(graph, DEFAULT_RULES)
    print(f"after GCOF:  {len(coarse)} operators ({100*len(coarse)/len(graph):.0f}%)")

    # 3+4. MILP MODEL + SOLVE — and baselines for comparison
    results = {}
    for method in methods:
        res = plan(graph, cluster, method=method, time_limit=time_limit,
                   mip_rel_gap=mip_rel_gap)
        makespan = simulate(coarse, {
            nid: res.placement[node.fused_ids[0]]
            for nid, node in coarse.nodes.items()
        }, cost).makespan
        devices = sorted(set(res.placement.values()))
        print(
            f"{method:12s} makespan={makespan*1e3:8.3f} ms  "
            f"devices={devices}  gen={res.solve_time:5.2f}s  via={res.method}"
        )
        results[method] = (res, makespan)
    return {"graph": graph, "coarse": coarse, "results": results}


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    return run()


if __name__ == "__main__":
    main()
