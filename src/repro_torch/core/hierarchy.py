"""Hierarchical decomposition: scale the exact MILP to multi-thousand-node graphs.

The paper solves 3.6k–35k-node instances with Gurobi in minutes; HiGHS on one
CPU core cannot (the non-overlap family is O(n²·K) binaries).  We extend the
paper's own idea — coarsen first, place coarse — one level further:

1. topological-window clustering: topo order → windows balanced by FLOPs,
2. each window's (undirected) connected components become supernodes —
   parallel branches inside a window stay *separate* supernodes so the MILP
   can still spread them across devices,
3. the exact Moirai MILP places the supernode graph,
4. members inherit their supernode's device.

Contracting windows of a topological order can never create a cycle (edges
only go forward in window index; intra-window edges are intra-component),
so the supernode graph is a DAG by construction — property-tested.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .graph import OpGraph, OpNode


def chain_contract(graph: OpGraph) -> Tuple[OpGraph, Dict[int, int]]:
    """Contract maximal linear chains (u→v where u has out-degree 1 and v has
    in-degree 1) into supernodes.  Unlike topo-window clustering this KEEPS
    parallel branches (q/k/v projections, MoE experts, evoformer branches)
    as separate placeable units — the parallelism Moirai exploits.

    Returns (contracted graph, member→supernode map)."""
    parent: Dict[int, int] = {nid: nid for nid in graph.nodes}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in list(graph.edges()):
        if len(graph.nodes[u].outputs) == 1 and len(graph.nodes[v].inputs) == 1:
            ru, rv = find(u), find(v)
            if ru != rv:
                parent[max(ru, rv)] = min(ru, rv)

    member_to_super = {nid: find(nid) for nid in graph.nodes}
    return _materialize_clusters(graph, member_to_super), member_to_super


def _count_unordered_pairs(graph: OpGraph, cap: int) -> int:
    """Number of node pairs with NO precedence relation (the MILP's
    non-overlap binaries); early-exits once past ``cap``."""
    succ = graph.successors_closure()
    ids = sorted(graph.nodes)
    count = 0
    for i, a in enumerate(ids):
        for b in ids[i + 1 :]:
            if b not in succ[a] and a not in succ[b]:
                count += 1
                if count > cap:
                    return count
    return count


def cluster_graph(
    graph: OpGraph, max_nodes: int
) -> Tuple[OpGraph, Dict[int, int]]:
    """Contract ``graph`` to ≤ ~max_nodes supernodes.

    Returns (supernode graph, member -> supernode id map).
    """
    n = len(graph.nodes)
    if n <= max_nodes:
        return graph.copy(), {nid: nid for nid in graph.nodes}

    order = graph.topo_order()
    total_flops = max(graph.total_flops(), 1.0)
    # windows balanced by flops — aim for max_nodes/2 windows so component
    # splitting stays under budget
    n_windows = max(2, max_nodes // 2)
    budget = total_flops / n_windows

    window_of: Dict[int, int] = {}
    acc, w = 0.0, 0
    for nid in order:
        node = graph.nodes[nid]
        window_of[nid] = w
        acc += max(node.flops, total_flops / (4 * n))  # zero-flop ops still count a little
        if acc >= budget and w < n_windows - 1:
            acc, w = 0.0, w + 1

    # connected components within each window (undirected, intra-window edges)
    parent: Dict[int, int] = {nid: nid for nid in graph.nodes}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    for u, v in graph.edges():
        if window_of[u] == window_of[v]:
            union(u, v)

    member_to_super: Dict[int, int] = {nid: find(nid) for nid in graph.nodes}
    return _materialize_clusters(graph, member_to_super), member_to_super


def _materialize_clusters(
    graph: OpGraph, member_to_super: Dict[int, int]
) -> OpGraph:
    super_members: Dict[int, List[int]] = {}
    for nid, s in member_to_super.items():
        super_members.setdefault(s, []).append(nid)

    out = OpGraph(name=graph.name + "+super")
    for sid, members in super_members.items():
        nodes = [graph.nodes[m] for m in members]
        # external output payload: sum of payloads on edges leaving the group
        mset = set(members)
        ext_out = sum(
            graph.nodes[m].output_bytes
            for m in members
            for s2 in graph.nodes[m].outputs
            if s2 not in mset
        )
        # efficiency anchor: the dominant-cost member's op type
        dom = max(nodes, key=lambda x: x.flops)
        node = OpNode(
            id=sid,
            op_type=dom.op_type if len(nodes) > 1 else nodes[0].op_type,
            flops=sum(x.flops for x in nodes),
            bytes_accessed=sum(x.bytes_accessed for x in nodes),
            param_bytes=sum(x.param_bytes for x in nodes),
            kv_bytes=sum(x.kv_bytes for x in nodes),
            output_bytes=ext_out,
            fused_ids=tuple(sorted(members)),
        )
        if len(nodes) > 1:
            # members run SERIALLY on whatever device hosts the supernode
            # (unlike gcof fusions, which the backend compiles into one
            # kernel) — cost model must sum per-member roofline maxima, not
            # take max of sums (which underestimates mixed chains)
            node.meta["serial"] = [
                (x.flops, x.bytes_accessed, x.op_type) for x in nodes
            ]
        out.add_existing(node)
    for u, v in graph.edges():
        su, sv = member_to_super[u], member_to_super[v]
        if su == sv:
            continue
        if sv not in out.nodes[su].outputs:
            out.nodes[su].outputs.append(sv)
            out.nodes[sv].inputs.append(su)
    out.validate()
    return out


def lift_placement(
    member_to_super: Dict[int, int], super_placement: Dict[int, int]
) -> Dict[int, int]:
    """Map a supernode placement back to the members."""
    return {m: super_placement[s] for m, s in member_to_super.items()}
