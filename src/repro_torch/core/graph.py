"""Computation-graph IR for Moirai device placement.

The paper (§III-B, §III-D) works with two DAGs:

* the operator DAG  ``G = (V, E)``  — vertices are DNN operators, edges are
  data flows (this is what GCOF coarsens), and
* the *augmented* DAG ``Ḡ = (N̄, L̄)`` — every data-flow edge of the coarsened
  graph is converted into a *communication node* carrying the transfer size,
  so the MILP can schedule transfers like tasks (Fig. 8).

We keep the IR deliberately small and dependency-free: dict-of-nodes with
explicit predecessor/successor id lists.  All placement algorithms, the MILP
builder, the simulator, and the serving stage-executor consume this IR.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple


@dataclass
class OpNode:
    """One operator (or fused operator) in the computation graph.

    Attributes mirror the paper's inputs (§III-C): per-op compute cost
    (expressed device-independently as flops + bytes so the cost model can
    specialize per device), memory footprint (weights + workspace that must
    *reside* on the device hosting the op), and output size (the data-flow
    payload on every out-edge).
    """

    id: int
    op_type: str                      # e.g. "matmul", "conv", "bn", "relu", "conv∘bn"
    flops: float = 0.0                # forward FLOPs of this op
    bytes_accessed: float = 0.0       # HBM traffic if executed unfused
    param_bytes: float = 0.0          # resident memory (weights)
    kv_bytes: float = 0.0             # per-request resident state (KV cache);
                                      # multiplied by serving slots in Eq. 5
    output_bytes: float = 0.0         # payload carried by each outgoing edge
    inputs: List[int] = field(default_factory=list)    # predecessor op ids
    outputs: List[int] = field(default_factory=list)   # successor op ids
    tag: str = ""                     # "", "fused", "bound" (Algorithm 1)
    fused_ids: Tuple[int, ...] = ()   # original op ids folded into this node
    meta: dict = field(default_factory=dict)

    def copy(self) -> "OpNode":
        return replace(
            self,
            inputs=list(self.inputs),
            outputs=list(self.outputs),
            fused_ids=tuple(self.fused_ids),
            meta=dict(self.meta),
        )


class OpGraph:
    """A DAG of :class:`OpNode`. Node ids are stable but not necessarily dense."""

    def __init__(self, nodes: Optional[Iterable[OpNode]] = None, name: str = "graph"):
        self.name = name
        self.nodes: Dict[int, OpNode] = {}
        self._next_id = 0
        # sequence length the node costs were counted at (set by the model
        # graph builders); prefill-aware scoring rescales per-chunk work
        # relative to this — None for graphs with no token axis (paper CV
        # models, synthetic DAGs)
        self.seq_len: Optional[int] = None
        for n in nodes or ():
            self.add_existing(n)

    # ------------------------------------------------------------------ build
    def add(
        self,
        op_type: str,
        inputs: Sequence[int] = (),
        *,
        flops: float = 0.0,
        bytes_accessed: float = 0.0,
        param_bytes: float = 0.0,
        kv_bytes: float = 0.0,
        output_bytes: float = 0.0,
        meta: Optional[dict] = None,
    ) -> int:
        nid = self._next_id
        self._next_id += 1
        node = OpNode(
            id=nid,
            op_type=op_type,
            flops=flops,
            bytes_accessed=bytes_accessed,
            param_bytes=param_bytes,
            kv_bytes=kv_bytes,
            output_bytes=output_bytes,
            inputs=list(inputs),
            meta=meta or {},
        )
        self.nodes[nid] = node
        for p in inputs:
            self.nodes[p].outputs.append(nid)
        return nid

    def add_existing(self, node: OpNode) -> None:
        self.nodes[node.id] = node
        self._next_id = max(self._next_id, node.id + 1)

    def fresh_id(self) -> int:
        nid = self._next_id
        self._next_id += 1
        return nid

    # ------------------------------------------------------------ structure
    def __len__(self) -> int:
        return len(self.nodes)

    def __contains__(self, nid: int) -> bool:
        return nid in self.nodes

    def edges(self) -> Iterable[Tuple[int, int]]:
        for n in self.nodes.values():
            for s in n.outputs:
                yield (n.id, s)

    def num_edges(self) -> int:
        return sum(len(n.outputs) for n in self.nodes.values())

    def roots(self) -> List[int]:
        return [n.id for n in self.nodes.values() if not n.inputs]

    def sinks(self) -> List[int]:
        return [n.id for n in self.nodes.values() if not n.outputs]

    def topo_order(self) -> List[int]:
        """Kahn topological order; raises ValueError on a cycle."""
        indeg = {nid: len(n.inputs) for nid, n in self.nodes.items()}
        # deterministic: lowest id first
        ready = sorted([nid for nid, d in indeg.items() if d == 0])
        import heapq

        heapq.heapify(ready)
        order: List[int] = []
        while ready:
            nid = heapq.heappop(ready)
            order.append(nid)
            for s in self.nodes[nid].outputs:
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(ready, s)
        if len(order) != len(self.nodes):
            raise ValueError(f"graph {self.name!r} has a cycle")
        return order

    def is_dag(self) -> bool:
        try:
            self.topo_order()
            return True
        except ValueError:
            return False

    def successors_closure(self) -> Dict[int, Set[int]]:
        """Succ(i): all direct and indirect successors of each node (paper Table II)."""
        order = self.topo_order()
        succ: Dict[int, Set[int]] = {nid: set() for nid in self.nodes}
        for nid in reversed(order):
            s = succ[nid]
            for child in self.nodes[nid].outputs:
                s.add(child)
                s |= succ[child]
        return succ

    # --------------------------------------------------------------- mutate
    def remove_node(self, nid: int) -> None:
        node = self.nodes.pop(nid)
        for p in node.inputs:
            if p in self.nodes:
                self.nodes[p].outputs = [o for o in self.nodes[p].outputs if o != nid]
        for s in node.outputs:
            if s in self.nodes:
                self.nodes[s].inputs = [i for i in self.nodes[s].inputs if i != nid]

    def copy(self) -> "OpGraph":
        g = OpGraph(name=self.name)
        g.seq_len = self.seq_len
        for n in self.nodes.values():
            g.add_existing(n.copy())
        g._next_id = self._next_id
        return g

    # ------------------------------------------------------------ aggregate
    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes.values())

    def total_param_bytes(self) -> float:
        return sum(n.param_bytes for n in self.nodes.values())

    def total_kv_bytes(self) -> float:
        return sum(n.kv_bytes for n in self.nodes.values())

    def validate(self) -> None:
        """Internal consistency: symmetric adjacency, DAG, ids resolve."""
        for nid, n in self.nodes.items():
            assert n.id == nid
            for p in n.inputs:
                assert p in self.nodes, f"dangling input {p} of {nid}"
                assert nid in self.nodes[p].outputs, f"asymmetric edge {p}->{nid}"
            for s in n.outputs:
                assert s in self.nodes, f"dangling output {s} of {nid}"
                assert nid in self.nodes[s].inputs, f"asymmetric edge {nid}->{s}"
        self.topo_order()  # raises on cycle


# --------------------------------------------------------------------------
# Augmented DAG (paper Fig. 8): links -> communication nodes.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class CommNode:
    """A data-flow task η_q ∈ N̄ − N: the transfer of `bytes` from op `src` to op `dst`."""

    id: int
    src: int
    dst: int
    bytes: float


@dataclass
class AugmentedDAG:
    """Ḡ = (N̄, L̄).  op ids keep their identity; comm nodes get fresh ids."""

    graph: OpGraph                       # the (coarsened) op graph G
    comm: Dict[int, CommNode]            # comm-node id -> CommNode
    edge_to_comm: Dict[Tuple[int, int], int]   # (src op, dst op) -> comm id

    def all_ids(self) -> List[int]:
        return list(self.graph.nodes.keys()) + list(self.comm.keys())

    def succ_closure(self) -> Dict[int, Set[int]]:
        """Succ̄(i) over N̄ (ops and comm nodes interleaved)."""
        # Build adjacency of the augmented DAG: op -> comm -> op
        adj: Dict[int, List[int]] = {nid: [] for nid in self.all_ids()}
        for (u, v), q in self.edge_to_comm.items():
            adj[u].append(q)
            adj[q].append(v)
        # topo over augmented graph
        indeg = {nid: 0 for nid in adj}
        for u, vs in adj.items():
            for v in vs:
                indeg[v] += 1
        import heapq

        ready = [nid for nid, d in indeg.items() if d == 0]
        heapq.heapify(ready)
        order: List[int] = []
        while ready:
            nid = heapq.heappop(ready)
            order.append(nid)
            for v in adj[nid]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    heapq.heappush(ready, v)
        if len(order) != len(adj):
            raise ValueError("augmented DAG has a cycle")
        succ: Dict[int, Set[int]] = {nid: set() for nid in adj}
        for nid in reversed(order):
            s = succ[nid]
            for child in adj[nid]:
                s.add(child)
                s |= succ[child]
        return succ


def augment(graph: OpGraph) -> AugmentedDAG:
    """Convert every data-flow edge of ``graph`` into a communication node (Fig. 8)."""
    comm: Dict[int, CommNode] = {}
    edge_to_comm: Dict[Tuple[int, int], int] = {}
    next_id = max(graph.nodes.keys(), default=-1) + 1
    for u, v in sorted(graph.edges()):
        q = next_id
        next_id += 1
        comm[q] = CommNode(id=q, src=u, dst=v, bytes=graph.nodes[u].output_bytes)
        edge_to_comm[(u, v)] = q
    return AugmentedDAG(graph=graph, comm=comm, edge_to_comm=edge_to_comm)


# --------------------------------------------------------------------------
# Convenience constructors used by tests and benchmarks.
# --------------------------------------------------------------------------


def chain_graph(op_types: Sequence[str], **node_kw) -> OpGraph:
    g = OpGraph(name="chain")
    prev: List[int] = []
    for t in op_types:
        nid = g.add(t, inputs=prev, **node_kw)
        prev = [nid]
    return g


def random_dag(
    n: int,
    *,
    seed: int = 0,
    edge_prob: float = 0.15,
    op_types: Sequence[str] = ("matmul", "add", "relu", "conv", "bn", "softmax"),
    flops_range: Tuple[float, float] = (1e6, 1e9),
    out_bytes_range: Tuple[float, float] = (1e3, 1e6),
) -> OpGraph:
    """Random layered DAG for property tests (edges only forward in id order)."""
    import random as _random

    rng = _random.Random(seed)
    g = OpGraph(name=f"rand{n}_{seed}")
    for i in range(n):
        # connect to a random subset of earlier nodes; guarantee weak connectivity
        preds = [j for j in range(i) if rng.random() < edge_prob]
        if i > 0 and not preds:
            preds = [rng.randrange(i)]
        g.add(
            rng.choice(list(op_types)),
            inputs=preds,
            flops=rng.uniform(*flops_range),
            bytes_accessed=rng.uniform(*out_bytes_range) * 3,
            param_bytes=rng.uniform(0, 1e6),
            output_bytes=rng.uniform(*out_bytes_range),
        )
    return g
