"""Graph Coarsening with Operator Fusion — GCOF (paper Algorithm 1).

The coarsener groups operator chains that the inference backend would fuse at
runtime, so that (a) the placement search space shrinks and (b) fused chains
are never split across devices, preserving the backend's inter-operator
optimization (the paper's core observation).

Semantics, faithful to Algorithm 1 + the Fig. 7 walk-through:

* A *fusion rule* is an ordered list of op types (Table I).
* ``is_rule``      — the concatenated type sequence of (pred, succ) equals a
  complete rule  → ``fuse`` (permanent).
* ``is_sub_rule``  — the concatenation is a contiguous *substring* of some
  rule (the paper binds the suffix ``[add, relu]`` of ``r3``)  → ``bind``
  (tentative; may later complete into a full rule, e.g. ``conv∘bn`` +
  ``add∘relu`` = ``r3``).
* ``is_valid_conn`` — only *direct* or *multi-inputs* connections may fuse
  (Fig. 6): the predecessor side must have exactly one external out-edge.
  This also guarantees the merge cannot create a cycle.
* ``unbind``      — groups still tagged ``bound`` at the end are dissolved.

Implementation note: the paper's recursive DFS is re-expressed as a
topological-order pass over a group partition.  Each group is a chain; we
greedily extend the group at its tail.  This is iterative (no recursion limit
on 50k-node graphs) and reproduces the paper's Fig. 7 walk-through exactly
(see tests/test_fusion.py::test_paper_fig7_example).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .graph import OpGraph, OpNode

# --------------------------------------------------------------------------
# Rule sets
# --------------------------------------------------------------------------

# Paper Table I (Eigen GPU-kernel rules) — used for conv-style graphs (Swin).
EIGEN_RULES: List[Tuple[str, ...]] = [
    ("conv", "bn"),
    ("conv", "bn", "relu"),
    ("conv", "bn", "add", "relu"),
]

# XLA-fusion-shaped rules for transformer graphs (hardware adaptation: on TPU
# the backend is XLA, which fuses matmul prologues/epilogues and elementwise
# chains; these mirror what XLA's fusion pass actually merges).
XLA_RULES: List[Tuple[str, ...]] = [
    ("matmul", "bias_add"),
    ("matmul", "bias_add", "relu"),
    ("matmul", "bias_add", "gelu"),
    ("matmul", "bias_add", "add"),
    ("matmul", "gelu"),
    ("matmul", "silu"),
    ("matmul", "relu"),
    ("matmul", "add"),
    ("scale", "mask", "softmax"),
    ("mask", "softmax"),
    ("add", "layernorm"),
    ("add", "rmsnorm"),
    ("mul", "add"),
    ("rmsnorm", "matmul"),
    ("layernorm", "matmul"),
    ("gelu", "mul"),      # GeGLU gate
    ("silu", "mul"),      # SwiGLU gate
    ("silu", "mul", "matmul"),
    ("gelu", "mul", "matmul"),
]

DEFAULT_RULES: List[Tuple[str, ...]] = EIGEN_RULES + XLA_RULES

FUSE_SEP = "∘"


class RuleIndex:
    """Pre-indexed rule set: O(1) complete-rule check, substring check."""

    def __init__(self, rules: Iterable[Sequence[str]]):
        self.rules = [tuple(r) for r in rules]
        self.complete: Set[Tuple[str, ...]] = set(self.rules)
        # every contiguous substring of every rule (for is_sub_rule / bind)
        self.substrings: Set[Tuple[str, ...]] = set()
        for r in self.rules:
            n = len(r)
            for i in range(n):
                for j in range(i + 1, n + 1):
                    self.substrings.add(r[i:j])

    def is_rule(self, seq: Tuple[str, ...]) -> bool:
        return seq in self.complete

    def is_sub_rule(self, seq: Tuple[str, ...]) -> bool:
        return seq in self.substrings and seq not in self.complete


# --------------------------------------------------------------------------
# Group partition
# --------------------------------------------------------------------------


@dataclass
class _Group:
    members: List[int]                 # original node ids, in chain order
    seq: Tuple[str, ...]               # concatenated primitive type sequence
    tag: str                           # "fused" | "bound" | "" (singleton)

    @property
    def head(self) -> int:
        return self.members[0]

    @property
    def tail(self) -> int:
        return self.members[-1]


def _primitive_seq(node: OpNode) -> Tuple[str, ...]:
    # a node may itself be pre-fused (type "a∘b"); split it
    return tuple(node.op_type.split(FUSE_SEP))


def gcof(
    graph: OpGraph,
    rules: Optional[Iterable[Sequence[str]]] = None,
    *,
    colocate: Optional[Dict[int, int]] = None,
    keep_bound: bool = False,
) -> OpGraph:
    """Coarsen ``graph`` by operator fusion (Algorithm 1).  Returns a new graph.

    ``colocate`` (optional) restricts merges to nodes mapped to the same value
    — used by :func:`runtime_fuse` to model the backend fusing only chains that
    a placement co-located on one device.

    ``keep_bound=False`` applies ``unbind()``: tentative groups that never
    completed a rule are dissolved back into their member operators.
    """
    idx = RuleIndex(rules if rules is not None else DEFAULT_RULES)

    groups: Dict[int, _Group] = {}
    owner: Dict[int, int] = {}
    for nid, node in graph.nodes.items():
        groups[nid] = _Group(members=[nid], seq=_primitive_seq(node), tag="")
        owner[nid] = nid

    def ext_out_edges(g: _Group) -> int:
        """Number of external out-edges of group ``g`` (multi-output check)."""
        gid = owner[g.head]
        cnt = 0
        for m in g.members:
            for s in graph.nodes[m].outputs:
                if owner[s] != gid:
                    cnt += 1
        return cnt

    def ext_out_groups(g: _Group) -> List[int]:
        gid = owner[g.head]
        seen: Set[int] = set()
        out: List[int] = []
        for m in g.members:
            for s in graph.nodes[m].outputs:
                og = owner[s]
                if og != gid and og not in seen:
                    seen.add(og)
                    out.append(og)
        return out

    # Process in topological order; greedily extend the group ending at each
    # node (equivalent to the paper's DFS with fuse/bind from the root).
    for start in graph.topo_order():
        nid = start
        gid = owner[nid]
        while True:
            g = groups[gid]
            if nid != g.tail:
                break  # only extend from the tail of a group
            # is_valid_conn: exactly one external out-edge (direct or
            # multi-inputs connection; a multi-output connection like Fig. 7's
            # first add→relu pair is invalid)
            if ext_out_edges(g) != 1:
                break
            sgs = ext_out_groups(g)
            assert len(sgs) == 1
            sg = groups[sgs[0]]
            # the edge must run tail(g) -> head(sg) so the merged group stays
            # a chain in rule order
            if not any(s == sg.head for s in graph.nodes[g.tail].outputs):
                break
            if colocate is not None and colocate[g.tail] != colocate[sg.head]:
                break  # runtime fusion cannot cross devices
            cat = g.seq + sg.seq
            if idx.is_rule(cat):
                tag = "fused"
            elif idx.is_sub_rule(cat):
                tag = "bound"
            else:
                break
            merged = _Group(members=g.members + sg.members, seq=cat, tag=tag)
            groups[gid] = merged
            for m in sg.members:
                owner[m] = gid
            del groups[sgs[0]]
            nid = merged.tail  # keep extending from the new tail

    # unbind(): dissolve groups that are still only "bound"
    if not keep_bound:
        for gid in list(groups.keys()):
            g = groups[gid]
            if g.tag == "bound":
                del groups[gid]
                for m in g.members:
                    groups[m] = _Group(
                        members=[m], seq=_primitive_seq(graph.nodes[m]), tag=""
                    )
                    owner[m] = m

    return _materialize(graph, groups, owner)


def _materialize(
    graph: OpGraph, groups: Dict[int, _Group], owner: Dict[int, int]
) -> OpGraph:
    """Build the coarsened OpGraph from the final group partition."""
    out = OpGraph(name=graph.name + "+coarse")
    for gid, g in groups.items():
        members = [graph.nodes[m] for m in g.members]
        flops = sum(m.flops for m in members)
        params = sum(m.param_bytes for m in members)
        kv = sum(m.kv_bytes for m in members)
        bytes_acc = sum(m.bytes_accessed for m in members)
        # fused-node cost model: drop the internal intermediate write+read —
        # the fusion speedup the paper's coarsening preserves
        internal_payload = sum(m.output_bytes for m in members[:-1])
        bytes_acc = max(bytes_acc - 2.0 * internal_payload, 0.0)
        tail = members[-1]
        node = OpNode(
            id=gid,
            op_type=FUSE_SEP.join(g.seq),
            flops=flops,
            bytes_accessed=bytes_acc,
            param_bytes=params,
            kv_bytes=kv,
            # every non-tail member's single out-edge is internal, so all
            # external out-edges carry the tail's payload
            output_bytes=tail.output_bytes,
            tag="fused" if len(members) > 1 else "",
            fused_ids=tuple(m.id for m in members),
            meta=dict(members[0].meta),
        )
        out.add_existing(node)
    # edges between groups (dedup parallel edges)
    for u, v in graph.edges():
        gu, gv = owner[u], owner[v]
        if gu == gv:
            continue
        if gv not in out.nodes[gu].outputs:
            out.nodes[gu].outputs.append(gv)
            out.nodes[gv].inputs.append(gu)
    out.validate()
    return out


# --------------------------------------------------------------------------
# Runtime fusion (used by the simulator): a placement computed on the ORIGINAL
# graph still gets backend fusion for chains it happened to co-locate; chains
# split across devices lose the fusion.  This models the paper's
# original-vs-coarsened end-to-end comparison (Fig. 10 a/b vs c/d).
# --------------------------------------------------------------------------


def runtime_fuse(
    graph: OpGraph,
    placement: Dict[int, int],
    rules: Optional[Iterable[Sequence[str]]] = None,
) -> Tuple[OpGraph, Dict[int, int]]:
    """Fuse co-located rule chains; returns (effective graph, effective placement)."""
    coarse = gcof(graph, rules, colocate=placement)
    eff_placement = {
        nid: placement[node.fused_ids[0] if node.fused_ids else nid]
        for nid, node in coarse.nodes.items()
    }
    return coarse, eff_placement
