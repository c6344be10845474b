"""Placeto-style reinforcement-learning placement baseline.

The paper compares against Placeto [Addanki et al., NeurIPS'19], an RL agent
that traverses the graph node-by-node and emits a device for each node,
rewarded by the measured step-time improvement.  The original needs
GPU-cluster-hours; here it serves as the *weakest* baseline (the paper beats
it 3–4×), so we implement a compact, faithful-in-interface REINFORCE agent:

* per-node features: normalized flops / resident bytes / output bytes /
  topo depth / fan-in / fan-out  (Placeto's graph embedding, simplified),
* a linear-softmax policy over devices (a torch tensor on ``device``,
  trained with ``torch.autograd``; samples drawn with ``torch.multinomial``
  from a ``torch.Generator`` seeded by ``seed``),
* reward = −simulated cost of the episode's placement under the CONFIGURED
  planning objective — makespan for ``objective="latency"``, bottleneck-stage
  time for ``objective="throughput"`` (the simulator replaces the paper's
  real-cluster measurement) — with a moving-average baseline.  Threading the
  objective keeps baseline comparisons against the throughput MILP
  apples-to-apples instead of silently rewarding the wrong quantity,
* trained for a bounded budget (`iters`), then greedy-decoded.

The policy lives on ``device``: the first card unless the caller names
another (``device="cpu"``).  Only its sampled choices come back to the host,
where the simulator scores them.
"""

from __future__ import annotations

import time as _time
from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from .costmodel import CostModel
from .graph import OpGraph
from .milp import PlacementResult
from .simulate import bottleneck_time, simulate


def _features(graph: OpGraph) -> np.ndarray:
    order = graph.topo_order()
    depth: Dict[int, int] = {}
    for nid in order:
        node = graph.nodes[nid]
        depth[nid] = 1 + max((depth[p] for p in node.inputs), default=0)
    max_depth = max(depth.values()) if depth else 1

    def norm(x, lo, hi):
        return (np.log1p(x) - lo) / max(hi - lo, 1e-9)

    fl = np.log1p([graph.nodes[n].flops for n in order])
    pb = np.log1p([graph.nodes[n].param_bytes for n in order])
    ob = np.log1p([graph.nodes[n].output_bytes for n in order])
    feats = np.stack(
        [
            (fl - fl.min()) / max(np.ptp(fl), 1e-9),
            (pb - pb.min()) / max(np.ptp(pb), 1e-9),
            (ob - ob.min()) / max(np.ptp(ob), 1e-9),
            np.array([depth[n] / max_depth for n in order]),
            np.array([len(graph.nodes[n].inputs) for n in order]) / 8.0,
            np.array([len(graph.nodes[n].outputs) for n in order]) / 8.0,
            np.ones(len(order)),
        ],
        axis=1,
    )
    return feats.astype(np.float32)


def _sample(logits: torch.Tensor, generator: torch.Generator) -> np.ndarray:
    """One device per node, drawn from ``softmax(logits)`` ``[n, K]``."""
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].cpu().numpy()


def grad_step(
    w: torch.Tensor, feats: torch.Tensor, advantages: torch.Tensor, choices: torch.Tensor,
    lr: float,
) -> torch.Tensor:
    """One REINFORCE step on the linear-softmax policy: ``w − lr·∇`` of
    ``−mean_b(adv_b · Σ_i log π(choice_bi | node i))``.  ``choices`` is
    ``[batch, n]``, ``advantages`` ``[batch]``."""
    w = w.detach().requires_grad_(True)
    logp = torch.log_softmax(feats @ w, dim=-1)                  # [n, K]
    n = feats.shape[0]
    lp = logp[torch.arange(n, device=w.device)[None, :], choices.long()]  # [batch, n]
    loss = -(advantages * lp.sum(-1)).mean()
    (g,) = torch.autograd.grad(loss, w)
    return (w - lr * g).detach()


def placeto(
    graph: OpGraph,
    cost: CostModel,
    *,
    iters: int = 150,
    batch: int = 8,
    lr: float = 0.05,
    seed: int = 0,
    objective: str = "latency",
    serving_slots: int = 1,
    device=None,
) -> PlacementResult:
    if objective not in ("latency", "throughput"):
        raise ValueError(f"unknown objective {objective!r}")
    t0 = _time.perf_counter()
    device = resolve_device(device)
    order = graph.topo_order()
    feats = torch.from_numpy(_features(graph)).to(device)      # [n, F]
    n, F = feats.shape
    K = cost.cluster.k

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    w = torch.zeros((F, K), dtype=torch.float32, device=device)

    def reward(choice: np.ndarray) -> float:
        placement = {nid: int(choice[i]) for i, nid in enumerate(order)}
        if objective == "throughput":
            score = bottleneck_time(graph, placement, cost)
        else:
            score = simulate(graph, placement, cost).makespan
        # memory violation penalty (Placeto's OOM negative reward), KV-aware
        if not cost.memory_ok(graph, placement, serving_slots=serving_slots):
            score *= 4.0
        return -score

    baseline = None
    best_choice, best_r = None, -np.inf
    for it in range(iters):
        choices, rewards = [], []
        for _ in range(batch):
            with torch.no_grad():
                ch = _sample(feats @ w, gen)
            r = reward(ch)
            choices.append(ch)
            rewards.append(r)
            if r > best_r:
                best_r, best_choice = r, ch.copy()
        rewards = np.asarray(rewards, dtype=np.float32)
        baseline = rewards.mean() if baseline is None else 0.9 * baseline + 0.1 * rewards.mean()
        adv = torch.from_numpy(np.asarray(rewards - baseline, dtype=np.float32)).to(device)
        w = grad_step(w, feats, adv, torch.from_numpy(np.stack(choices)).to(device), lr)

    placement = {nid: int(best_choice[i]) for i, nid in enumerate(order)}
    ok = cost.memory_ok(graph, placement, serving_slots=serving_slots)
    return PlacementResult(
        placement=placement,
        objective=-best_r,
        status="feasible" if ok else "memory-relaxed",
        mip_gap=float("nan"),
        solve_time=_time.perf_counter() - t0,
        method="placeto-rl",
        extra={"objective": objective, "serving_slots": serving_slots},
    )
