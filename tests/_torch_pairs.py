"""Both packages under one set of names, for the router and chaos parity
tests (``test_torch_router.py``, ``test_torch_faults.py``).

A scenario is written once against a :class:`Pkg` and run twice: through
the JAX reference and through the port, with the reference's smoke llama
weights carried over by ``params_from_jax`` and clusters built from the same
``DeviceSpec``s in each package.  Each run returns what it observed (tokens,
terminal states, counters, events, statuses), and the test holds the two
observations equal.
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import torch

import repro.configs as j_configs
import repro.core.costmodel as j_cost
import repro.core.devices as j_dev
import repro.core.modelgraph as j_graph
import repro.core.placement as j_place
import repro.serving.adaptation as j_adapt
import repro.serving.engine as j_eng
import repro.serving.faults as j_faults
import repro.serving.router as j_router
import repro_torch.configs as t_configs
import repro_torch.core.costmodel as t_cost
import repro_torch.core.devices as t_dev
import repro_torch.core.modelgraph as t_graph
import repro_torch.core.placement as t_place
import repro_torch.serving.adaptation as t_adapt
import repro_torch.serving.engine as t_eng
import repro_torch.serving.faults as t_faults
import repro_torch.serving.router as t_router
from repro.models.model import build_model
from repro_torch.convert import params_from_jax

CPU = [torch.device("cpu")]
_NAMES = {
    "engine": ("Request", "ServingEngine"),
    "router": ("Replica", "Router", "RouterConfig"),
    "faults": ("FAULT_KINDS", "FaultEvent", "FaultInjector", "FaultSchedule"),
    "place": ("PlanConfig", "plan", "plan_replicas", "replan"),
    "dev": ("ClusterSpec", "DeviceSpec"),
    "cost": ("DerateCalibrator",),
    "adapt": ("AdaptationConfig", "DeratePolicy"),
    "graph": ("transformer_graph",),
    "configs": ("get_config",),
}


class Pkg(SimpleNamespace):
    """One package's router, faults, engine and planner, its copy of the
    smoke weights, and how it builds a cluster and an engine."""

    def cluster(self, n_slices, heterogeneous=False, mem_bytes=None):
        """``tpu_slice_cluster(n_slices)``'s devices and links, built in this
        package (the port has no TPU presets); ``mem_bytes`` maps a device
        index to the memory it holds instead."""
        ref = j_dev.tpu_slice_cluster(n_slices=n_slices, heterogeneous=heterogeneous)
        mem = mem_bytes or {}
        return self.ClusterSpec(
            [self.DeviceSpec(**{**dataclasses.asdict(d), "mem_bytes": mem.get(i, d.mem_bytes)})
             for i, d in enumerate(ref.devices)],
            ref.link_bw.copy(), ref.link_latency.copy(), name=ref.name,
        )

    def engine(self, cluster, **kw):
        """The reference tests' engine: 64-token rows, ETF plans, no EOS."""
        kw.setdefault("max_len", 64)
        kw.setdefault("plan_cfg", self.PlanConfig(method="etf"))
        kw.setdefault("eos_id", -1)
        return self.ServingEngine(self.cfg, self.params, cluster, **self.engine_kw, **kw)


def _pkg(name, mods, cfg, params, engine_kw):
    attrs = {a: getattr(mods[m], a) for m, names in _NAMES.items() for a in names}
    return Pkg(name=name, cfg=cfg, params=params, engine_kw=engine_kw, **attrs)


def packages():
    """``(reference, port)``: both with the reference's smoke llama3.2-1b
    weights; the port's engines on the CPU, through the kernels' plain
    versions (``attention_impl="pallas"``)."""
    jcfg = j_configs.get_config("llama3.2-1b").smoke()
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(t_configs.get_config("llama3.2-1b").smoke(),
                               attention_impl="pallas")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    j_mods = dict(engine=j_eng, router=j_router, faults=j_faults, place=j_place, dev=j_dev,
                  cost=j_cost, adapt=j_adapt, graph=j_graph, configs=j_configs)
    t_mods = dict(engine=t_eng, router=t_router, faults=t_faults, place=t_place, dev=t_dev,
                  cost=t_cost, adapt=t_adapt, graph=t_graph, configs=t_configs)
    return (_pkg("reference", j_mods, jcfg, jp, {}),
            _pkg("port", t_mods, tcfg, tp, {"devices": CPU}))


def router_view(router) -> dict:
    """What a router run leaves for an operator: its event log, counters,
    terminal states, replicas and device pool."""
    st = router.stats()
    return {
        "events": list(router.events),
        "counters": st["counters"],
        "finished_by_state": st["finished_by_state"],
        "replicas": [(r["name"], r["state"], r["health"], r["in_flight"])
                     for r in st["replicas"]],
        "queued": st["queued"],
        "device_pool": list(router.device_pool),
        "pool_derate": dict(router.pool_derate),
        "slo_ok": st["slo_ok"],
    }


def requests_view(reqs) -> list:
    return [(r.rid, r.state, r.done, r.rejected, r.retries, list(r.out_tokens))
            for r in reqs]


def run_both(scenario, pair):
    """``scenario(pkg)`` through both packages; asserts they observed the
    same, and returns the port's observation."""
    ref, port = pair
    want = scenario(ref)
    got = scenario(port)
    assert got == want
    return got
