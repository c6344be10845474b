"""End-to-end serving driver: Moirai placement → stage executor → continuous
batching engine, with an elastic device-failure recovery at the end.

    PYTHONPATH=src python -m repro_torch.examples.serve_demo
    PYTHONPATH=src python -m repro_torch.examples.serve_demo --device cpu

llama3.2-1b at smoke size (fp32), as the serve CLI builds it: per-layer
params and ``attention_impl="pallas"``, so on the card the flash and RMSNorm
kernels serve it; on the CPU their plain versions do.  The modeled cluster
has one H100 a visible card, every odd one at half speed.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.devices import h100_cluster
from repro_torch.examples import add_device_flag, devices_for
from repro_torch.launch.serve import serving_config
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServingEngine


def demo_requests() -> list:
    return [
        Request(rid=i, prompt=[1 + i, 2, 3, 4], max_new_tokens=8)
        for i in range(8)
    ]


def demo(cfg, params, cluster, devices, requests) -> dict:
    """Serve ``requests`` through an engine planned on ``cluster`` (its
    modeled devices mapped onto ``devices``), then, when the cluster has
    more than one device, fail device 0 and serve request 99 after the
    replan.  Returns the engine and request 99 (None without a failure)."""
    # slots > 1 → the engine plans for steady-state THROUGHPUT by default
    # (bottleneck-stage time), not single-query makespan
    engine = ServingEngine(cfg, params, cluster, devices=devices, slots=4, max_len=128,
                           eos_id=-1)
    print(f"placement via {engine.placement_result.method} "
          f"(objective={engine.plan_cfg.objective}); "
          f"{len(engine.executor.stages)} stage(s) on {len(engine.devices)} device(s)")

    for r in requests:
        engine.submit(r)
    engine.run_until_drained()
    for r in requests[:4]:
        print(f"req {r.rid}: prompt={r.prompt} -> {r.out_tokens}")

    print("stage latency stats:", engine.straggler_report()["stages"])

    after = None
    # the reference tests its device list, as long as its cluster there;
    # here several modeled devices may share one card
    if engine.cluster.k > 1:
        print("\nsimulating failure of device 0 …")
        engine.on_device_failure(0)
        after = Request(rid=99, prompt=[1, 2, 3, 4], max_new_tokens=8)
        engine.submit(after)
        engine.run_until_drained()
        print(f"after replan ({len(engine.devices)} devices): req 99 -> {after.out_tokens}")
    return {"engine": engine, "after_failure": after}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_flag(ap)
    args = ap.parse_args(argv)
    devices = devices_for(args.device)
    cfg = serving_config("llama3.2-1b", smoke=True)   # reduced size: CPU-runnable
    gen = torch.Generator(device=devices[0]).manual_seed(0)
    params = build_model(cfg).init(gen, devices[0])
    # a heterogeneous cluster of H100s (fast/slow alternating)
    cluster = h100_cluster(max(len(devices), 1), heterogeneous=True)
    requests = demo_requests()
    return dict(demo(cfg, params, cluster, devices, requests), requests=requests)


if __name__ == "__main__":
    main()
