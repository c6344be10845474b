"""Serving launcher CLI of the port: Moirai placement → stage executor →
batch engine, on the H100 (or the CPU with ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --kv-page-tokens 64

It takes the reference's single-engine flags, paged KV's among them
(``--kv-page-tokens``, ``--no-prefix-sharing``, ``--kv-residency``); the
knobs of speculation (``--spec-tokens``, ``--acceptance-rate``) and the
router (``--slo-p99``, ``--dispatch``) come with their slices.  Serving runs at
full width unless ``--smoke``, with per-layer params (``scan_layers=False``,
the layout the engine serves from — the reference CLI keeps the config's
``scan_layers=True`` there and its executor refuses it), random weights
from ``--seed``, and ``attention_impl="pallas"``: attention and every
RMSNorm go through the port's CUDA kernels.  The modeled cluster is
``h100_cluster(k)`` with ``k = --cluster-size`` or the number of visible
cards.  The engine runs with the adaptive observe → derate → replan loop
closed; after the run the CLI prints the straggler report, every adaptation
decision and every committed replan.

Not ported yet: ``--replicas`` other than 1 (ROADMAP A8), ``--fault-schedule``
(A8) and ``--draft`` (A7) exit with an error naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.devices import h100_cluster
from repro_torch.core.placement import PlanConfig
from repro_torch.device import cuda_devices
from repro_torch.models.model import build_model
from repro_torch.serving.adaptation import AdaptationConfig
from repro_torch.serving.engine import Request, ServingEngine

_NOT_PORTED = {
    "replicas": "--replicas other than 1 is not yet ported (ROADMAP A8)",
    "fault_schedule": "--fault-schedule is not yet ported (ROADMAP A8)",
    "draft": "--draft is not yet ported (ROADMAP A7)",
}


def build_engine(args) -> ServingEngine:
    """The engine the CLI serves with, from parsed arguments."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg = dataclasses.replace(
        cfg, scan_layers=False, remat=False, attention_impl="pallas"
    )
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (use --device cpu)")
        devices = cuda_devices()
    else:
        devices = [torch.device("cpu")]
    gen = torch.Generator(device=devices[0]).manual_seed(args.seed)
    params = build_model(cfg).init(gen, devices[0])
    k = args.cluster_size or max(len(devices), 1)
    cluster = h100_cluster(k, heterogeneous=args.heterogeneous)
    plan_cfg = PlanConfig(
        method=args.method, time_limit=20, mip_rel_gap=0.05,
        # mirror the engine's own default: serving >1 slot is a
        # pipelined workload, scored by bottleneck-stage time — and
        # prefill-aware scoring (--prompt-len) only exists there
        objective="throughput" if args.slots > 1 else "latency",
        serving_slots=args.slots,
        prefill_chunk=args.prefill_chunk or None,
        prompt_len=args.prompt_len,
        fused_prefill=args.fused_prefill,
        kv_page_tokens=args.kv_page_tokens or None,
        prefix_sharing=args.prefix_sharing,
        kv_residency=args.kv_residency,
    )
    return ServingEngine(
        cfg, params, cluster,
        devices=devices,
        slots=args.slots, max_len=args.max_len,
        plan_cfg=plan_cfg,
        eos_id=-1,
        # short windows can't carry the default 4-sample evidence minimum —
        # scale it down so --adapt-every 1..3 still observes (and acts)
        adapt=AdaptationConfig(
            window_steps=args.adapt_every,
            min_samples=(
                min(4, args.adapt_every) if args.adapt_every > 0 else 4
            ),
            state_path=args.derate_state,
        ),
        admission=args.admission,
        batching=args.batching,
        oversize=args.oversize,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--method", default="moirai")
    ap.add_argument(
        "--heterogeneous", action="store_true",
        help="model every odd card of the cluster at half speed",
    )
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the model runs (cuda: every visible card, modeled "
        "devices mapped onto them modulo their count)",
    )
    ap.add_argument(
        "--seed", type=int, default=0,
        help="seed of the random weights",
    )
    ap.add_argument(
        "--adapt-every", type=int, default=16,
        help="decode steps per adaptation observation window (0 = off; "
        "short windows lower the per-window evidence requirement to match)",
    )
    ap.add_argument(
        "--admission", choices=("queue", "reject"), default="queue",
        help="KV-aware admission: hold requests in queue or reject them",
    )
    ap.add_argument(
        "--batching", choices=("ragged", "lockstep"), default="ragged",
        help="ragged = per-slot cache positions (continuous admission); "
        "lockstep = seed-engine equal-depth cohorts (benchmark baseline)",
    )
    ap.add_argument(
        "--prefill-chunk", type=int, default=64, metavar="TOKENS",
        help="interleave prompt prefill with decode in chunks of this many "
        "tokens (0 = blocking whole-prompt prefill at admission); also the "
        "chunk size the planner's prefill-aware throughput scoring assumes",
    )
    ap.add_argument(
        "--no-fused-prefill", dest="fused_prefill", action="store_false",
        help="serve prefill chunks as standalone batch-1 forwards between "
        "decode steps (the legacy interleaved path) instead of packing them "
        "into the decode batch's single fused forward per step; the planner "
        "scores prefill at the matching rate",
    )
    ap.add_argument(
        "--kv-page-tokens", type=int, default=0, metavar="TOKENS",
        help="serve the KV cache as fixed-size pages of this many tokens "
        "(block-paged attention): slots allocate pages on demand instead of "
        "dense max-len rows, and the planner's Eq. 5 memory term charges "
        "pages actually resident (0 = dense per-slot rows, the default)",
    )
    ap.add_argument(
        "--no-prefix-sharing", dest="prefix_sharing", action="store_false",
        help="disable hash-based prefix sharing across paged requests "
        "(shared prompt prefixes reuse read-only pages, skip their prefill "
        "chunks, and copy-on-write at first divergence); only meaningful "
        "with --kv-page-tokens",
    )
    ap.add_argument(
        "--kv-residency", type=float, default=1.0, metavar="FRACTION",
        help="expected fraction of max-len a sequence actually occupies — "
        "scales the planner's paged Eq. 5 memory term (1.0 = worst case; "
        "only meaningful with --kv-page-tokens)",
    )
    ap.add_argument(
        "--draft", default=None, metavar="ARCH",
        help="speculative serving with this draft arch: not yet ported (ROADMAP A7)",
    )
    ap.add_argument(
        "--prompt-len", type=int, default=0, metavar="TOKENS",
        help="expected prompt tokens per request: lets the throughput "
        "planner charge each request's chunked-prefill work when scoring "
        "placements (0 = decode-only scoring)",
    )
    ap.add_argument(
        "--oversize", choices=("truncate", "reject"), default="truncate",
        help="requests whose prompt+max_new_tokens overflow --max-len are "
        "truncated (oldest prompt tokens dropped, flagged) or rejected",
    )
    ap.add_argument(
        "--derate-state", default=None, metavar="PATH",
        help="persist the adaptive derate policy's state here; a restarted "
        "engine resumes its learned derates instead of re-observing",
    )
    ap.add_argument(
        "--fault-schedule", default=None, metavar="PATH",
        help="replay a chaos scenario (FaultSchedule JSON): not yet ported "
        "(ROADMAP A8)",
    )
    ap.add_argument(
        "--replicas", default="1", metavar="auto|N",
        help="serve N replicas behind the SLO-aware router: not yet ported "
        "(ROADMAP A8); only 1",
    )
    ap.add_argument(
        "--cluster-size", type=int, default=None, metavar="K",
        help="devices in the modeled cluster (default: number of visible "
        "accelerators; raise it to plan multi-replica services on clusters "
        "bigger than this host)",
    )
    args = ap.parse_args(argv)
    for name, msg in _NOT_PORTED.items():
        val = getattr(args, name)
        if val and val not in ("1", 0):
            ap.error(msg)

    engine = build_engine(args)
    print(
        f"[serve] {args.arch}: placement={engine.placement_result.method} "
        f"stages={len(engine.executor.stages)} devices={len(engine.devices)} "
        f"({engine.devices[0]}) cluster={engine.cluster.name} "
        f"adapt_every={args.adapt_every or 'off'} "
        "prefill_chunk="
        f"{engine.prefill_chunk if engine._chunked_prefill_on() else 'blocking'}"
        f" step={'fused' if engine._fused_on() else 'interleaved'}"
        + (
            f" kv=paged({engine.kv_page_tokens}"
            f"{',shared' if engine.prefix_sharing else ''})"
            if engine.kv_page_tokens else " kv=dense"
        )
    )
    t0 = time.perf_counter()
    reqs = [
        Request(rid=i, prompt=[1 + i % 7, 2, 3, 4], max_new_tokens=args.max_new_tokens)
        for i in range(args.requests)
    ]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    rejected = sum(r.rejected for r in reqs)
    print(f"[serve] {toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s)"
          + (f", {rejected} rejected by KV admission" if rejected else ""))
    if engine._kv_pool is not None:
        print(f"[serve] kv pool: {engine._kv_pool.stats()}")
    print(f"[serve] straggler report: {engine.straggler_report()['stragglers']}")

    # ---- surface the adaptation loop's decisions -------------------------
    print(
        f"[adapt] windows={engine.policy.windows} "
        f"derate={engine.derate or '{}'} "
        f"events={len(engine.adaptation_events)}"
    )
    for ev in engine.adaptation_events:
        # ev.device is an int (device), an (src, dst) tuple (channel), or
        # -1 (a cluster-wide replan decision)
        if isinstance(ev.device, tuple):
            dev = f"ch{ev.device[0]}-{ev.device[1]}"
        elif ev.device < 0:
            dev = "cluster"
        else:
            dev = f"dev{ev.device}"
        print(
            f"[adapt]   w{ev.window:<3d} {ev.action:<8s} {dev:<8s}"
            f" ratio={ev.ratio:6.2f} factor {ev.old_factor:.3f}→{ev.new_factor:.3f}"
            f"  {ev.reason}"
        )
    for h in engine.replan_history:
        print(
            f"[adapt] replan (w{h['window']}): {h['reason']} — "
            f"method={h['method']} stages={h['stages']} derate={h['derate']}"
            + (
                f" link_derate={h['link_derate']}"
                if h.get("link_derate") else ""
            )
        )
    return engine, reqs


if __name__ == "__main__":
    main()
