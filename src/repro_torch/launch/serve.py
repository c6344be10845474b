"""Serving launcher CLI of the port: Moirai placement → stage executor →
batch engine, on the H100 (or the CPU with ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --kv-page-tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --draft llama3.2-1b --spec-tokens 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --replicas 2 --cluster-size 2 --fault-schedule chaos.json

It takes the reference's flags: paged KV's (``--kv-page-tokens``,
``--no-prefix-sharing``, ``--kv-residency``), speculation's (``--draft``,
``--spec-tokens``, ``--acceptance-rate``: the draft's random weights from
``--seed`` + 1, and ``[spec]`` lines with the observed acceptance after the
run), the multi-replica service's (``--replicas auto|N``, ``--slo-p99``,
``--dispatch``) and the chaos harness's (``--fault-schedule``).  Serving
runs at full width unless ``--smoke``, with per-layer params (``scan_layers=False``,
the layout the engine serves from — the reference CLI keeps the config's
``scan_layers=True`` there and its executor refuses it), random weights
from ``--seed``, and ``attention_impl="pallas"``: attention and every
RMSNorm go through the port's CUDA kernels.  The modeled cluster is
``h100_cluster(k, heterogeneous=True)`` with ``k = --cluster-size`` or the
number of visible cards: every odd card at half the peak FLOPs and HBM
bandwidth, as the reference's ``tpu_slice_cluster(k, heterogeneous=True)``.
``--heterogeneous`` is on by default and no flag turns it off, a quirk kept
from the reference (``store_true`` with ``default=True``).  The engine runs with the adaptive observe → derate → replan loop
closed; after the run the CLI prints the straggler report, every adaptation
decision and every committed replan.

``--replicas auto|N`` switches to the multi-replica service: the replica
planner (:func:`repro_torch.core.replica.plan_replicas`) picks the replica
count and each replica's devices, and the SLO-aware router
(:class:`repro_torch.serving.router.Router`) dispatches the requests,
spread over its tiers, across one engine a replica.  Modeled devices map
onto the visible cards modulo their count: on one card every replica shares
the device, the weights and the current stream, and the router steps them
one after another.  The CLI then prints the service plan, the per-tier
latencies, the router's counters, terminal states and event log.

``--fault-schedule PATH`` replays a chaos scenario
(:class:`repro_torch.serving.faults.FaultSchedule` JSON, written by
``FaultSchedule([...]).save(path)`` or ``FaultSchedule.random(...)``) into
the single engine, or routed across the replicas, and prints the
injections after the run.  A ``device_crash`` is a modeled fault: the
engine re-plans on the survivors and rebuilds its stages; nothing on the
card fails.
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
from repro_torch.serving.stage_executor import check_servable


def serving_config(arch: str, smoke: bool):
    """``arch``'s config as the CLI serves it: per-layer params and the
    kernels (``attention_impl="pallas"``), at smoke size with ``smoke``."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    return dataclasses.replace(
        cfg, scan_layers=False, remat=False, attention_impl="pallas"
    )


def serving_setup(args):
    """What every serving path of the CLI shares, from parsed arguments:
    the config, the torch devices, the random weights, the modeled cluster
    and the plan config."""
    cfg = serving_config(args.arch, args.smoke)
    try:
        check_servable(cfg)
    except NotImplementedError as e:
        # a family served at the model level only: say so, not a traceback
        raise SystemExit(f"[serve] {e}") from None
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
        spec_tokens=args.spec_tokens if args.draft else 0,
        acceptance_rate=args.acceptance_rate,
    )
    return cfg, devices, params, cluster, plan_cfg


def build_engine(args) -> ServingEngine:
    """The engine the CLI serves with, from parsed arguments."""
    cfg, devices, params, cluster, plan_cfg = serving_setup(args)
    draft_kw = {}
    if args.draft:
        draft_cfg = serving_config(args.draft, args.smoke)
        dgen = torch.Generator(device=devices[0]).manual_seed(args.seed + 1)
        draft_kw = dict(
            draft_cfg=draft_cfg,
            draft_params=build_model(draft_cfg).init(dgen, devices[0]),
        )
    return ServingEngine(
        cfg, params, cluster,
        devices=devices,
        slots=args.slots, max_len=args.max_len,
        plan_cfg=plan_cfg,
        eos_id=-1,
        **draft_kw,
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


def cli_requests(args) -> list:
    """The CLI's traffic: ``--requests`` short prompts."""
    return [
        Request(rid=i, prompt=[1 + i % 7, 2, 3, 4], max_new_tokens=args.max_new_tokens)
        for i in range(args.requests)
    ]


def attach_schedule(target, path: str):
    """Replay the chaos scenario at ``path`` into ``target`` (an engine or
    the router); returns the injector."""
    from repro_torch.serving.faults import FaultInjector, FaultSchedule

    schedule = FaultSchedule.load(path)
    injector = FaultInjector(schedule)
    target.attach_fault_injector(injector)
    print(
        f"[serve] chaos: replaying '{schedule.name}' "
        f"({len(schedule)} events, horizon {schedule.horizon} steps)"
    )
    return injector


def print_injections(injector) -> None:
    print(f"[chaos] {len(injector.log)} injections")
    for entry in injector.log:
        e = entry["event"]
        tgt = e["device"] if e["device"] is not None else tuple(e["link"])
        print(
            f"[chaos]   s{entry['clock']:<4d} {e['kind']:<14s} "
            f"target={tgt} -> {entry['status']}"
        )


def serve_replicas(args):
    """The --replicas path: plan the service, run the router, print the
    operator view (service plan, event log, per-tier latencies).  Returns
    the router and the requests; exits non-zero when a request is left
    without a terminal state."""
    from repro_torch.core.modelgraph import transformer_graph
    from repro_torch.core.replica import plan_replicas
    from repro_torch.serving.router import Router, RouterConfig

    cfg, devices, params, cluster, plan_cfg = serving_setup(args)
    # the replica planner must score the SAME graph the engines execute
    graph = transformer_graph(cfg, seq_len=args.max_len, granularity="block")
    plan_cfg = dataclasses.replace(
        plan_cfg,
        replicas="auto" if args.replicas == "auto" else int(args.replicas),
        slo_p99=args.slo_p99,
    )
    t0 = time.perf_counter()
    svc = plan_replicas(graph, cluster, plan_cfg)
    t_plan = time.perf_counter() - t0
    print(
        f"[serve] service plan ({t_plan:.1f}s): {svc.n_replicas} replica(s) "
        f"on {cluster.name}, total {svc.total_rps:.1f} req/s steady, "
        f"p99 {svc.p99_s*1e3:.1f} ms @ {svc.extra['offered_rps']:.1f} req/s "
        f"offered, slo_ok={svc.slo_ok}"
    )
    for i, spec in enumerate(svc.replicas):
        print(
            f"[serve]   replica{i}: devices={spec.devices} "
            f"bneck={spec.bottleneck_s*1e3:.2f} ms "
            f"({spec.throughput_rps:.1f} req/s)"
        )
    router = Router.from_service_plan(
        cfg, params, cluster, svc,
        slots=args.slots, max_len=args.max_len, plan_cfg=plan_cfg,
        config=RouterConfig(dispatch=args.dispatch),
        devices=devices,
        eos_id=-1,
        admission=args.admission, batching=args.batching,
        oversize=args.oversize,
    )
    injector = (
        attach_schedule(router, args.fault_schedule) if args.fault_schedule else None
    )
    t0 = time.perf_counter()
    reqs = cli_requests(args)
    n_tiers = router.config.tiers
    for i, r in enumerate(reqs):
        router.submit(r, tier=i % n_tiers)   # spread load over the tiers
    router.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    print(f"[serve] {toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s) "
          f"across {sum(r.state != 'retired' for r in router.replicas)} "
          f"live replica(s) ({devices[0]})")
    for t, row in router.latency_report().items():
        print(
            f"[serve]   tier {t}: {int(row['count'])} done, "
            f"mean {row['mean_steps']:.1f} / max {int(row['max_steps'])} "
            "router steps"
        )
    stats = router.stats()
    print(f"[router] counters: {stats['counters']} slo_ok={stats['slo_ok']}")
    print(f"[router] terminal states: {stats['finished_by_state']}")
    print(f"[router] {len(router.events)} events")
    for ev in router.events:
        detail = " ".join(
            f"{k_}={v_}" for k_, v_ in ev.items()
            if k_ not in ("step", "kind")
        )
        print(f"[router]   s{ev['step']:<4d} {ev['kind']:<14s} {detail}")
    if injector is not None:
        print_injections(injector)
    stranded = [r.rid for r in reqs if not r.done]
    if stranded:
        # no live replica is left to serve them (a drained device never
        # rejoins the pool): the run did not serve its traffic
        raise SystemExit(
            f"[serve] {len(stranded)} of {len(reqs)} requests reached no "
            f"terminal state (rids {stranded}); live replicas: "
            f"{[r.name for r in router.replicas if r.state != 'retired']}"
        )
    return router, reqs


def parser() -> argparse.ArgumentParser:
    """The CLI's flags (the reference's, and ``--device`` and ``--seed``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--method", default="moirai")
    ap.add_argument(
        "--heterogeneous", action="store_true", default=True,
        help="model every odd card of the cluster at half speed (always on: "
        "the reference declares it store_true with default True, so no flag "
        "turns it off there either)",
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
        help="serve speculatively: this (smaller) arch drafts --spec-tokens "
        "greedy tokens per ready slot between target steps and ONE fused "
        "target forward verifies them (variable per-slot advance, token-"
        "identical to plain greedy); draft + target are placed JOINTLY over "
        "the merged pass-rate graph (shared Eq. 5 memory, per-device busy "
        "summed across both models).  Dense/moe draft archs only (the stage "
        "executor serves attention-family blocks); random weights from "
        "--seed + 1",
    )
    ap.add_argument(
        "--spec-tokens", type=int, default=4, metavar="K",
        help="draft tokens proposed per speculative round (with --draft)",
    )
    ap.add_argument(
        "--acceptance-rate", type=float, default=0.75, metavar="A",
        help="the acceptance rate the joint planner assumes when scoring "
        "draft/target placements (expected tokens per round "
        "E = (1-a^(k+1))/(1-a)); compare against the observed per-class "
        "rates in the post-run speculation report",
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
        help="replay this chaos scenario (FaultSchedule JSON) into the run: "
        "scheduled device crashes/stalls and link degradations fire at their "
        "scripted engine/router steps (see repro_torch.serving.faults)",
    )
    ap.add_argument(
        "--replicas", default="1", metavar="auto|N",
        help="serve N model replicas behind the SLO-aware router, or 'auto' "
        "to let the replica planner pick the count that maximizes total "
        "steady req/s under --slo-p99 (default 1 = single engine, no router)",
    )
    ap.add_argument(
        "--slo-p99", type=float, default=None, metavar="SECONDS",
        help="p99 request-latency SLO the replica planner's simulation must "
        "meet (only with --replicas; no SLO = pure throughput maximization)",
    )
    ap.add_argument(
        "--dispatch", choices=("least_loaded", "shortest_prefill"),
        default="least_loaded",
        help="router dispatch policy across replicas (only with --replicas)",
    )
    ap.add_argument(
        "--cluster-size", type=int, default=None, metavar="K",
        help="devices in the modeled cluster (default: number of visible "
        "accelerators; raise it to plan multi-replica services on clusters "
        "bigger than this host)",
    )
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.replicas != "1":
        if args.draft:
            ap.error("--draft is the single-engine path (not with --replicas)")
        return serve_replicas(args)

    engine = build_engine(args)
    injector = (
        attach_schedule(engine, args.fault_schedule) if args.fault_schedule else None
    )
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
        + (
            f" spec=draft:{args.draft},k={engine.spec_tokens}"
            if args.draft else ""
        )
    )
    t0 = time.perf_counter()
    reqs = cli_requests(args)
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
    if args.draft:
        spec = engine.speculation_report()
        print(
            f"[spec] k={spec['spec_tokens']} planned a="
            f"{spec['planned_acceptance_rate']:.2f} "
            f"(E={spec['planned_tokens_per_round']:.2f} tok/round)"
        )
        for cls, row in spec["classes"].items():
            print(
                f"[spec]   {cls}: {row['rounds']} rounds, observed a="
                f"{row['acceptance_rate']:.2f}, "
                f"{row['tokens_per_round']:.2f} tok/round"
            )

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
    if injector is not None:
        print_injections(injector)
    return engine, reqs


if __name__ == "__main__":
    main()
