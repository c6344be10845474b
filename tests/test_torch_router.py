"""Port parity of the SLO-aware router (``serving/router.py``) and the engine
drain machinery it drives: every scenario of ``tests/test_router.py`` runs
through the reference and the port (same weights, same clusters), each run
held to the reference test's own assertions, and the two runs to each other
(tokens, terminal states, counters, the event log).  Then the port's
narrowed catches: an error that is not a typed loss propagates out of the
router, where the reference retires a replica for it."""

import pytest
import torch

from _torch_pairs import packages, requests_view, router_view, run_both


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return packages()


def _engine(P, cluster, **kw):
    kw.setdefault("slots", 2)
    return P.engine(cluster, **kw)


def _two_replica_router(P, **router_kw):
    """Two single-device replicas over a 2-device cluster, plus a factory
    that rebuilds an engine from pooled ORIGINAL device indices."""
    cluster = P.cluster(2)

    def factory(devs):
        return _engine(P, cluster.subcluster(devs))

    reps = [P.Replica(name=f"replica{i}", devices=[i], engine=factory([i])) for i in range(2)]
    return P.Router(reps, engine_factory=factory, **router_kw), cluster


# ---------------------------------------------------------------------------
# engine drain unit
# ---------------------------------------------------------------------------


def test_engine_drain_hands_back_unstarted_work(pair):
    def scenario(P):
        eng = _engine(P, P.cluster(1), slots=1)
        first = P.Request(rid=0, prompt=[1, 2], max_new_tokens=3)
        second = P.Request(rid=1, prompt=[3, 4], max_new_tokens=3)
        eng.submit(first)
        eng.submit(second)
        eng.step()
        assert first.started and not second.started
        handed = eng.begin_drain()
        assert handed == [second]
        with pytest.raises(RuntimeError, match="draining"):
            eng.submit(P.Request(rid=2, prompt=[5], max_new_tokens=1))
        out = eng.drain()
        assert out["drained"] and out["handed_back"] == []
        assert first in out["finished"] and len(first.out_tokens) == 3
        assert out["freed_devices"] == [0]
        assert not second.done
        return requests_view([first, second]), [r.rid for r in out["finished"]]

    run_both(scenario, pair)


def test_engine_hot_swap_while_draining_still_finishes(pair):
    def scenario(P):
        eng = _engine(P, P.cluster(1), slots=1)
        a = P.Request(rid=0, prompt=[1, 2], max_new_tokens=4)
        eng.submit(a)
        eng.step()
        assert a.started
        eng.begin_drain()
        eng._replan_and_rebuild("test hot-swap during drain")
        assert eng.queue == [a]
        out = eng.drain()
        assert a in out["finished"] and len(a.out_tokens) == 4
        return requests_view([a]), [h["reason"] for h in eng.replan_history]

    run_both(scenario, pair)


def test_engine_health_reflects_derate_and_failure(pair):
    def scenario(P):
        eng = _engine(P, P.cluster(2))
        seen = [eng.health()]
        eng.derate = {0: 0.5}
        seen.append(eng.health())
        eng.failed_devices.append(1)
        seen.append(eng.health())
        assert seen == pytest.approx([1.0, 0.75, 0.25])
        return seen

    run_both(scenario, pair)


# ---------------------------------------------------------------------------
# router dispatch
# ---------------------------------------------------------------------------


def test_priority_tiers_dispatch_in_order_under_contention(pair):
    def scenario(P):
        rep = P.Replica(name="replica0", devices=[0], engine=_engine(P, P.cluster(1), slots=1))
        router = P.Router([rep], config=P.RouterConfig(tiers=3, backlog=0))
        reqs = []
        for tier, rid in ((2, 0), (1, 1), (0, 2)):
            reqs.append(P.Request(rid=rid, prompt=[1 + rid], max_new_tokens=2))
            router.submit(reqs[-1], tier=tier)
        done = router.run_until_drained()
        assert len(done) == 3
        assert [e["rid"] for e in router.events if e["kind"] == "dispatch"] == [2, 1, 0]
        rpt = router.latency_report()
        assert rpt[0]["mean_steps"] < rpt[1]["mean_steps"] < rpt[2]["mean_steps"]
        return router_view(router), requests_view(reqs), rpt

    run_both(scenario, pair)


def test_default_tier_is_lowest_priority(pair):
    def scenario(P):
        router, _ = _two_replica_router(P)
        router.submit(P.Request(rid=0, prompt=[1], max_new_tokens=1))
        assert len(router.tiers[-1]) == 1
        with pytest.raises(ValueError):
            router.submit(P.Request(rid=1, prompt=[2], max_new_tokens=1), tier=9)
        return [len(q) for q in router.tiers], router_view(router)

    run_both(scenario, pair)


def test_least_loaded_spreads_across_replicas(pair):
    def scenario(P):
        router, _ = _two_replica_router(P)
        reqs = [P.Request(rid=i, prompt=[1 + i], max_new_tokens=2) for i in range(4)]
        for r in reqs:
            router.submit(r)
        router.run_until_drained()
        assert all(r.done for r in reqs)
        by_rep = {}
        for e in router.events:
            if e["kind"] == "dispatch":
                by_rep.setdefault(e["replica"], []).append(e["rid"])
        assert sorted(len(v) for v in by_rep.values()) == [2, 2]
        return router_view(router), requests_view(reqs)

    run_both(scenario, pair)


def test_shortest_prefill_dispatch_avoids_prompt_heavy_replica(pair):
    def scenario(P):
        router, _ = _two_replica_router(P, config=P.RouterConfig(dispatch="shortest_prefill"))
        router.replicas[0].engine.submit(
            P.Request(rid=90, prompt=list(range(1, 41)), max_new_tokens=1))
        router.replicas[1].engine.submit(P.Request(rid=91, prompt=[1, 2], max_new_tokens=1))
        pending = [r.engine.pending_prefill_tokens() for r in router.replicas]
        assert pending[0] > pending[1]
        router.submit(P.Request(rid=0, prompt=[3], max_new_tokens=1))
        router.step()
        ev = [e for e in router.events if e["kind"] == "dispatch"][-1]
        assert ev["replica"] == "replica1" and ev["policy"] == "shortest_prefill"
        return pending, router_view(router)

    run_both(scenario, pair)


# ---------------------------------------------------------------------------
# drain → device pool → service replan, end to end
# ---------------------------------------------------------------------------


def test_unhealthy_replica_drains_and_pool_replan_spawns_replacement(pair):
    def scenario(P):
        router, _ = _two_replica_router(P)
        reqs = [P.Request(rid=i, prompt=[1 + i], max_new_tokens=2) for i in range(4)]
        for r in reqs:
            router.submit(r)
        router.replicas[0].engine.derate = {0: 0.2}
        router.run_until_drained()
        assert all(r.done for r in reqs)
        kinds = [e["kind"] for e in router.events]
        assert "drain_begin" in kinds and "drain_complete" in kinds
        assert router.replicas[0].state == "retired"
        assert router.device_pool == [0] and router.pool_derate == {0: 0.2}
        assert "replan_skipped" in kinds
        drained = router_view(router)
        router.pool_derate.clear()
        router._replan_pool()
        assert [e["kind"] for e in router.events][-1] == "replica_spawn"
        spawned = router.replicas[-1]
        assert spawned.devices == [0] and spawned.state == "active"
        assert router.device_pool == []
        late = P.Request(rid=99, prompt=[7], max_new_tokens=2)
        router.submit(late)
        router.run_until_drained()
        assert late.done
        return drained, router_view(router), requests_view(reqs + [late])

    run_both(scenario, pair)


def test_drain_requeues_handed_back_work_at_tier_front(pair):
    def scenario(P):
        rep = P.Replica(name="replica0", devices=[0], engine=_engine(P, P.cluster(1), slots=1))
        router = P.Router([rep], config=P.RouterConfig(tiers=1))
        a = P.Request(rid=0, prompt=[1], max_new_tokens=4)
        b = P.Request(rid=1, prompt=[2], max_new_tokens=4)
        router.submit(a)
        router.submit(b)
        router.step()
        router.replicas[0].engine.submit(b)
        router.tiers[0].clear()
        router._begin_drain(router.replicas[0], reason="test")
        assert [rec.req.rid for rec in router.tiers[0]] == [1]
        assert router.replicas[0].state == "draining"
        return router_view(router), requests_view([a, b])

    run_both(scenario, pair)


# ---------------------------------------------------------------------------
# single-replica identity + from_service_plan wiring
# ---------------------------------------------------------------------------


def _service_router(P, cluster, replicas):
    graph = P.transformer_graph(P.cfg, seq_len=64, granularity="block")
    svc = P.plan_replicas(graph, cluster, P.PlanConfig(method="etf", serving_slots=2),
                          replicas=replicas)
    router = P.Router.from_service_plan(
        P.cfg, P.params, cluster, svc, slots=2, max_len=64,
        plan_cfg=P.PlanConfig(method="etf"), eos_id=-1, **P.engine_kw,
    )
    return svc, router


def test_single_replica_router_output_identical_to_direct_engine(pair):
    def scenario(P):
        cluster = P.cluster(2, heterogeneous=True)
        prompts = [[1, 2, 3], [4, 5], [6]]
        direct = _engine(P, cluster)
        d_reqs = [P.Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
        for r in d_reqs:
            direct.submit(r)
        direct.run_until_drained()
        svc, router = _service_router(P, cluster, 1)
        eng = router.replicas[0].engine
        assert eng.cluster is cluster
        assert eng.placement_result is svc.replicas[0].result
        toks = {}
        r_reqs = [P.Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
        for r in r_reqs:
            router.submit(r, on_token=lambda rq, t: toks.setdefault(rq.rid, []).append(t))
        router.run_until_drained()
        for d, r in zip(d_reqs, r_reqs):
            assert r.done and r.out_tokens == d.out_tokens
            assert toks[r.rid] == r.out_tokens
        return requests_view(r_reqs), router_view(router), eng.placement_result.placement

    run_both(scenario, pair)


def test_from_service_plan_multi_replica_serves(pair):
    def scenario(P):
        svc, router = _service_router(P, P.cluster(2), 2)
        assert len(router.replicas) == 2
        for rep, spec in zip(router.replicas, svc.replicas):
            assert rep.devices == spec.devices
            k = rep.engine.cluster.k
            assert set(rep.engine.placement_result.placement.values()) <= set(range(k))
        reqs = [P.Request(rid=i, prompt=[1 + i, 2], max_new_tokens=3) for i in range(4)]
        for r in reqs:
            router.submit(r)
        router.run_until_drained()
        assert all(r.done and len(r.out_tokens) == 3 for r in reqs)
        used = {e["replica"] for e in router.events if e["kind"] == "dispatch"}
        assert used == {"replica0", "replica1"}
        return (router_view(router), requests_view(reqs),
                [(s.devices, s.throughput_rps) for s in svc.replicas])

    run_both(scenario, pair)


def test_router_rejects_bad_config(pair):
    def scenario(P):
        refused = []
        for bad in (dict(dispatch="round_robin"), dict(tiers=0)):
            with pytest.raises(ValueError) as e:
                P.RouterConfig(**bad)
            refused.append(str(e.value))
        with pytest.raises(ValueError) as e:
            P.Router([])
        refused.append(str(e.value))
        eng = _engine(P, P.cluster(1))
        with pytest.raises(ValueError, match="duplicate") as e:
            P.Router([P.Replica(name="r", devices=[0], engine=eng),
                      P.Replica(name="r", devices=[0], engine=eng)])
        refused.append(str(e.value))
        return refused

    run_both(scenario, pair)


def test_engine_rejects_placement_for_wrong_graph(pair):
    def scenario(P):
        cluster = P.cluster(1)
        other = P.transformer_graph(P.cfg, seq_len=32, granularity="fine")
        res = P.plan(other, cluster, P.PlanConfig(method="etf"))
        with pytest.raises(ValueError, match="does not cover") as e:
            _engine(P, cluster, placement_result=res)
        return str(e.value)

    run_both(scenario, pair)


# ---------------------------------------------------------------------------
# the port's narrowed catches
# ---------------------------------------------------------------------------


CARD_ERRORS = {
    "cuda": lambda: RuntimeError("CUDA error: an illegal memory access was encountered"),
    "oom": lambda: torch.cuda.OutOfMemoryError("CUDA out of memory"),
    "build": lambda: RuntimeError("nvcc not found: the CUDA kernels cannot be built here"),
    # a kernel wrapper refusing its inputs: a ValueError, but not the planner's
    "refusal": lambda: ValueError(
        "flash kernel copies Q and K/V in 16-byte pieces: align q, k and v to 16 bytes"),
}


def _fail(error):
    def raising(*args, **kw):
        raise error()
    return raising


def _failing_router(P, site, error):
    """Two replicas serving two requests; ``site`` of replica 0 raises
    ``error``: its engine step, its rebuild while it absorbs a fault, or the
    engine factory a pool replan spawns from."""
    router, _ = _two_replica_router(P, config=P.RouterConfig(tiers=1))
    reqs = [P.Request(rid=i, prompt=[1 + i, 2], max_new_tokens=3) for i in range(2)]
    for r in reqs:
        router.submit(r)
    router.step()
    eng = router.replicas[0].engine
    if site == "step":
        eng.step = _fail(error)
        act = router.step
    elif site == "apply_fault":
        eng._build_executor = _fail(error)
        act = lambda: router.apply_fault(  # noqa: E731
            P.FaultEvent(step=0, kind="device_stall", device=0, factor=0.8))
    else:
        router.engine_factory = _fail(error)

        def act():
            # drain replica 0: once idle its device goes to the pool, and
            # the pool replan calls the factory
            router._begin_drain(router.replicas[0], reason="test")
            for _ in range(16):
                router.step()
    return router, act


@pytest.mark.parametrize("error", sorted(CARD_ERRORS))
@pytest.mark.parametrize("site", ["step", "apply_fault", "spawn"])
def test_card_error_propagates_out_of_router(pair, site, error):
    """The reference retires the replica (or logs ``replan_failed``) for
    any exception; the port lets an error of the card stop the run."""
    ref, port = pair
    router, act = _failing_router(ref, site, CARD_ERRORS[error])
    act()
    kinds = [e["kind"] for e in router.events]
    assert ("replan_failed" if site == "spawn" else "replica_crash") in kinds
    router, act = _failing_router(port, site, CARD_ERRORS[error])
    with pytest.raises(type(CARD_ERRORS[error]())):
        act()
    kinds = [e["kind"] for e in router.events]
    assert "replica_crash" not in kinds and "replan_failed" not in kinds


# the smoke model's ~0.72 MB of weights fit across two devices of this
# memory, not on one
TIGHT_MEM = 6e5


def _tight_router(P):
    """Replica 0 on devices 0 and 1, too small to hold the model alone,
    replica 1 on a roomy device 2; Moirai plans (whose solve finds no
    placement on one small device), four requests in flight."""
    cluster = P.cluster(3, mem_bytes={0: TIGHT_MEM, 1: TIGHT_MEM})

    def factory(devs):
        return _engine(P, cluster.subcluster(devs),
                       plan_cfg=P.PlanConfig(method="moirai", time_limit=5.0))

    reps = [P.Replica(name="replica0", devices=[0, 1], engine=factory([0, 1])),
            P.Replica(name="replica1", devices=[2], engine=factory([2]))]
    router = P.Router(reps, engine_factory=factory, config=P.RouterConfig(tiers=1))
    reqs = [P.Request(rid=i, prompt=[1 + i, 2], max_new_tokens=3) for i in range(4)]
    for r in reqs:
        router.submit(r)
    router.step()
    return router, reqs


LOSS_TEXT = {"replica_crash": "reason", "replan_failed": "error"}


def _loss_texts(view):
    """Take the planner's error text out of ``view``'s crash and
    ``replan_failed`` events: the reference's is its bare ``KeyError``
    (``'0'``), the port's names the infeasible plan."""
    return [(e["kind"], e.pop(LOSS_TEXT[e["kind"]]))
            for e in view["events"] if e["kind"] in LOSS_TEXT]


NO_PLACEMENT = "no placement of 4 nodes fits "


def test_spawn_refused_by_the_planner_is_logged(pair):
    """A drained replica leaves one healthy device that cannot hold the
    model: the planner finds no placement, the spawn is logged
    ``replan_failed``, as in the reference, and serving goes on."""
    def scenario(P):
        router, reqs = _tight_router(P)
        router.replicas[0].engine.derate = {0: 0.9, 1: 0.05}   # health 0.475
        router.run_until_drained()
        assert all(r.state == "finished" for r in reqs)
        view = router_view(router)
        assert [e["pool"] for e in view["events"] if e["kind"] == "replan_failed"] == [[0]]
        return view, requests_view(reqs), _loss_texts(view)

    ref, port = pair
    want, got = scenario(ref), scenario(port)
    assert got[:2] == want[:2]
    assert want[2] == [("replan_failed", "0")]
    assert [k for k, _ in got[2]] == ["replan_failed"]
    assert got[2][0][1].startswith(NO_PLACEMENT)


def test_crash_leaving_too_little_memory_retires_the_replica(pair):
    """A crash of device 1 leaves replica 0 a survivor too small for the
    model: its replan finds no placement, the replica is retired as a
    crash, the spawn on its survivor fails the same way, and its requests
    finish on replica 1, as in the reference."""
    def scenario(P):
        router, reqs = _tight_router(P)
        status = router.apply_fault(P.FaultEvent(step=0, kind="device_crash", device=1))
        router.run_until_drained()
        assert all(r.state == "finished" for r in reqs)
        view = router_view(router)
        assert view["counters"]["crashed_replicas"] == 1
        return view, requests_view(reqs), _loss_texts(view), status

    ref, port = pair
    want, got = scenario(ref), scenario(port)
    assert got[:2] == want[:2]
    assert want[2:] == ([("replica_crash", "device_crash on device 1: 0"),
                         ("replan_failed", "0")], "replica0: crashed (0)")
    (k0, crash), (k1, spawn) = got[2]
    assert (k0, k1) == ("replica_crash", "replan_failed")
    assert crash.startswith("device_crash on device 1: " + NO_PLACEMENT)
    assert spawn.startswith(NO_PLACEMENT)
    assert got[3].startswith("replica0: crashed (" + NO_PLACEMENT)


def test_from_service_plan_needs_a_card_by_default(pair):
    _, port = pair
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cluster = port.cluster(1)
    graph = port.transformer_graph(port.cfg, seq_len=64, granularity="block")
    svc = port.plan_replicas(graph, cluster, port.PlanConfig(method="etf"), replicas=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.Router.from_service_plan(port.cfg, port.params, cluster, svc, max_len=64,
                                      plan_cfg=port.PlanConfig(method="etf"))


def test_retired_replica_releases_its_caches(pair):
    """A drained or crashed replica drops its KV caches; its stats stay."""
    _, P = pair
    router, _ = _two_replica_router(P, config=P.RouterConfig(tiers=1, replan_on_drain=False))
    reqs = [P.Request(rid=i, prompt=[1 + i, 2], max_new_tokens=3) for i in range(2)]
    for r in reqs:
        router.submit(r)
    router.step()
    assert all(rep.engine.caches is not None for rep in router.replicas)
    router.apply_fault(P.FaultEvent(step=0, kind="device_crash", device=0))
    router.run_until_drained()
    assert all(r.state == "finished" for r in reqs)
    router._begin_drain(router.replicas[1], reason="test")
    router.step()                     # idle: the drain completes at once
    assert [rep.state for rep in router.replicas] == ["retired", "retired"]
    assert all(rep.engine.caches is None for rep in router.replicas)
    st = router.stats()
    assert st["counters"]["crashed_replicas"] == 1
    assert [r["health"] for r in st["replicas"]] == [0.0, 1.0]
