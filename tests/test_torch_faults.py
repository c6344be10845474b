"""Port parity of the chaos harness (``serving/faults.py``) and graceful
degradation: every scenario of ``tests/test_faults.py`` runs through the
reference and the port (same weights, same clusters), each run held to the
reference test's own assertions, and the two runs to each other: schedules
and their JSON, injector logs and statuses, derated clusters and plans,
tokens, terminal states, the engine's fault log and the router's counters
and events."""

import json
import math

import numpy as np
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
    kw.setdefault("slots", 1)
    return P.engine(cluster, **kw)


def _engine_view(eng) -> dict:
    return {
        "fault_log": list(eng.fault_log),
        "failed_devices": list(eng.failed_devices),
        "derate": dict(eng.derate),
        "link_derate": dict(eng.link_derate),
        "placement": dict(eng.placement_result.placement),
        "replans": [(h["reason"], h["failed_devices"], h["derate"], h["link_derate"])
                    for h in eng.replan_history],
    }


# ---------------------------------------------------------------------------
# FaultEvent / FaultSchedule: validation, determinism, persistence
# ---------------------------------------------------------------------------


BAD_EVENTS = [
    dict(step=0, kind="meteor_strike", device=0),
    dict(step=-1, kind="device_crash", device=0),
    dict(step=0, kind="device_crash"),
    dict(step=0, kind="link_degrade", device=0),
    dict(step=0, kind="recover", device=0, link=(0, 1)),
    dict(step=0, kind="recover"),
    dict(step=0, kind="device_stall", device=0, factor=1.0),
    dict(step=0, kind="link_degrade", link=(0, 1), factor=1.0),
    dict(step=0, kind="device_crash", device=0, duration=3),
    dict(step=0, kind="device_stall", device=0, factor=0.5, duration=0),
]


def test_fault_event_validation_and_roundtrip(pair):
    def scenario(P):
        ev = P.FaultEvent(step=3, kind="link_degrade", link=[0, 1], factor=0.125, duration=4)
        assert ev.link == (0, 1)
        assert P.FaultEvent.from_dict(ev.to_dict()) == ev
        refused = []
        for bad in BAD_EVENTS:
            with pytest.raises(ValueError) as e:
                P.FaultEvent(**bad)
            refused.append(str(e.value))
        return ev.to_dict(), refused

    run_both(scenario, pair)


def test_schedule_sorts_and_json_roundtrips(pair, tmp_path):
    def scenario(P):
        late = P.FaultEvent(step=9, kind="device_crash", device=1)
        early = P.FaultEvent(step=2, kind="device_stall", device=0, factor=0.5, duration=4)
        sched = P.FaultSchedule([late, early], name="scripted", seed=7)
        assert [e.step for e in sched] == [2, 9]
        assert sched.horizon == 9 and len(sched) == 2
        assert P.FaultSchedule.from_json(sched.to_json()) == sched
        path = tmp_path / f"chaos-{P.name}.json"
        sched.save(str(path))
        assert P.FaultSchedule.load(str(path)) == sched
        assert json.loads(path.read_text())["version"] == 1
        with pytest.raises(ValueError):
            P.FaultSchedule.from_json('{"version": 99}')
        return sched.to_json(), path.read_text()

    run_both(scenario, pair)


def test_random_schedule_is_seed_deterministic(pair):
    def scenario(P):
        kw = dict(horizon=50, n_devices=4, links=[(0, 1), (1, 2)], n_events=12)
        a = P.FaultSchedule.random(11, **kw)
        assert a == P.FaultSchedule.random(11, **kw)
        c = P.FaultSchedule.random(12, **kw)
        assert a.events != c.events
        for s in (a, c):
            assert all(e.kind in P.FAULT_KINDS for e in s)
            crashes = [e.device for e in s if e.kind == "device_crash"]
            assert len(crashes) == len(set(crashes)) and len(crashes) < 4
        return a.to_json(), c.to_json()

    run_both(scenario, pair)


def test_injector_fires_due_events_and_auto_recovers(pair):
    class Recorder:
        def __init__(self):
            self.seen = []

        def apply_fault(self, ev):
            self.seen.append((ev.kind, ev.device, ev.link))
            return "ok"

    def scenario(P):
        sched = P.FaultSchedule([
            P.FaultEvent(step=1, kind="device_stall", device=0, factor=0.5, duration=2),
            P.FaultEvent(step=3, kind="link_degrade", link=(0, 1), factor=0.25, duration=1),
        ])
        target, inj = Recorder(), P.FaultInjector(sched)
        fired = {}
        for step in range(6):
            for ev in inj.on_step(target):
                fired.setdefault(step, []).append(ev.kind)
        assert fired == {1: ["device_stall"], 3: ["link_degrade", "recover"], 4: ["recover"]}
        assert target.seen[2] == ("recover", 0, None)
        assert target.seen[3] == ("recover", None, (0, 1))
        assert inj.exhausted
        assert [e["clock"] for e in inj.log] == [1, 3, 3, 4]
        return fired, target.seen, inj.log

    run_both(scenario, pair)


# ---------------------------------------------------------------------------
# per-link channel derates: ClusterSpec → closure → replan
# ---------------------------------------------------------------------------


def _tri_cluster(P, bw01=8e9, bw02=4e9, bw12=4e9):
    devs = [P.DeviceSpec(f"d{i}", peak_flops=1e12, mem_bytes=16e9, hbm_bw=1e11)
            for i in range(3)]
    bw = np.zeros((3, 3))
    bw[0, 1] = bw[1, 0] = bw01
    bw[0, 2] = bw[2, 0] = bw02
    bw[1, 2] = bw[2, 1] = bw12
    return P.ClusterSpec(devs, bw, name="tri")


def test_with_derate_links_scales_both_directions(pair):
    def scenario(P):
        cluster = _tri_cluster(P)
        der = cluster.with_derate(links={(0, 1): 0.5})
        assert der.link_bw[0, 1] == der.link_bw[1, 0] == pytest.approx(4e9)
        assert cluster.link_bw[0, 1] == pytest.approx(8e9)
        asym = cluster.with_derate(links={(0, 1): 0.5, (1, 0): 0.25})
        assert asym.link_bw[1, 0] == pytest.approx(2e9)
        both = cluster.with_derate({2: 0.5}, links={(0, 1): 0.5})
        assert both.devices[2].peak_flops == pytest.approx(0.5e12)
        for bad in ({(0, 7): 0.5}, {(1, 1): 0.5}, {(0, 1): -0.5}):
            with pytest.raises(ValueError):
                cluster.with_derate(links=bad)
        return ([c.link_bw.tolist() for c in (der, asym, both)],
                [d.peak_flops for d in both.devices])

    run_both(scenario, pair)


def test_link_partition_reroutes_via_widest_path(pair):
    def scenario(P):
        cluster = _tri_cluster(P)
        cut = cluster.with_derate(links={(0, 1): 0.0})
        assert cut.link_bw[0, 1] == 0.0 and cut.is_connected()
        assert cut.effective_bw(0, 1) == pytest.approx(4e9)
        slow = cluster.with_derate(links={(0, 1): 0.125})
        assert slow.effective_bw(0, 1) == pytest.approx(4e9)
        two = P.ClusterSpec(
            [P.DeviceSpec(f"d{i}", peak_flops=1e12, mem_bytes=16e9, hbm_bw=1e11)
             for i in range(2)],
            np.array([[0.0, 1e9], [1e9, 0.0]]),
        ).with_derate(links={(0, 1): 0.0})
        assert not two.is_connected() and math.isinf(two.comm_time(1e6, 0, 1))
        return (cluster.effective_bw(0, 1), cut.effective_bw(0, 1),
                cut.effective_latency(0, 1), slow.effective_bw(0, 1))

    run_both(scenario, pair)


def test_replan_link_derate_routes_off_degraded_link(pair):
    def scenario(P):
        graph = P.transformer_graph(P.get_config("llama3.2-1b"), seq_len=1024,
                                    granularity="block")
        cluster = P.cluster(2)
        pc = P.PlanConfig(method="moirai", objective="throughput", time_limit=5.0,
                          mip_rel_gap=0.1)
        nominal = P.replan(graph, cluster, (), pc)
        assert set(nominal.placement.values()) == {0, 1}
        aware = P.replan(graph, cluster, (), pc, link_derate={(0, 1): 1e-9})
        assert len(set(aware.placement.values())) == 1
        assert aware.extra["link_derate"] == {"0-1": 1e-9}
        assert aware.extra["failed_devices"] == []
        res = P.replan(graph, P.cluster(3), [1], P.PlanConfig(method="etf"),
                       link_derate={(0, 1): 0.5, (0, 2): 1.0, (2, 0): 0.25})
        assert res.extra["link_derate"] == {"2-0": 0.25}
        assert 1 not in set(res.placement.values())
        return nominal.placement, aware.placement, res.placement

    run_both(scenario, pair)


# ---------------------------------------------------------------------------
# channel attribution: calibrator samples → policy keys → persisted state
# ---------------------------------------------------------------------------


def test_calibrator_channel_samples_weighted_geomean(pair):
    def scenario(P):
        cal = P.DerateCalibrator()
        cal.add_channel_sample(0, 1, 4.0, weight=1.0)
        cal.add_channel_sample(0, 1, 1.0, weight=1.0)
        cal.add_channel_sample(1, 0, 9.0, weight=2.0)
        ratios = dict(cal.channel_ratios())
        assert ratios[(0, 1)] == pytest.approx(2.0) and ratios[(1, 0)] == pytest.approx(9.0)
        cal.add_channel_sample(2, 3, float("nan"))
        cal.add_channel_sample(2, 3, -2.0)
        cal.add_channel_sample(2, 3, 5.0, weight=0.0)
        cal.add_channel_sample(2, 2, 5.0)
        assert (2, 3) not in cal.channel_ratios() and (2, 2) not in cal.channel_ratios()
        assert cal.device_ratios() == {}
        return ratios, dict(cal.channel_ratios())

    run_both(scenario, pair)


def test_policy_handles_mixed_device_and_channel_keys(pair, tmp_path):
    def scenario(P):
        policy = P.DeratePolicy(P.AdaptationConfig(confirm_windows=2, smoothing=1.0))
        outs = [policy.observe({0: 4.0, (0, 1): 8.0}) for _ in range(2)]
        assert outs[-1] is not None
        maps = [policy.derate_map(), policy.link_derate_map()]
        assert maps == [{0: pytest.approx(0.25)}, {(0, 1): pytest.approx(0.125)}]
        policy.failed_devices = [1]
        policy.forget(1)
        assert policy.link_derate_map() == {}
        path = tmp_path / f"derate-{P.name}.json"
        policy.save(str(path))
        loaded = P.DeratePolicy.load(str(path), policy.config)
        assert loaded.derate_map() == {0: pytest.approx(0.25)}
        assert loaded.failed_devices == [1]
        return (maps, policy.derate_map(), json.loads(path.read_text()),
                [(e.action, e.device, e.new_factor) for e in policy.events])

    run_both(scenario, pair)


# ---------------------------------------------------------------------------
# engine: fault application, stash/restore, persistence, cascades
# ---------------------------------------------------------------------------


def test_engine_applies_and_recovers_stall_and_link_faults(pair):
    def scenario(P):
        eng = _engine(P, P.cluster(2))
        statuses = []

        def fault(**kw):
            statuses.append(eng.apply_fault(P.FaultEvent(step=0, **kw)))
            return statuses[-1]

        assert "stalled" in fault(kind="device_stall", device=1, factor=0.25)
        assert eng.derate == {1: 0.25}
        assert eng.replan_history[-1]["reason"].startswith("injected stall")
        assert "recovered" in fault(kind="recover", device=1)
        assert eng.derate == {}
        assert "degraded" in fault(kind="link_degrade", link=(0, 1), factor=0.125)
        assert eng.link_derate == {(0, 1): 0.125}
        assert eng.placement_result.extra["link_derate"] == {"0-1": 0.125}
        assert "recovered" in fault(kind="recover", link=(0, 1))
        assert eng.link_derate == {}
        assert "ignored" in fault(kind="recover", device=0)
        assert "ignored" in fault(kind="device_stall", device=9, factor=0.5)
        assert "crashed" in fault(kind="device_crash", device=1)
        assert eng.failed_devices == [1]
        assert set(eng.placement_result.placement.values()) == {0}
        assert "ignored" in fault(kind="device_crash", device=1)
        assert [e["kind"] for e in eng.fault_log].count("device_crash") == 2
        req = P.Request(rid=0, prompt=[1, 2], max_new_tokens=2)
        eng.submit(req)
        eng.run_until_drained()
        assert req.done and req.state == "finished"
        return statuses, _engine_view(eng), requests_view([req])

    run_both(scenario, pair)


def test_engine_crash_drops_link_faults_touching_dead_device(pair):
    def scenario(P):
        eng = _engine(P, P.cluster(3))
        eng.apply_fault(P.FaultEvent(step=0, kind="link_degrade", link=(1, 2), factor=0.25))
        assert eng.link_derate == {(1, 2): 0.25}
        eng.apply_fault(P.FaultEvent(step=0, kind="device_crash", device=2))
        assert eng.link_derate == {}
        assert "ignored" in eng.apply_fault(P.FaultEvent(step=0, kind="recover", link=(1, 2)))
        return _engine_view(eng)

    run_both(scenario, pair)


def _reference_run(P, cluster, prompt, max_new, **kw):
    eng = _engine(P, cluster, **kw)
    ref = P.Request(rid=0, prompt=list(prompt), max_new_tokens=max_new)
    eng.submit(ref)
    eng.run_until_drained()
    assert len(ref.out_tokens) == max_new
    return ref


def test_engine_injector_schedule_is_token_identical(pair):
    def scenario(P):
        cluster = P.cluster(2)
        ref = _reference_run(P, cluster, [1, 2, 3], 6)
        eng = _engine(P, cluster)
        inj = P.FaultInjector(P.FaultSchedule([
            P.FaultEvent(step=2, kind="device_stall", device=1, factor=0.3, duration=2),
        ]))
        eng.attach_fault_injector(inj)
        req = P.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=6)
        eng.submit(req)
        eng.run_until_drained()
        assert req.done and req.out_tokens == ref.out_tokens
        assert [e["kind"] for e in eng.fault_log] == ["device_stall", "recover"]
        assert eng.derate == {}
        return requests_view([ref, req]), _engine_view(eng), inj.log

    run_both(scenario, pair)


def test_engine_restart_excludes_persisted_failed_devices(pair, tmp_path):
    def scenario(P):
        cluster = P.cluster(2)
        state = tmp_path / f"derate-state-{P.name}.json"
        adapt = P.AdaptationConfig(state_path=str(state))
        eng = _engine(P, cluster, adapt=adapt)
        eng.apply_fault(P.FaultEvent(step=0, kind="device_crash", device=1))
        assert json.loads(state.read_text())["failed_devices"] == [1]
        fresh = _engine(P, cluster, adapt=adapt)
        assert fresh.failed_devices == [1]
        assert 1 not in set(fresh.placement_result.placement.values())
        req = P.Request(rid=0, prompt=[1, 2], max_new_tokens=3)
        fresh.submit(req)
        fresh.run_until_drained()
        assert req.done and req.state == "finished"
        return json.loads(state.read_text()), _engine_view(fresh), requests_view([req])

    run_both(scenario, pair)


def test_cascading_second_crash_during_recovery_token_identical(pair):
    def scenario(P):
        cluster = P.cluster(3)
        ref = _reference_run(P, cluster, [1, 2, 3], 6)
        eng = _engine(P, cluster)
        req = P.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=6)
        eng.submit(req)
        eng.step()
        eng.step()
        assert 0 < len(req.out_tokens) < 6
        eng.on_device_failure(2)
        assert eng.queue == [req]
        eng.on_device_failure(1)
        assert eng.failed_devices == [2, 1]
        assert set(eng.placement_result.placement.values()) == {0}
        eng.run_until_drained()
        assert req.done and req.out_tokens == ref.out_tokens
        return requests_view([ref, req]), _engine_view(eng)

    run_both(scenario, pair)


def test_crash_mid_prefill_chunk_token_identical(pair):
    def scenario(P):
        cluster = P.cluster(2)
        prompt = list(range(1, 9))
        ref = _reference_run(P, cluster, prompt, 4, prefill_chunk=2)
        eng = _engine(P, cluster, prefill_chunk=2)
        req = P.Request(rid=0, prompt=list(prompt), max_new_tokens=4)
        eng.submit(req)
        eng.step()
        assert req.out_tokens == [] and req.started
        eng.on_device_failure(0)
        eng.run_until_drained()
        assert req.done and req.out_tokens == ref.out_tokens
        return requests_view([ref, req]), _engine_view(eng)

    run_both(scenario, pair)


def test_engine_overflow_counter_surfaces_dropped_finished(pair):
    from collections import deque

    def scenario(P):
        eng = _engine(P, P.cluster(1), oversize="reject")
        eng._unclaimed_finished = deque(maxlen=1)
        reqs = [P.Request(rid=rid, prompt=list(range(100)), max_new_tokens=60)
                for rid in range(3)]
        for r in reqs:
            eng.submit(r)
        assert eng._unclaimed_overflow == 2
        assert eng.straggler_report()["overflow"]["unclaimed_finished"] == 2
        return requests_view(reqs), eng.straggler_report()["overflow"]

    run_both(scenario, pair)


# ---------------------------------------------------------------------------
# router: rate limits, deadlines, SLO shedding, crash retries
# ---------------------------------------------------------------------------


def _one_replica_router(P, *, slots=1, **router_kw):
    cluster = P.cluster(1)

    def factory(devs):
        return _engine(P, cluster.subcluster(devs), slots=slots)

    rep = P.Replica(name="replica0", devices=[0], engine=factory([0]))
    return P.Router([rep], engine_factory=factory, **router_kw)


def test_router_rate_limit_sheds_with_typed_state(pair):
    def scenario(P):
        router = _one_replica_router(P, config=P.RouterConfig(tiers=1, tier_rates=[0.0]))
        reqs = [P.Request(rid=i, prompt=[1 + i], max_new_tokens=2) for i in range(3)]
        for r in reqs:
            router.submit(r)
        assert [r.state for r in reqs] == ["pending", "shed", "shed"]
        assert all(r.done and r.rejected for r in reqs[1:])
        router.run_until_drained()
        assert reqs[0].state == "finished"
        st = router.stats()
        assert st["counters"]["shed"] == 2
        assert st["finished_by_state"] == {"finished": 1, "shed": 2}
        return router_view(router), requests_view(reqs)

    run_both(scenario, pair)


def test_router_expires_queued_requests_past_deadline(pair):
    def scenario(P):
        router = _one_replica_router(P, config=P.RouterConfig(tiers=1))
        slow = P.Request(rid=0, prompt=[1], max_new_tokens=8)
        hasty = P.Request(rid=1, prompt=[2], max_new_tokens=2, deadline=1)
        router.submit(slow)
        router.submit(hasty)
        done = router.run_until_drained()
        assert hasty.state == "expired" and hasty.done and hasty.out_tokens == []
        assert slow.state == "finished" and len(slow.out_tokens) == 8
        assert {r.rid for r in done} == {0, 1}
        assert router.counters["expired"] == 1
        return router_view(router), requests_view([slow, hasty])

    run_both(scenario, pair)


def test_router_slo_breach_sheds_batch_keeps_interactive(pair):
    def scenario(P):
        router = _one_replica_router(P, config=P.RouterConfig(tiers=2, slo_p99_steps=1))
        interactive = [P.Request(rid=i, prompt=[1 + i], max_new_tokens=3) for i in range(2)]
        batch = [P.Request(rid=10 + i, prompt=[5 + i], max_new_tokens=3) for i in range(3)]
        for r in interactive:
            router.submit(r, tier=0)
        for r in batch:
            router.submit(r, tier=1)
        router.run_until_drained()
        assert all(r.state == "finished" for r in interactive)
        assert router.counters["shed"] >= 1
        assert all(r.done for r in batch)
        assert {r.state for r in batch} <= {"finished", "shed"}
        shed = [e for e in router.events if e["kind"] == "shed"]
        assert shed and all(e["tier"] == 1 for e in shed)
        return router_view(router), requests_view(interactive + batch)

    run_both(scenario, pair)


def test_router_logs_noncrash_fault_with_status(pair):
    def scenario(P):
        router = _one_replica_router(P, config=P.RouterConfig(tiers=1))
        status = router.apply_fault(
            P.FaultEvent(step=0, kind="device_stall", device=0, factor=0.5))
        assert status == "replica0: stalled device 0 at ×0.5"
        fault_events = [e for e in router.events if e["kind"] == "fault"]
        assert len(fault_events) == 1
        assert fault_events[0]["fault"] == "device_stall"
        assert fault_events[0]["target"] == "device 0"
        return status, router_view(router)

    run_both(scenario, pair)


def test_router_crash_retries_token_identical_on_survivor(pair):
    def scenario(P):
        cluster = P.cluster(2)

        def factory(devs):
            return _engine(P, cluster.subcluster(devs), slots=1)

        ref_eng = factory([1])
        ref = P.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=5)
        ref_eng.submit(ref)
        ref_eng.run_until_drained()
        reps = [P.Replica(name=f"replica{i}", devices=[i], engine=factory([i])) for i in range(2)]
        router = P.Router(reps, engine_factory=factory,
                          config=P.RouterConfig(tiers=1, retry_backoff=1))
        req = P.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=5)
        router.submit(req)
        router.step()
        owner = next(e["replica"] for e in router.events if e["kind"] == "dispatch")
        dev = next(r for r in router.replicas if r.name == owner).devices[0]
        assert 0 < len(req.out_tokens) < 5
        status = router.apply_fault(P.FaultEvent(step=0, kind="device_crash", device=dev))
        assert "crashed" in status
        assert req.retries == 1 and not req.done
        router.run_until_drained()
        assert req.state == "finished" and req.out_tokens == ref.out_tokens
        st = router.stats()
        assert st["counters"]["crashed_replicas"] == 1 and st["counters"]["retried"] == 1
        assert [r["state"] for r in st["replicas"]].count("retired") == 1
        return status, router_view(router), requests_view([ref, req])

    run_both(scenario, pair)


def test_router_exhausted_retry_budget_is_typed_failed(pair):
    def scenario(P):
        router = _one_replica_router(P, config=P.RouterConfig(tiers=1))
        req = P.Request(rid=0, prompt=[1, 2], max_new_tokens=4, max_retries=0)
        router.submit(req)
        router.step()
        assert req.started
        statuses = [router.apply_fault(P.FaultEvent(step=0, kind="device_crash", device=0))]
        assert req.state == "failed" and req.done
        assert router.counters["failed"] == 1
        assert router.stats()["finished_by_state"] == {"failed": 1}
        statuses.append(router.apply_fault(P.FaultEvent(step=0, kind="device_crash", device=0)))
        assert "ignored" in statuses[-1]
        return statuses, router_view(router), requests_view([req])

    run_both(scenario, pair)


def test_router_event_log_overflow_is_counted(pair):
    def scenario(P):
        router = _one_replica_router(P, config=P.RouterConfig(tiers=1, event_log_keep=4))
        reqs = [P.Request(rid=i, prompt=[1 + i], max_new_tokens=1) for i in range(6)]
        for r in reqs:
            router.submit(r)
        router.run_until_drained()
        assert router.counters["events_dropped"] > 0
        assert len(router.events) <= 4
        assert router.stats()["counters"]["events_dropped"] == router.counters["events_dropped"]
        return router_view(router), requests_view(reqs)

    run_both(scenario, pair)


# ---------------------------------------------------------------------------
# a chaos schedule through the router, end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 11])
def test_router_random_schedule_replays_identically(pair, seed):
    """A seeded random schedule (crashes, stalls, link faults) replayed into
    a router of two 2-device replicas: the same injections and statuses,
    events, counters and tokens in both packages, and every submission in
    exactly one terminal state."""
    def scenario(P):
        cluster = P.cluster(4)

        def factory(devs):
            return _engine(P, cluster.subcluster(devs), slots=2)

        reps = [P.Replica(name=f"replica{i}", devices=[2 * i, 2 * i + 1],
                          engine=factory([2 * i, 2 * i + 1])) for i in range(2)]
        router = P.Router(reps, engine_factory=factory, config=P.RouterConfig(retry_backoff=1))
        sched = P.FaultSchedule.random(seed, horizon=8, n_devices=4,
                                       links=[(0, 1), (2, 3)], n_events=5)
        inj = P.FaultInjector(sched)
        router.attach_fault_injector(inj)
        reqs = [P.Request(rid=i, prompt=[1 + i % 5, 2, 3], max_new_tokens=4) for i in range(6)]
        for i, r in enumerate(reqs):
            router.submit(r, tier=i % router.config.tiers)
        router.run_until_drained(max_steps=200)
        st = router.stats()
        assert all(r.done for r in reqs)
        assert sum(st["finished_by_state"].values()) == len(reqs)
        return sched.to_json(), inj.log, router_view(router), requests_view(reqs)

    got = run_both(scenario, pair)
    assert got[1], "the schedule injected nothing"
