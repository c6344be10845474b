"""Port parity of the serving path: planning, the engine's generated tokens
under every prefill mode, failure replans, and the serve CLI on the CPU.

Both engines get the reference's smoke weights (``params_from_jax``) and the
same requests; greedy decoding must give identical ``out_tokens``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.devices import get_cluster, tpu_slice_cluster
from repro.core.modelgraph import transformer_graph
from repro.core.placement import PlanConfig, plan
from repro.models.model import build_model
from repro.serving.engine import Request, ServingEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.devices import get_cluster as t_get_cluster, h100_cluster
from repro_torch.core.modelgraph import transformer_graph as t_transformer_graph
from repro_torch.core.placement import PlanConfig as TPlanConfig, plan as t_plan
from repro_torch.launch import serve as t_serve
from repro_torch.serving.engine import Request as TRequest, ServingEngine as TServingEngine

CPU = [torch.device("cpu")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = get_config("llama3.2-1b").smoke()
    tcfg = dataclasses.replace(t_get_config("llama3.2-1b").smoke(), attention_impl="pallas")
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, 500, size=int(n)).tolist() for n in (3, 17, 9, 30, 1)]


@pytest.mark.parametrize("method", ["etf", "getf", "moirai"])
@pytest.mark.parametrize("preset", ["inter_server", "intra_server"])
def test_plan_matches_reference_on_gpu_presets(preset, method):
    cfg = get_config("llama3.2-1b").smoke()
    g = transformer_graph(cfg, seq_len=64, granularity="block")
    tg = t_transformer_graph(t_get_config("llama3.2-1b").smoke(), seq_len=64, granularity="block")
    kw = dict(method=method, time_limit=10.0)
    ref = plan(g, get_cluster(preset), PlanConfig(**kw))
    got = t_plan(tg, t_get_cluster(preset), TPlanConfig(**kw))
    assert got.placement == ref.placement
    assert got.objective == pytest.approx(ref.objective, rel=1e-9)


def test_placeto_is_not_ported():
    tg = t_transformer_graph(t_get_config("llama3.2-1b").smoke(), seq_len=64, granularity="block")
    with pytest.raises(NotImplementedError, match="A12"):
        t_plan(tg, h100_cluster(2), TPlanConfig(method="placeto"))


def test_h100_cluster_preset():
    c = h100_cluster(4, heterogeneous=True)
    assert c.k == 4 and c.name == "h100-x4"
    assert c.devices[0].peak_flops == 989e12 and c.devices[1].peak_flops == 989e12 / 2
    assert c.devices[0].mem_bytes == 80e9 and c.devices[0].hbm_bw == 3.35e12
    assert c.link_bw[0, 3] == 450e9 and c.link_bw[2, 2] == 0.0
    assert t_get_cluster("h100", n=2).k == 2


@pytest.mark.parametrize(
    "mode",
    [dict(), dict(fused=False), dict(prefill_chunk=None), dict(batching="lockstep")],
    ids=["fused", "interleaved", "blocking", "lockstep"],
)
def test_engine_tokens_match_reference(models, mode):
    jcfg, tcfg, jp, tp = models
    kw = dict(dict(slots=2, max_len=64, eos_id=-1, prefill_chunk=8), **mode)
    ref = ServingEngine(jcfg, jp, tpu_slice_cluster(n_slices=1),
                        plan_cfg=PlanConfig(method="etf"), **kw)
    eng = TServingEngine(tcfg, tp, h100_cluster(1), devices=CPU,
                         plan_cfg=TPlanConfig(method="etf"), **kw)
    jr = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(_prompts())]
    tr = [TRequest(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(_prompts())]
    for a, b in zip(jr, tr):
        ref.submit(a)
        eng.submit(b)
    ref.run_until_drained()
    eng.run_until_drained()
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and r.state == "finished" for r in tr)
    assert eng._fused_on() == ref._fused_on()
    rep = eng.straggler_report()
    assert rep["stragglers"] == [] and rep["kv"] is None


def test_engine_replans_after_device_failure(models):
    """Two modeled devices on the CPU; device 1 fails mid-run, in-flight
    requests are re-queued and resume token-identically."""
    jcfg, tcfg, jp, tp = models
    ref = ServingEngine(jcfg, jp, tpu_slice_cluster(n_slices=1), slots=2, max_len=64,
                        plan_cfg=PlanConfig(method="etf"), eos_id=-1, prefill_chunk=8)
    for i, p in enumerate(_prompts()[:3]):
        ref.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    want = [r.out_tokens for r in sorted(ref.run_until_drained(), key=lambda r: r.rid)]

    # two device objects: the executor starts a stage at every device change
    devices = [torch.device("cpu"), torch.device("cpu")]
    eng = TServingEngine(tcfg, tp, h100_cluster(2), devices=devices,
                         slots=2, max_len=64, plan_cfg=TPlanConfig(method="round_robin"),
                         eos_id=-1, prefill_chunk=8)
    assert len(eng.executor.stages) > 1
    reqs = [TRequest(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(_prompts()[:3])]
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    eng.on_device_failure(1)
    assert eng.failed_devices == [1]
    assert set(eng.placement_result.placement.values()) == {0}
    assert eng.replan_history[-1]["reason"] == "device 1 failed"
    eng.run_until_drained()
    assert [r.out_tokens for r in reqs] == want


def test_engine_applies_injected_faults(models):
    """Fault events (duck-typed, as the chaos harness sends them): a stall
    derates and replans, its recover restores the plan, a crash fails the
    device — and serving continues token-identically."""
    from types import SimpleNamespace as Ev

    _, tcfg, _, tp = models
    devices = [torch.device("cpu"), torch.device("cpu")]
    eng = TServingEngine(tcfg, tp, h100_cluster(2), devices=devices, slots=2, max_len=64,
                         plan_cfg=TPlanConfig(method="etf"), eos_id=-1, prefill_chunk=8)
    base = TServingEngine(tcfg, tp, h100_cluster(1), devices=CPU, slots=2, max_len=64,
                          plan_cfg=TPlanConfig(method="etf"), eos_id=-1, prefill_chunk=8)
    reqs = [TRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(_prompts()[:2])]
    want = [TRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(_prompts()[:2])]
    for a, b in zip(reqs, want):
        eng.submit(a)
        base.submit(b)
    base.run_until_drained()
    eng.step()
    assert "stalled" in eng.apply_fault(Ev(kind="device_stall", device=1, factor=0.25, link=None))
    assert eng.derate == {1: 0.25}
    eng.step()
    assert "recovered" in eng.apply_fault(Ev(kind="recover", device=1, link=None))
    assert eng.derate == {}
    assert "crashed" in eng.apply_fault(Ev(kind="device_crash", device=1, link=None))
    assert eng.failed_devices == [1]
    assert [e["kind"] for e in eng.fault_log] == ["device_stall", "recover", "device_crash"]
    eng.run_until_drained()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in want]


def test_engine_refuses_unported_paths(models):
    """Speculative serving is ported; what the reference refuses — an SSM
    draft behind the stage executor — the port refuses too."""
    _, tcfg, _, tp = models
    ssm = t_get_config("mamba2-130m").smoke()
    with pytest.raises(ValueError, match="dense/moe draft"):
        TServingEngine(tcfg, tp, h100_cluster(1), devices=CPU,
                       plan_cfg=TPlanConfig(method="etf"), draft_cfg=ssm, draft_params=tp)


def test_engine_default_devices_need_a_card(models):
    _, tcfg, _, tp = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TServingEngine(tcfg, tp, h100_cluster(1), plan_cfg=TPlanConfig(method="etf"))


def test_serve_cli_smoke_on_cpu(capsys):
    engine, reqs = t_serve.main([
        "--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
        "--requests", "3", "--max-new-tokens", "4", "--method", "etf",
    ])
    assert engine.cfg.attention_impl == "pallas" and not engine.cfg.scan_layers
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
    out = capsys.readouterr().out
    assert "tok/s" in out and "cluster=h100-x1" in out


def test_serve_cli_draft_on_cpu(capsys):
    """``--draft`` serves speculatively, prints the ``[spec]`` lines, and
    emits the tokens of the same run without a draft."""
    argv = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--requests", "3",
            "--max-new-tokens", "6", "--method", "etf"]
    _, plain = t_serve.main(argv)
    capsys.readouterr()
    engine, reqs = t_serve.main(argv + ["--draft", "llama3.2-1b", "--spec-tokens", "3"])
    out = capsys.readouterr().out
    assert engine.spec_tokens == 3 and engine._spec_on()
    assert "spec=draft:llama3.2-1b,k=3" in out
    assert "[spec] k=3 planned a=0.75" in out and "[spec]   default:" in out
    assert engine.speculation_report()["classes"]["default"]["rounds"] > 0
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in plain]


CLI = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--requests", "5",
       "--max-new-tokens", "5", "--method", "etf"]


@pytest.fixture(scope="module")
def cli_plain():
    """The single engine's tokens on the CLI's traffic (greedy, so any
    placement and any replica gives them)."""
    _, reqs = t_serve.main(CLI)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("flags", [
    ["--replicas", "2", "--cluster-size", "2"],
    ["--replicas", "auto", "--cluster-size", "4", "--slo-p99", "1.0"],
], ids=["two", "auto"])
def test_serve_cli_replicas_on_cpu(capsys, cli_plain, flags):
    router, reqs = t_serve.main(CLI + flags)
    out = capsys.readouterr().out
    n = len(router.replicas)
    assert "[serve] service plan" in out and f"{n} replica(s) on h100-x" in out
    assert all(f"[serve]   replica{i}: devices=" in out for i in range(n))
    assert "[router] counters: {'shed': 0, 'expired': 0, 'retried': 0" in out
    assert "[router] terminal states: {'finished': 5}" in out
    assert "[serve]   tier 0: 2 done" in out and "policy=least_loaded" in out
    assert [r.out_tokens for r in reqs] == cli_plain
    if flags[1] == "2":
        assert n == 2 and [r.devices for r in router.replicas] == [[0], [1]]
        assert {e["replica"] for e in router.events if e["kind"] == "dispatch"} == {
            "replica0", "replica1"}


def test_serve_cli_dispatch_shortest_prefill(capsys, cli_plain):
    router, reqs = t_serve.main(CLI + ["--replicas", "2", "--cluster-size", "2",
                                       "--dispatch", "shortest_prefill"])
    out = capsys.readouterr().out
    assert router.config.dispatch == "shortest_prefill"
    assert "policy=shortest_prefill" in out and "policy=least_loaded" not in out
    assert [r.out_tokens for r in reqs] == cli_plain


def _schedule(tmp_path, events):
    from repro_torch.serving.faults import FaultEvent, FaultSchedule

    path = tmp_path / "chaos.json"
    FaultSchedule([FaultEvent(**e) for e in events], name="cli").save(str(path))
    return str(path)


def test_serve_cli_fault_schedule_single_engine(capsys, tmp_path, cli_plain):
    """A stall, a link degrade beside the stall's recover (scheduled events
    fire first), then a crash, replayed into the single engine: four
    replans, the tokens of the run without faults."""
    path = _schedule(tmp_path, [
        dict(step=1, kind="device_stall", device=1, factor=0.25, duration=1),
        dict(step=2, kind="link_degrade", link=(0, 1), factor=0.5),
        dict(step=3, kind="device_crash", device=1),
    ])
    engine, reqs = t_serve.main(CLI + ["--cluster-size", "2", "--fault-schedule", path])
    out = capsys.readouterr().out
    assert "[serve] chaos: replaying 'cli' (3 events, horizon 3 steps)" in out
    assert "[chaos] 4 injections" in out
    for status in ("stalled device 1", "recovered device 1", "degraded link (0, 1)",
                   "crashed device 1"):
        assert status in out
    assert engine.failed_devices == [1]
    assert [e["kind"] for e in engine.fault_log] == [
        "device_stall", "link_degrade", "recover", "device_crash"]
    assert [r.out_tokens for r in reqs] == cli_plain


def test_serve_cli_fault_schedule_with_replicas(capsys, tmp_path, cli_plain):
    """Replica 0's only device crashes mid-decode: the router retires it,
    retries its requests on replica 1, and every request finishes with the
    tokens of the run without faults."""
    path = _schedule(tmp_path, [dict(step=2, kind="device_crash", device=0)])
    router, reqs = t_serve.main(CLI + ["--replicas", "2", "--cluster-size", "2",
                                       "--fault-schedule", path])
    out = capsys.readouterr().out
    st = router.stats()
    assert st["counters"]["crashed_replicas"] == 1 and st["counters"]["retried"] >= 1
    assert st["finished_by_state"] == {"finished": 5}
    assert "[chaos] 1 injections" in out and "replica0: crashed" in out
    assert "replica_crash" in out and "retry" in out
    assert [r.out_tokens for r in reqs] == cli_plain


def test_serve_cli_fails_when_requests_are_stranded(capsys, tmp_path):
    """Both replicas' devices crash: their requests are queued for a retry
    no replica is left to take, and the CLI exits non-zero after printing
    the operator view, where it would otherwise report them as served."""
    path = _schedule(tmp_path, [dict(step=2, kind="device_crash", device=0),
                                dict(step=3, kind="device_crash", device=1)])
    with pytest.raises(SystemExit, match=r"5 of 5 requests reached no terminal state"):
        t_serve.main(CLI + ["--replicas", "2", "--cluster-size", "2", "--fault-schedule", path])
    out = capsys.readouterr().out
    assert "[router] terminal states: {}" in out and "[chaos] 2 injections" in out


def test_serve_cli_refuses_draft_with_replicas():
    with pytest.raises(SystemExit):
        t_serve.main(CLI + ["--replicas", "2", "--draft", "llama3.2-1b"])
