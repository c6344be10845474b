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
    _, tcfg, _, tp = models
    with pytest.raises(NotImplementedError):
        TServingEngine(tcfg, tp, h100_cluster(1), devices=CPU,
                       plan_cfg=TPlanConfig(method="etf"), draft_cfg=tcfg, draft_params=tp)


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


@pytest.mark.parametrize(
    "flag", [["--replicas", "2"], ["--draft", "llama3.2-1b"], ["--fault-schedule", "x.json"]],
)
def test_serve_cli_refuses_unported_flags(flag):
    with pytest.raises(SystemExit):
        t_serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", *flag])
