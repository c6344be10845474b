"""The port's examples (``repro_torch.examples``) held to the reference's
scripts in ``examples/``.

- quickstart: the same graph and GCOF counts; msct, getf and round_robin
  give the reference's placements and makespans exactly; moirai, at a
  short MILP limit, is no worse than the best heuristic in either package,
  and the two agree wherever both land on the same route.
- heterogeneous placement: msct and getf equal over the three paper
  graphs and both clusters; placeto equal under fixed sampled choices
  (``jax.random`` is not reproduced: see ``test_torch_placeto.py``);
  moirai as in the quickstart.
- serve demo: the reference's weights carried over give the reference
  engine's greedy tokens; request 99 after a device failure gets the
  tokens of a fresh engine.
- train demo: it runs, writes its metrics and checkpoints, its loss falls,
  and its first loss sits beside the reference's.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.placeto as t_placeto
from repro.configs import get_config
from repro.core import CostModel, get_cluster, plan
from repro.core.devices import inter_server_cluster, intra_server_cluster, tpu_slice_cluster
from repro.core.fusion import DEFAULT_RULES, gcof
from repro.core.modelgraph import paper_graph, transformer_graph
from repro.core.simulate import evaluate, simulate
from repro.models.model import build_model
from repro.serving.engine import Request, ServingEngine
from repro_torch.convert import params_from_jax
from repro_torch.core.devices import (
    h100_cluster,
    inter_server_cluster as t_inter_server_cluster,
    intra_server_cluster as t_intra_server_cluster,
)
from repro_torch.examples import heterogeneous_placement, quickstart, serve_demo, train_demo
from repro_torch.launch.serve import serving_config
from repro_torch.serving.engine import Request as TRequest, ServingEngine as TServingEngine

CPU = torch.device("cpu")
HEURISTICS = ("msct", "getf")
# moirai's MILP limit here: too short for it to reach its gap on these
# graphs, so both packages fall back to their heuristic envelope
SHORT_LIMIT = 1.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moirai_held(got, ref, got_best, ref_best):
    """Each package's moirai no worse than its best heuristic; equal
    makespans where both took the same route and that route is a
    heuristic's (deterministic) or an MILP that reached its gap."""
    (g_res, g_mk), (r_res, r_mk) = got, ref
    assert g_mk <= got_best * (1 + 1e-12) and r_mk <= ref_best * (1 + 1e-12)
    if g_res.method == r_res.method and (
        "envelope" in g_res.method or (g_res.status, r_res.status) == ("optimal", "optimal")
    ):
        assert g_mk == pytest.approx(r_mk, rel=1e-12)


# ---------------------------------------------------------------- quickstart


def _reference_quickstart(methods, time_limit):
    """``examples/quickstart.py``'s loop, returning what it prints."""
    cluster = get_cluster("inter_server")
    cost = CostModel(cluster)
    graph = transformer_graph(get_config("llama3.2-1b"), seq_len=2048, granularity="fine")
    coarse = gcof(graph, DEFAULT_RULES)
    out = {}
    for method in methods:
        res = plan(graph, cluster, method=method, time_limit=time_limit, mip_rel_gap=0.05)
        mk = simulate(coarse, {nid: res.placement[node.fused_ids[0]]
                               for nid, node in coarse.nodes.items()}, cost).makespan
        out[method] = (res, mk)
    return graph, coarse, out


def test_quickstart_matches_reference(capsys):
    methods = ("moirai", "msct", "getf", "round_robin")
    got = quickstart.run(methods, time_limit=SHORT_LIMIT)
    printed = capsys.readouterr().out
    graph, coarse, ref = _reference_quickstart(methods, SHORT_LIMIT)
    assert (len(got["graph"]), got["graph"].num_edges(), len(got["coarse"])) == (
        len(graph), graph.num_edges(), len(coarse)) == (307, 386, 258)
    assert "model graph: 307 operators, 386 data flows" in printed
    assert "after GCOF:  258 operators (84%)" in printed
    res = got["results"]
    for m in ("msct", "getf", "round_robin"):
        assert res[m][0].placement == ref[m][0].placement
        assert res[m][1] == ref[m][1]
        assert f"{m:12s} makespan={ref[m][1]*1e3:8.3f} ms" in printed
    # the reference's figures (examples/quickstart.py on the CPU)
    assert [round(res[m][1] * 1e3, 3) for m in ("msct", "getf", "round_robin")] == [
        818.006, 570.399, 2773.116]
    _moirai_held(res["moirai"], ref["moirai"], min(res[m][1] for m in HEURISTICS),
                 min(ref[m][1] for m in HEURISTICS))


def test_quickstart_main_takes_no_device():
    """Host code only: it has no --device flag to refuse."""
    with pytest.raises(SystemExit) as e:
        quickstart.main(["--device", "cpu"])
    assert e.value.code == 2


# ------------------------------------------------------ heterogeneous placement

CLUSTERS = ((inter_server_cluster, t_inter_server_cluster),
            (intra_server_cluster, t_intra_server_cluster))


def _reference_rows(methods, *, time_limit, placeto_iters):
    """``examples/heterogeneous_placement.py``'s loop, its makespans."""
    rows = {}
    for make, _ in CLUSTERS:
        cluster = make()
        cm = CostModel(cluster)
        for model in heterogeneous_placement.MODELS:
            g = paper_graph(model)
            row = rows[(cluster.name, model)] = {}
            for method in methods:
                res = plan(g, cluster, method=method, coarsen=True, time_limit=time_limit,
                           mip_rel_gap=0.05, placeto_iters=placeto_iters)
                row[method] = (res, evaluate(g, res.placement, cm,
                                             runtime_fusion_rules=DEFAULT_RULES))
    return rows


def test_heterogeneous_placement_matches_reference(capsys):
    methods = ("msct", "getf", "moirai")
    got = heterogeneous_placement.run([t() for _, t in CLUSTERS], methods=methods,
                                      time_limit=SHORT_LIMIT, placeto_device=CPU)
    printed = capsys.readouterr().out
    ref = _reference_rows(methods, time_limit=SHORT_LIMIT, placeto_iters=40)
    assert set(got) == set(ref) and len(got) == 6
    assert "=== inter-server ===" in printed and "=== intra-server ===" in printed
    for key, row in ref.items():
        for m in HEURISTICS:
            assert got[key][m][0].placement == row[m][0].placement, (key, m)
            assert got[key][m][1] == row[m][1], (key, m)
            assert f"{m}={row[m][1]*1e3:8.2f}ms" in printed
        _moirai_held(got[key]["moirai"], row["moirai"],
                     min(got[key][m][1] for m in HEURISTICS),
                     min(row[m][1] for m in HEURISTICS))


def _fixed_sampler(record):
    """Choices that depend only on the call's index and the logits' shape:
    the same sequence in both packages."""
    def choose(shape):
        n, k = shape
        rng = np.random.default_rng(1000 + len(record))
        record.append(shape)
        return rng.integers(0, k, size=n)
    return choose


def test_heterogeneous_placement_placeto_matches_under_fixed_choices(monkeypatch):
    iters = 2
    j_calls, t_calls = [], []
    j_choose, t_choose = _fixed_sampler(j_calls), _fixed_sampler(t_calls)
    # the reference's sampler and step run eagerly so the fake sampler sees
    # concrete logits
    monkeypatch.setattr(jax, "jit", lambda f: f)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.asarray(
                            j_choose(np.asarray(logits).shape), jnp.int32))
    monkeypatch.setattr(t_placeto, "_sample",
                        lambda logits, generator: t_choose(tuple(logits.shape)))
    got = heterogeneous_placement.run([t() for _, t in CLUSTERS], methods=("placeto",),
                                      placeto_iters=iters, placeto_device=CPU)
    ref = _reference_rows(("placeto",), time_limit=SHORT_LIMIT, placeto_iters=iters)
    assert t_calls == j_calls and len(t_calls) == 6 * iters * 8
    for key, row in ref.items():
        assert got[key]["placeto"][0].placement == row["placeto"][0].placement, key
        assert got[key]["placeto"][1] == row["placeto"][1], key


# ---------------------------------------------------------------- serve demo


@pytest.fixture(scope="module")
def demo_models():
    """The reference's demo weights (``build_model(cfg).init(PRNGKey(0))``)
    and their copy for the port."""
    jcfg = get_config("llama3.2-1b").smoke()
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, serving_config("llama3.2-1b", smoke=True), jp, tp


def _reference_demo(jcfg, jp, n_slices, fail=False):
    """The engine of ``examples/serve_demo.py``: its 8 requests' tokens,
    and with ``fail`` request 99's after device 0 fails."""
    engine = ServingEngine(jcfg, jp, tpu_slice_cluster(n_slices=n_slices, heterogeneous=True),
                           slots=4, max_len=128, eos_id=-1)
    reqs = [Request(rid=i, prompt=[1 + i, 2, 3, 4], max_new_tokens=8) for i in range(8)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    r99 = None
    if fail:
        engine.on_device_failure(0)
        r99 = Request(rid=99, prompt=[1, 2, 3, 4], max_new_tokens=8)
        engine.submit(r99)
        engine.run_until_drained()
    return [r.out_tokens for r in reqs], r99 and r99.out_tokens


def test_serve_demo_matches_reference(demo_models, capsys):
    jcfg, tcfg, jp, tp = demo_models
    want, _ = _reference_demo(jcfg, jp, n_slices=1)
    reqs = serve_demo.demo_requests()
    out = serve_demo.demo(tcfg, tp, h100_cluster(1, heterogeneous=True), [CPU], reqs)
    printed = capsys.readouterr().out
    assert [r.out_tokens for r in reqs] == want
    assert all(r.done and len(r.out_tokens) == 8 for r in reqs)
    assert out["after_failure"] is None and "simulating failure" not in printed
    assert "1 stage(s) on 1 device(s)" in printed and "stage latency stats:" in printed
    assert f"req 0: prompt=[1, 2, 3, 4] -> {want[0]}" in printed


def test_serve_demo_recovers_from_a_device_failure(demo_models, capsys):
    """Two modeled devices (the second at half speed) on the CPU: device 0
    fails, the engine replans on device 1, and request 99 gets the tokens
    of a fresh engine that saw no failure, and of the reference's demo
    engine on two slices taking the same failure."""
    jcfg, tcfg, jp, tp = demo_models
    want, want99 = _reference_demo(jcfg, jp, n_slices=2, fail=True)
    reqs = serve_demo.demo_requests()
    out = serve_demo.demo(tcfg, tp, h100_cluster(2, heterogeneous=True), [CPU], reqs)
    printed = capsys.readouterr().out
    r99 = out["after_failure"]
    assert out["engine"].failed_devices == [0]
    assert "simulating failure of device 0" in printed
    assert f"after replan (1 devices): req 99 -> {r99.out_tokens}" in printed
    fresh = TServingEngine(tcfg, tp, h100_cluster(1, heterogeneous=True), devices=[CPU],
                           slots=4, max_len=128, eos_id=-1)
    alone = TRequest(rid=99, prompt=[1, 2, 3, 4], max_new_tokens=8)
    fresh.submit(alone)
    fresh.run_until_drained()
    assert r99.done and r99.out_tokens == alone.out_tokens == want99
    assert [r.out_tokens for r in reqs] == want


def test_serve_demo_main_on_cpu(capsys):
    out = serve_demo.main(["--device", "cpu"])
    assert out["engine"].cluster.name == "h100-x1" and out["after_failure"] is None
    assert all(r.done and len(r.out_tokens) == 8 for r in out["requests"])
    assert "placement via " in capsys.readouterr().out


# ---------------------------------------------------------------- train demo

TINY = dict(steps=20, d_model=64, layers=2, seq=32, batch=4, vocab=256)
# both first losses sit near ln(vocab) from their own random init: within
# 2% of it of each other
FIRST_LOSS_TOL = 0.02


def test_train_demo_runs_and_learns(tmp_path, capsys):
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in TINY.items()]
    out = train_demo.main(argv + ["--device", "cpu", "--out", str(tmp_path)])
    assert out["steps_run"] == TINY["steps"] and out["final_loss"] < out["first_loss"]
    assert all(math.isfinite(x) for x in out["losses"])
    assert f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f}" in capsys.readouterr().out
    metrics = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(metrics) == 2                                    # steps 0 and 10
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000010", "step_00000020"]

    from repro.data.pipeline import DataConfig
    from repro.train.loop import TrainConfig, train

    # examples/train_demo.py's config surgery on the reference's config
    d = TINY["d_model"]
    jcfg = dataclasses.replace(get_config("llama3.2-1b").smoke(), n_layers=TINY["layers"],
                               d_model=d, n_heads=8, n_kv_heads=4, head_dim=d // 8,
                               d_ff=4 * d, vocab_size=TINY["vocab"])
    ref = train(jcfg, DataConfig(vocab_size=TINY["vocab"], seq_len=TINY["seq"],
                                 global_batch=TINY["batch"]),
                TrainConfig(steps=2, checkpoint_every=10,
                            checkpoint_dir=str(tmp_path / "ref_ckpt")))
    ln_v = math.log(TINY["vocab"])
    assert abs(out["first_loss"] - ref["first_loss"]) <= FIRST_LOSS_TOL * ln_v
    assert abs(out["first_loss"] - ln_v) <= FIRST_LOSS_TOL * ln_v


# ------------------------------------------------------- no card, no quiet fallback


@pytest.mark.parametrize("module", [heterogeneous_placement, serve_demo, train_demo],
                         ids=["heterogeneous_placement", "serve_demo", "train_demo"])
def test_device_cuda_without_a_card_exits_non_zero(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device") as e:
        module.main(["--device", "cuda"])
    assert e.value.code not in (0, None)
