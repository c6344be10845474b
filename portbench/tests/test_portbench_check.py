"""A whole run on the CPU at smoke size: the check passes a sound run
(dense KV, paged KV with shared prefixes, MoE), comes out false with the
timed path broken underneath (a token altered where it is produced, a step
that leaves the KV cache unchanged, half the batch left out), and the fp8
control reads wider gaps than the program and comes out not correct by
the same rule.  The harness's look for a card and its module check are
skipped; the rest is a run as on the card."""

import pytest
import torch

from portbench.tests._tiny import tiny_cell
from portbench.harness import bench, program

SEED = 2**31 + 77


def _run(cell, traced=False, **kw):
    torch.set_num_threads(2)
    return bench.run_cell(cell, SEED, 1.5, traced, device="cpu", log=lambda m: None, **kw)


@pytest.mark.parametrize("config,mix", [("qwen3-14b", "chat"), ("qwen2-moe-a2.7b", "chat"),
                                        ("qwen3-14b", "sysprompt-open"),
                                        ("qwen2-moe-a2.7b", "docs")])
def test_sound_run_is_correct(config, mix):
    res = _run(tiny_cell(config, mix))
    assert res["correct"], res["check"]
    assert res["check"]["max_gap"]["value"] < 1e-4
    assert res["attempted"] > 0 and res["failed"] == 0
    cell = tiny_cell(config, mix)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "check"


def test_traced_run_reads_the_engine_layers():
    res = _run(tiny_cell("qwen3-14b", "sysprompt-open"), traced=True)
    m = res["metrics"]
    assert res["correct"]
    assert 0 < m["prefix_hit_share"]["value"] < 100
    assert m["queue_wait_ms_p95"]["value"] >= 0
    assert m["step_host_ms.long"]["value"] > 0
    # no card: the device readers find nothing, and say nothing
    assert "mfu" not in m and "device_idle_share.open" not in m


def _patch_forward(monkeypatch, wrap):
    build = program.build_engine

    def build_broken(*a, **kw):
        eng = build(*a, **kw)
        fwd = eng.executor.forward
        eng.executor.forward = lambda *x, **y: wrap(fwd, *x, **y)
        return eng

    monkeypatch.setattr(program, "build_engine", build_broken)


def test_a_token_altered_where_produced_fails(monkeypatch):
    calls = {"n": 0}

    def wrap(fwd, tokens, *a, **kw):
        logits, caches = fwd(tokens, *a, **kw)
        calls["n"] += 1
        if calls["n"] % 7 == 0:        # now and then every decode row's best token moves
            logits = logits.clone()
            best = logits[:, 0].argmax(-1)
            logits[torch.arange(logits.shape[0]), 0, (best + 1) % logits.shape[-1]] += 1e3
        return logits, caches

    _patch_forward(monkeypatch, wrap)
    res = _run(tiny_cell("qwen3-14b", "chat"))
    assert not res["correct"] and res["check"]["max_gap"]["value"] > 1e-3


def test_a_step_that_leaves_the_cache_unchanged_fails(monkeypatch):
    def wrap(fwd, tokens, caches, *a, **kw):
        saved = [[{k: t.clone() for k, t in layer.items()} for layer in st] for st in caches]
        logits, new = fwd(tokens, caches, *a, **kw)
        if torch.as_tensor(tokens).shape[1] == 1:          # decode steps write nothing
            for st, st_saved in zip(new, saved):
                for layer, layer_saved in zip(st, st_saved):
                    for k in ("k", "v"):
                        layer[k].copy_(layer_saved[k])
        return logits, new

    _patch_forward(monkeypatch, wrap)
    res = _run(tiny_cell("qwen2-moe-a2.7b", "chat"))
    assert not res["correct"]


def test_half_the_batch_left_out_fails(monkeypatch):
    def wrap(fwd, tokens, *a, **kw):
        ql = kw.get("q_lens")
        if ql is not None:
            ql = torch.as_tensor(ql).clone()
            ql[ql.shape[0] // 2:] = 0
            kw["q_lens"] = ql
        return fwd(tokens, *a, **kw)

    _patch_forward(monkeypatch, wrap)
    res = _run(tiny_cell("qwen3-14b", "chat"))
    assert not res["correct"]


@pytest.mark.parametrize("config", ["qwen3-14b", "qwen2-moe-a2.7b"])
def test_the_fp8_control_reads_wider_gaps(config):
    res = _run(tiny_cell(config, "chat"), control=True)
    r = res["readings"]
    assert res["correct"] and r["max_gap"] < 1e-4
    assert r["control_max_gap"] > 100 * max(r["max_gap"], 1e-6)
    assert r["control_mismatch_share"] > 0
    # judged by the program's own rule and the cell's limit, the control is not correct
    assert r["control_correct"] is False
    assert r["control_max_gap"] > res["check"]["max_gap"]["limit"]
