"""Smoke-size cells for the CPU tests: the real configuration and mix
files with every size cut down, float32, on the CPU."""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.harness import bench  # noqa: E402


def load(kind: str, name: str) -> dict:
    with open(ROOT / "portbench" / kind / f"{name}.json") as f:
        return json.load(f)


def tiny_cfg(name: str) -> dict:
    cfg = load("configs", name)
    cfg.update(hidden_size=128, num_attention_heads=4, head_dim=32, num_hidden_layers=2,
               vocab_size=512, torch_dtype="float32")
    if cfg["model_type"] == "qwen3":
        cfg.update(num_key_value_heads=2, intermediate_size=256)
    else:
        cfg.update(num_key_value_heads=4, num_experts=6, moe_intermediate_size=64,
                   shared_expert_intermediate_size=128)
        cfg["port"] = dict(cfg["port"], experts_padded=8)
    return cfg


def tiny_mix(name: str) -> dict:
    m = load("mixes", name)
    if m["loop"] == "closed":
        m.update(clients=8, warmup_steps=4, check_served_tokens=200,
                 prompt=dict(m["prompt"], min=8, max=120, **({"median": 40} if "median" in m["prompt"] else {})),
                 output=dict(m["output"], min=4, max=24, **({"median": 10} if "median" in m["output"] else {})),
                 engine=dict(m["engine"], slots=8, max_len=160, prefill_chunk=16))
    else:
        m.update(rate_per_s=20, warmup_s=0.3, check_served_tokens=120,
                 shared_prefix=dict(m["shared_prefix"], tokens=64),
                 prompt=dict(m["prompt"], min=8, max=40), output=dict(m["output"], min=4, max=12),
                 engine=dict(m["engine"], slots=8, max_len=128, prefill_chunk=16, kv_page_tokens=16))
    return m


def tiny_cell(config: str, mix: str, limit: float = 1e-3) -> bench.Cell:
    bj = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = f"{config}.{mix}"

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return bench.Cell(
        name=name, spec={"chips": 1}, cfg=tiny_cfg(config), mix=tiny_mix(mix),
        limits={"max_gap": {"limit": limit}},
        end_to_end=[m for m in bj["end_to_end"] if mine(m)],
        per_layer=[m for m in bj["per_layer"] if mine(m)],
    )
