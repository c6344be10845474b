"""The benchmark's files: what they may import, ``BENCHMARK.json`` against
the rules a check holds it to, every cell loadable with a reader for each
of its metrics, a cell added by new files alone, and the command's
refusals (no card; a directory without the program)."""

import ast
import json
import math
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench.tests._tiny import ROOT
from portbench.harness import bench

BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_no_jax_and_no_jax_package_anywhere():
    for path in BENCH.rglob("*.py"):
        tops = set(_top_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if "tests" not in path.relative_to(BENCH).parts:
            # nothing reads the reference's benchmarks/ folder
            assert not re.search(r"\bbenchmarks\b", path.read_text()), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_top_imports(path)), path
    # the program is imported by one harness module only
    users = [p.name for p in BENCH.rglob("*.py")
             if "repro_torch" in set(_top_imports(p)) and "tests" not in p.parts]
    assert users == ["program.py"]


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", types.ModuleType("x"))
    base = set(bench.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("jaxlib.fake"))
    assert "jaxlib" in bench.forbidden_modules()
    assert "repro_torch_lookalike" not in bench.forbidden_modules()
    assert base <= set(bench.forbidden_modules())


def test_benchmark_json_keeps_the_contract():
    bj = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bj) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"}
    assert bj["paths"] == ["portbench"] and bj["command"] == ["python3", "portbench/run.py"]
    assert isinstance(bj["run_seconds"], int) and 1 <= bj["run_seconds"] <= 51
    rs = bj["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in bj["configs"]}
    for c in bj["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        assert 1 <= len(c["why"]) <= 200
    cells = {w["name"]: w for w in bj["workloads"]}
    assert len(cells) == len(bj["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in bj["workloads"]}
    assert len(pairs) == len(cells)
    for w in bj["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (BENCH / "mixes" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    assert sum(w["chips"] == 4 for w in bj["workloads"]) <= max(1, len(cells) // 4)
    assert {c for c in configs} == {w["config"] for w in bj["workloads"]}
    e2e = {m["name"]: m for m in bj["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bj["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= set(cells)
        assert bench.reader_path("end_to_end", m["name"]).is_file()
    names = [m["name"] for m in bj["end_to_end"] + bj["per_layer"]]
    assert len(names) == len(set(names))
    for m in bj["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert bench.reader_path("metrics", m["name"]).is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for w in m.get("workloads", cells):
            # the end-to-end metric it moves is reported in each of its cells
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        assert any(w in m.get("workloads", cells) for m in bj["per_layer"])
        assert any(w in m.get("workloads", cells) for m in bj["end_to_end"] if m["name"] != "setup_s")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_loads_and_its_readers_say_nothing_on_an_empty_run():
    from portbench.harness.driver import Window

    bj = json.loads((ROOT / "BENCHMARK.json").read_text())
    empty = bench.RunRecord(cfg={}, mix={}, window=Window(0.0, 1.0, 1.0), recs=[], setup_s=1.0)
    for w in bj["workloads"]:
        cell = bench.load_cell(w["name"])
        assert cell.cfg["name"] == w["config"] and cell.limits["max_gap"]["limit"] > 0
        for m in cell.per_layer:
            assert bench.reader("metrics", m["name"])(empty) is None, m["name"]
        for m in cell.end_to_end:
            v = bench.reader("end_to_end", m["name"])(empty)
            assert v is None or (m["name"] == "setup_s" or m["name"].startswith("output_tok_s"))
            assert v is None or not math.isnan(v)


def test_a_cell_added_by_files_alone_loads(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bj = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((BENCH / "mixes" / "chat.json").read_text())
    mix.update(clients=16, engine=dict(mix["engine"], slots=16))
    (root / "portbench" / "mixes" / "chat16.json").write_text(json.dumps(mix))
    (root / "portbench" / "limits" / "qwen3-14b.chat16.json").write_text(
        json.dumps({"max_gap": {"limit": 0.5}}))
    (root / "portbench" / "metrics" / "steps_per_s.py").write_text(
        "def read(run):\n    return len(run.steps) / (run.window.end - run.window.start) if run.steps else None\n")
    bj["workloads"].append({"name": "qwen3-14b.chat16", "config": "qwen3-14b", "traffic": "chat16",
                            "chips": 1, "why": "16 callers"})
    bj["per_layer"].append({"name": "steps_per_s", "unit": "1/s", "better": "higher",
                            "source": "program_span", "layer": "serving/engine.py",
                            "moves": "output_tok_s", "workloads": ["qwen3-14b.chat16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bj))
    cell = bench.load_cell("qwen3-14b.chat16", root=root)
    assert cell.mix["clients"] == 16 and cell.limits["max_gap"]["limit"] == 0.5
    assert [m["name"] for m in cell.per_layer if m["name"] == "steps_per_s"] == ["steps_per_s"]
    assert bench.reader("metrics", "steps_per_s", root=root) is not None
    # a metric split by cells is read by its base's reader, unless it has its own
    assert bench.reader_path("metrics", "steps_per_s.docs", root=root).name == "steps_per_s.py"
    own = root / "portbench" / "metrics" / "steps_per_s.docs.py"
    own.write_text("def read(run):\n    return 1.0\n")
    assert bench.reader_path("metrics", "steps_per_s.docs", root=root) == own


def _run(args, cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_the_command_refuses_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(["--workload", "qwen3-14b.chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
               tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for a machine without one")
    out = _run(["--workload", "qwen3-14b.chat", "--seed", str(2**31 + 5), "--seconds", "1",
                "--trace", "0"], ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "CUDA" in out.stderr
