"""The port stands alone: every module of ``repro_torch`` imports with JAX
blocked, and no source under ``src/repro_torch/`` (nor ``chip_smoke.py``,
``time_grouped_gemm.py`` and the ``tests/_mrope_streams.py`` and
``tests/_torch_mesh_ranks.py`` they import) imports ``jax`` or anything of ``repro``."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_IMPORT = re.compile(
    r"^\s*(?:import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_)[\w.]*\s+import)",
    re.M,
)


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "time_grouped_gemm.py",
                                         ROOT / "tests" / "_mrope_streams.py",
                                         ROOT / "tests" / "_torch_mesh_ranks.py"]
    return [f for f in files if f.exists()]


def test_every_module_imports_with_jax_blocked(tmp_path):
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        # the trainer's and the planner tools' modules are among them
        "assert {'repro_torch.core.placeto', 'repro_torch.data.pipeline',"
        " 'repro_torch.launch.train', 'repro_torch.launch.calibrate_invariant'} <= set(names)\n"
        "assert {'repro_torch.train.' + m for m in ('checkpoint', 'compression', 'elastic',"
        " 'loop', 'optimizer', 'step', 'tree')} <= set(names)\n"
        # the mesh-sharded trainer's modules too
        "assert {'repro_torch.parallel.' + m for m in ('collectives', 'context', 'moe_parallel',"
        " 'sharding', 'vocab')} | {'repro_torch.launch.mesh', 'repro_torch.launch.dryrun'}"
        " <= set(names)\n"
        # and the launch tools: the counter, the roofline terms and the
        # finite difference
        "assert {'repro_torch.launch.roofline', 'repro_torch.launch.roofline_fd'} <= set(names)\n"
        # ...and they run: the train CLI (with a resume), the calibration
        # and a placeto plan
        "from repro_torch.launch.train import main as train_main\n"
        f"argv = ['--arch', 'llama3.2-1b', '--smoke', '--device', 'cpu', '--steps', '2',"
        f" '--checkpoint-every', '1', '--global-batch', '2', '--seq-len', '8',"
        f" '--checkpoint-dir', {str(tmp_path / 'ckpt')!r}]\n"
        "train_main(argv)\n"
        "train_main(argv[:6] + ['3'] + argv[7:])\n"
        "from repro_torch.launch.calibrate_invariant import main as cal_main\n"
        "cal_main(['--batches', '1,2', '--device', 'cpu'])\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.core.devices import h100_cluster\n"
        "from repro_torch.core.modelgraph import transformer_graph\n"
        "from repro_torch.core.placement import plan\n"
        "plan(transformer_graph(get_config('llama3.2-1b').smoke(), seq_len=16, granularity='block'),"
        " h100_cluster(2), method='placeto', placeto_iters=2, placeto_device='cpu')\n"
        # the serving path runs too: lazy imports inside it count
        "from repro_torch.launch.serve import main\n"
        "main(['--arch', 'llama3.2-1b', '--smoke', '--device', 'cpu', '--requests', '2',"
        " '--max-new-tokens', '2', '--method', 'etf', '--prefill-chunk', '2'])\n"
        # ...and the paged path
        "main(['--arch', 'llama3.2-1b', '--smoke', '--device', 'cpu', '--requests', '2',"
        " '--max-new-tokens', '2', '--method', 'etf', '--prefill-chunk', '2',"
        " '--kv-page-tokens', '4'])\n"
        # ...and speculative serving
        "main(['--arch', 'llama3.2-1b', '--smoke', '--device', 'cpu', '--requests', '2',"
        " '--max-new-tokens', '3', '--method', 'etf', '--prefill-chunk', '2',"
        " '--draft', 'llama3.2-1b', '--spec-tokens', '2'])\n"
        # ...and the multi-replica router
        "main(['--arch', 'llama3.2-1b', '--smoke', '--device', 'cpu', '--requests', '2',"
        " '--max-new-tokens', '2', '--method', 'etf', '--replicas', '2', '--cluster-size', '2'])\n"
        # ...and the MoE path
        "main(['--arch', 'qwen2-moe-a2.7b', '--smoke', '--device', 'cpu', '--requests', '2',"
        " '--max-new-tokens', '2', '--method', 'etf', '--prefill-chunk', '2'])\n"
        # ...and the SSM and hybrid families through the model facade, with
        # a fused step and paged KV
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models.model import build_model\n"
        "for arch in ('mamba2-130m', 'zamba2-2.7b'):\n"
        "    cfg = get_config(arch).smoke()\n"
        "    m = build_model(cfg)\n"
        "    p = m.init(torch.Generator().manual_seed(0), 'cpu')\n"
        "    toks = torch.ones((2, 5), dtype=torch.int32)\n"
        "    m.prefill(p, {'tokens': toks}, 16)\n"
        "    c = m.init_paged_cache(4, 8, 2, 'cpu')\n"
        "    m.fused_step(p, {'tokens': toks}, c, [0, 0], [5, 3],"
        " page_table=torch.tensor([[0, 1], [2, 3]]))\n"
        # ...and the model-level speculative loop, paged
        "    from repro_torch.models.speculative import spec_generate\n"
        "    spec_generate(m, p, m, p, [[1, 2, 3]], [3], spec_tokens=2, chunk=2, max_len=16,"
        " page_tokens=4)\n"
        # ...and the enc-dec and VLM families through the model facade,
        # paged and fused
        "for arch in ('seamless-m4t-large-v2', 'qwen2-vl-7b'):\n"
        "    cfg = get_config(arch).smoke()\n"
        "    m = build_model(cfg)\n"
        "    p = m.init(torch.Generator().manual_seed(0), 'cpu')\n"
        "    if cfg.family == 'encdec':\n"
        "        b = {'frames': torch.ones((2, 3, cfg.d_model)), 'tokens': toks}\n"
        "        _, c = m.prefill(p, b, 16)\n"
        "        pc = m.init_paged_cache(4, 8, 2, 'cpu')\n"
        "        m.prefill_chunked(p, b, 16, chunk=2, self_cache=pc['self'],"
        " page_table=torch.tensor([[0, 1], [2, 3]]))\n"
        "        m.fused_step(p, {'tokens': toks}, c, [0, 0], [5, 3])\n"
        "    else:\n"
        "        b = {'embeds': torch.ones((2, 5, cfg.d_model))}\n"
        "        m.prefill(p, b, 16)\n"
        "        c = m.init_paged_cache(4, 8, 2, 'cpu')\n"
        "        m.fused_step(p, b, c, [0, 0], [5, 3], page_table=torch.tensor([[0, 1], [2, 3]]))\n"
        "assert not [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " if sys.modules[m] is not None]\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 30


def test_no_source_imports_jax_or_the_reference():
    offenders = []
    for f in _sources():
        for m in _IMPORT.finditer(f.read_text()):
            offenders.append(f"{f.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders
    # and the scan does catch what it is meant to
    assert _IMPORT.search("from repro.models import layers")
    assert _IMPORT.search("import jax.numpy as jnp")
    assert not _IMPORT.search("from repro_torch.models import layers")
