"""The port stands alone: every module of ``repro_torch`` imports with JAX
blocked, and no source under ``src/repro_torch/`` (nor ``chip_smoke.py``)
imports ``jax`` or anything of ``repro``."""

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
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    return [f for f in files if f.exists()]


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        # the serving path runs too: lazy imports inside it count
        "from repro_torch.launch.serve import main\n"
        "main(['--arch', 'llama3.2-1b', '--smoke', '--device', 'cpu', '--requests', '2',"
        " '--max-new-tokens', '2', '--method', 'etf', '--prefill-chunk', '2'])\n"
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
