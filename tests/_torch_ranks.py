"""Start processes for the mesh tests: gloo CPU ranks of the port, and the
JAX reference on forced host devices.

* :func:`start_ranks` runs ``module:function`` (importable from ``tests/``)
  as rank r of ``world`` fresh interpreters, joined by a file store under
  the test's ``tmp_path`` (no TCP port to race another worker), each on one
  CPU thread; ``function(rank, world, *args)`` returns what rank r hands
  back (pickled).
* :func:`start_reference` runs a script that reads ``ARGS`` and sets
  ``OUT`` under ``--xla_force_host_platform_device_count=n`` (the count
  must be set before JAX starts, so it runs out of process).

Both start at once and are joined by ``.results()``, so a test can run the
reference and the port side by side.  A process that fails, or outlives its
timeout (it is killed), fails the test with the end of its output.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
import time
import uuid
from pathlib import Path
from typing import Any, List

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TESTS = ROOT / "tests"

_RANK_BOOT = """
import pickle, sys, importlib
import torch
torch.set_num_threads(1)
rank, world, store, target, argfile, outfile = sys.argv[1:]
from repro_torch.launch.mesh import init_ranks
init_ranks(int(rank), int(world), 'file://' + store, backend='gloo', device_type='cpu')
module, name = target.split(':')
with open(argfile, 'rb') as f:
    args = pickle.load(f)
out = getattr(importlib.import_module(module), name)(int(rank), int(world), *args)
with open(outfile, 'wb') as f:
    pickle.dump(out, f)
torch.distributed.destroy_process_group()
"""

_REF_BOOT = """
import pickle, sys
with open(sys.argv[1], 'rb') as f:
    ARGS = pickle.load(f)
OUT = None
{body}
with open(sys.argv[2], 'wb') as f:
    pickle.dump(OUT, f)
"""


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(TESTS), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONWARNINGS"] = "ignore"
    env.update(extra or {})
    return env


class _Procs:
    def __init__(self, what: str, timeout: float):
        self.what, self.timeout, self.t0 = what, timeout, time.monotonic()
        self.procs: List = []          # (Popen, out pickle, log file)

    def _spawn(self, argv, outfile: Path, log: Path, env):
        with open(log, "w") as f:
            p = subprocess.Popen(argv, env=env, stdout=f, stderr=subprocess.STDOUT)
        self.procs.append((p, outfile, log))

    def results(self) -> List[Any]:
        failed = []
        for p, _, log in self.procs:
            left = max(self.timeout - (time.monotonic() - self.t0), 1.0)
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                for q, _, _ in self.procs:
                    q.kill()
                    q.wait()
                failed.append(f"timed out after {self.timeout} s")
            if p.returncode != 0:
                failed.append(f"exit {p.returncode}:\n{log.read_text()[-4000:]}")
        if failed:
            raise AssertionError(f"{self.what}: " + "\n---\n".join(failed))
        out = []
        for _, outfile, _ in self.procs:
            with open(outfile, "rb") as f:
                out.append(pickle.load(f))
        return out


def _dir(tmp_path) -> Path:
    d = Path(tmp_path) / uuid.uuid4().hex[:8]
    d.mkdir(parents=True)
    return d


def start_ranks(world: int, target: str, tmp_path, *args, timeout: float = 90) -> _Procs:
    """``world`` gloo CPU ranks each running ``target`` (``"module:fn"``)."""
    d = _dir(tmp_path)
    with open(d / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    procs = _Procs(f"{world} ranks of {target}", timeout)
    for r in range(world):
        procs._spawn(
            [sys.executable, "-c", _RANK_BOOT, str(r), str(world), str(d / "store"), target,
             str(d / "args.pkl"), str(d / f"out{r}.pkl")],
            d / f"out{r}.pkl", d / f"log{r}.txt", _env())
    return procs


def start_reference(n_devices: int, body: str, tmp_path, args: Any, *, timeout: float = 90) -> _Procs:
    """The reference's ``body`` (reads ``ARGS``, sets ``OUT``) on
    ``n_devices`` forced CPU devices."""
    d = _dir(tmp_path)
    with open(d / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    procs = _Procs(f"the reference on {n_devices} devices", timeout)
    code = _REF_BOOT.format(body=textwrap.dedent(body))
    env = _env({"XLA_FLAGS": f"--xla_force_host_platform_device_count={n_devices}",
                "JAX_PLATFORMS": "cpu"})
    procs._spawn([sys.executable, "-c", code, str(d / "args.pkl"), str(d / "out.pkl")],
                 d / "out.pkl", d / "log.txt", env)
    return procs
