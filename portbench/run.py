"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload qwen3-14b.chat --seed 7 --seconds 50 --trace 0

Run from the repository root, on a machine with as many CUDA cards as the
cell asks for (``BENCHMARK.json``).  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared with its limit, also the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the program (src/repro_torch) is not in this checkout", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import bench

    cell = bench.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.spec["chips"]:
        print(f"portbench: {cell.spec['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    bad = bench.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}: the port's runs may load no JAX "
              "and nothing of the JAX package", file=sys.stderr)
        return 3
    for line in bench.compared_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
