"""Read the numbers a cell's limits are set from, in one process: for each
seed, one run of the cell at its own size and load (a short window) with
the program checked against the reference, and the control (the reference
in fp8, in the program's place) read at the same positions.  Prints one
JSON line a seed.  The benchmark's own runs never run the control.

    python3 portbench/calibrate.py --workload qwen3-14b.chat --seconds 10 --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="the first this many seeds also read the control")
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness import bench

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        res = bench.run_cell(cell, seed, args.seconds, bool(args.trace), t_start=t0,
                             control=i < args.control_seeds)
        res["seed"] = seed
        res["run_s"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
