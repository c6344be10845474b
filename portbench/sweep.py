"""Find an open-loop cell's knee once, by a sweep: the cell at each offered
rate, in one process, a short window each and no check.  Prints one JSON
line a rate: requests due and completed in the window, the queue at its
start and end, the TTFT and queue-wait tails and the output rate.  The knee
is the highest rate whose queue does not grow through the window; the
cell's mix then states 0.8 of it as a number.

    python3 portbench/sweep.py --workload qwen3-14b.sysprompt-open --rates 2 4 6 8 --seconds 20
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
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness import bench

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload)
    for rate in args.rates:
        cell.mix = dict(cell.mix, rate_per_s=rate)
        t0 = time.perf_counter()
        res = bench.run_cell(cell, args.seed, args.seconds, False, t_start=t0, reference=False)
        r = res["readings"]
        print(json.dumps({
            "rate_per_s": rate, "due": res["attempted"], "completed": r["completed"],
            "queue_at_start": r["queue_at_start"], "queue_at_end": r["queue_at_end"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
        }), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
