"""Time one checkout's grouped-GEMM kernel at qwen2-moe's four main-path
shapes, so that two versions can be compared on one card in one call.

    python3 time_grouped_gemm.py [--tree DIR] [--label NAME]

``--tree`` is the root of a checkout of this repository (default: this
one); its ``src/repro_torch`` kernel is built and timed with the helpers
of its own ``chip_smoke.py`` (the inputs, the L2-flushed CUDA-event timing
and the bound), bf16, gate/up (K 2048, N 1408) and down (K 1408, N 2048)
at decode (M = 32) and chunk (M = 2048) routing over 64 experts.  Beside
each kernel time: ``torch._grouped_mm`` on the same inputs (a yardstick,
never called by the port), the least time the card could take, a plain
read of the same number of bytes under the same timing (``torch.sum`` over
a bf16 tensor that large: what the L2 flush and the timing leave of the
card's memory rate), and the host time of one call of each.  Prints the
card (``nvidia-smi`` name and power limit) and one JSON line of results.
Run the versions in turns (parent, change, change, parent): each process
builds its tree's kernels once.  Needs one CUDA card; without one it exits
non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch


def host_us(dev, fn, iters=200) -> float:
    """Mean host time of one call, the card kept busy so no call waits."""
    fn()
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(40_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    return t / iters * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_grouped_gemm: no CUDA device")
    tree = Path(args.tree).resolve()
    spec = importlib.util.spec_from_file_location("tree_chip_smoke", tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)          # puts the tree's src/ first on sys.path
    gg = cs.gg
    if not str(Path(gg.__file__).resolve()).startswith(str(tree)):
        sys.exit(f"time_grouped_gemm: imported {gg.__file__}, not the tree's own kernel")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cs._build.load()
    build_s = time.perf_counter() - t0
    print(f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi: {cs.nvidia_smi_line()}", flush=True)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    rows = {}
    for proj, (k, n) in cs.GG_SHAPES.items():
        for routing, tokens in cs.GG_ROUTING.items():
            inp = cs.gg_inputs(dev, torch.bfloat16, sizes=cs.routed_sizes(tokens), k=k, n=n)
            byts, flops = cs.gg_work(inp)
            b_ms, b_by = cs.bound(byts, flops, torch.bfloat16)
            label, lib = cs.gg_library(inp)
            run = lambda: cs.run_gg(gg.grouped_gemm, inp)  # noqa: E731
            cs.within(run(), cs.run_gg(gg.grouped_gemm_plain, inp))
            same_bytes = torch.ones(byts // 2, dtype=torch.bfloat16, device=dev)
            rows[f"{proj}_{routing}"] = r = dict(
                ms=cs.time_ms(dev, run, flush=flush),
                library_ms=cs.time_ms(dev, lib, flush=flush), library=label,
                read_ms=cs.time_ms(dev, lambda: same_bytes.sum(), flush=flush),
                bound_ms=b_ms, bound_by=b_by, host_us=host_us(dev, run),
                library_host_us=host_us(dev, lib),
            )
            print(f"[time] {proj} {routing}: kernel {r['ms']:.4f} ms, {label} "
                  f"{r['library_ms']:.4f} ms, a read of the same {byts / 1e6:.1f} MB "
                  f"{r['read_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}); host a call: kernel "
                  f"{r['host_us']:.1f} us, {label} {r['library_host_us']:.1f} us", flush=True)
            del inp, same_bytes
    print(json.dumps({"tree": args.label or str(tree), "build_s": build_s, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
