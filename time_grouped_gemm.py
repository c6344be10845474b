"""Time one checkout's grouped-GEMM kernel at qwen2-moe's four main-path
shapes, or its SSD-scan or RMSNorm kernel, so that two versions can be
compared on one card in one call.

    python3 time_grouped_gemm.py [--tree DIR] [--label NAME]
                                 [--kernel grouped_gemm|ssd_scan|rmsnorm]

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

``--kernel ssd_scan`` times the SSD chunked scan instead, bf16, L2 flushed,
with the tree's own ``ssd_inputs``, ``ssd_work`` and ``time_ms``: each
model's fused chunk (8 rows × 64 tokens, chunk 128, the state carried and
updated in place: mamba2-130m H 24 × P 64 × N 128, zamba2-2.7b H 80 ×
P 64 × N 64) and mamba2's multi-chunk prefill (2 rows × 512 tokens, four
chunks, a carried state), each checked against the plain version first,
beside its bound and a read of the same bytes.

``--kernel rmsnorm`` times RMSNorm, bf16, at every shape of
:data:`RMS_SHAPES` back to back (no L2 flush: on the main path x was
written by the op just before), each checked against the plain version
first, beside the plain version, ``F.rms_norm`` (a yardstick), the bytes
bound, a copy and a read of the same bytes, and the floor: an empty kernel
(a spin of 0 cycles) under the same timing.  ``chip_smoke.py`` times the
same shapes with the same function, :func:`time_rms`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

# RMSNorm's main-path shapes, (rows, d, path): chunk = one fused [8, 64]
# step of 8 slots, decode = [8, 1]; qwen3-14b's q/k norms take 40 / 8 heads
# of 128 a token
RMS_SHAPES = (
    (512, 2048, "llama3.2-1b / qwen2-moe chunk"),
    (8, 2048, "llama3.2-1b / qwen2-moe decode"),
    (512, 5120, "qwen3-14b width / zamba2 d_inner chunk"),
    (8, 5120, "qwen3-14b width / zamba2 d_inner decode"),
    (20480, 128, "qwen3-14b q-norm chunk"),
    (320, 128, "qwen3-14b q-norm decode"),
    (4096, 128, "qwen3-14b k-norm chunk"),
    (64, 128, "qwen3-14b k-norm decode"),
    (512, 768, "mamba2-130m width chunk"),
    (8, 768, "mamba2-130m width decode"),
    (512, 1536, "mamba2-130m d_inner chunk"),
    (8, 1536, "mamba2-130m d_inner decode"),
    (512, 2560, "zamba2-2.7b width chunk"),
    (8, 2560, "zamba2-2.7b width decode"),
    (512, 3072, "gemma-7b width chunk"),
    (512, 4608, "gemma2-27b width chunk"),
)


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


def time_ssd(cs, dev, flush) -> dict:
    """The tree's SSD-scan kernel at the fused-chunk and prefill shapes."""
    shapes = {f"{arch}_fused_chunk": dict(b=8, s=64, init=True, **hk)
              for arch, hk in cs.SSD_HEADS.items()}
    shapes[f"{cs.MAMBA}_prefill"] = dict(b=2, s=512, init=True, **cs.SSD_HEADS[cs.MAMBA])
    rows = {}
    for case, shape in shapes.items():
        inp, st = cs.ssd_inputs(dev, torch.bfloat16, **shape)
        byts, flops = cs.ssd_work(inp, st, 128)
        b_ms, b_by = cs.bound(byts, flops, torch.bfloat16)
        y, fin = cs.ssd.ssd_scan(*inp, 128, st)
        yr, fr = cs.ssd.ssd_scan_plain(*inp, 128, st)
        err = max(cs.rel_err(y, yr), cs.rel_err(fin, fr))
        if not err < cs.SSD_TOL[torch.bfloat16]:
            sys.exit(f"time_grouped_gemm: ssd_scan {case} is wrong: {err:.3e}")
        run = lambda: cs.ssd.ssd_scan(*inp, 128, st, out_state=st)  # noqa: E731
        same_bytes = torch.ones(byts // 2, dtype=torch.bfloat16, device=dev)
        rows[case] = r = dict(
            ms=cs.time_ms(dev, run, flush=flush),
            read_ms=cs.time_ms(dev, lambda: same_bytes.sum(), flush=flush),
            bound_ms=b_ms, bound_by=b_by, rel_err=err, host_us=host_us(dev, run),
        )
        print(f"[time] ssd_scan {case}: kernel {r['ms']:.4f} ms, a read of the same "
              f"{byts / 1e6:.1f} MB {r['read_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
              f"kernel/bound {r['ms'] / b_ms:.2f}x; max err / max |ref| {err:.3e}; host a call "
              f"{r['host_us']:.1f} us", flush=True)
        del inp, st, same_bytes
    return rows


def time_rms(cs, dev) -> dict:
    """The tree's RMSNorm at every shape of RMS_SHAPES, bf16, back to back,
    with the helpers of the tree's ``chip_smoke.py`` (``cs``)."""
    dtype = torch.bfloat16
    floor = cs.time_ms(dev, lambda: torch.cuda._sleep(0))
    plan = getattr(cs.rn, "plan", None)
    rows = {}
    for n, d, what in RMS_SHAPES:
        x, w = cs.rms_inputs(dev, dtype, rows=n, d=d)
        cs.within(cs.rn.rmsnorm(x, w), cs.rn.rmsnorm_plain(x, w))
        w1, y = (1.0 + w).to(dtype), torch.empty_like(x)
        byts = 2 * x.numel() * x.element_size() + w.numel() * 4
        same_bytes = torch.ones(byts // 2, dtype=dtype, device=dev)
        b_ms, b_by = cs.bound(byts, 4 * x.numel(), torch.float32)
        rows[f"{n}x{d}"] = r = dict(
            path=what, instance=plan(d, dtype).instance if plan else "one block a row",
            ms=cs.time_ms(dev, lambda: cs.rn.rmsnorm(x, w)),
            plain_ms=cs.time_ms(dev, lambda: cs.rn.rmsnorm_plain(x, w)),
            library_ms=cs.time_ms(dev, lambda: F.rms_norm(x, (d,), w1, 1e-6))
            if hasattr(F, "rms_norm") else None,
            copy_ms=cs.time_ms(dev, lambda: y.copy_(x)),
            read_ms=cs.time_ms(dev, lambda: same_bytes.sum()),
            floor_ms=floor, bound_ms=b_ms, bound_by=b_by,
        )
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[time] rmsnorm [{n}, {d}] bf16 ({what}; {r['instance']}): kernel {r['ms']:.4f} "
              f"ms, plain {r['plain_ms']:.4f} ms, F.rms_norm {lib}, bound {b_ms:.5f} ms "
              f"({b_by}: {byts / 1e6:.2f} MB), kernel/bound {r['ms'] / b_ms:.2f}x; a copy of "
              f"the same bytes {r['copy_ms']:.4f} ms, a read {r['read_ms']:.4f} ms; empty-kernel "
              f"floor {floor:.4f} ms", flush=True)
        del x, y, same_bytes
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default=None)
    ap.add_argument("--kernel", choices=("grouped_gemm", "ssd_scan", "rmsnorm"),
                    default="grouped_gemm")
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
    if args.kernel in ("ssd_scan", "rmsnorm"):
        rows = time_ssd(cs, dev, flush) if args.kernel == "ssd_scan" else time_rms(cs, dev)
        print(json.dumps({"tree": args.label or str(tree), "kernel": args.kernel,
                          "build_s": build_s, "rows": rows}))
        return 0
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
