"""Chip smoke test of the PyTorch/CUDA port: the quickest proof that it
builds, is right and serves on an NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the card: name, count, ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a) and
   print what ``-Xptxas -v`` reports for each;
3. hold each kernel against its plain PyTorch version at main-path shapes
   (fp32 ≤ 1e-4 max abs; bf16 within atol 1e-2 + rtol 1e-2, one bf16
   rounding apart);
4. serve full-width llama3.2-1b (bf16, random weights from a seed) through
   ``repro_torch.launch.serve.main`` with its defaults, then through
   ``ServingEngine`` with 16 requests of 100–600 prompt tokens, 8 slots,
   max_len 2048 and 32 new tokens each, served five times by one engine
   (tok/s of each run, their spread and the host's CPU) — both kernels
   must have launched in every run;
5. parity on the card: 2 full-width layers in fp32 served with the kernels
   and with the plain versions give identical greedy tokens; the bf16
   full-depth logits of one prefill are compared too;
   A profiler trace of 16 engine steps shows device time by kernel and
   the card's idle share;
6. time each kernel, its plain version and one PyTorch library call for
   the same function (a yardstick only) with CUDA events at main-path
   shapes, beside the least time the card could take.

The line before last is one JSON object ``{"kernels": [...]}``, and the last
``{"ok": true, "device": {...}}``.  It needs one CUDA card; without one it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
if not (SRC / "repro_torch").is_dir():
    sys.exit(f"chip_smoke: {SRC / 'repro_torch'} not found (run from a checkout of the repo)")
sys.path.insert(0, str(SRC))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.devices import h100_cluster  # noqa: E402
from repro_torch.core.placement import PlanConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 / fp32 non-tensor
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 1e-2)}   # (atol, rtol)
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def reset_counts() -> None:
    fa.launches = 0
    rn.launches = 0


def counts() -> dict:
    return {"flash_attention": fa.launches, "rmsnorm": rn.launches}


def within(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Max abs error; raises if any element is outside the stated tolerance."""
    atol, rtol = TOL[out.dtype]
    diff = (out.float() - ref.float()).abs()
    excess = (diff - rtol * ref.float().abs()).max().item()
    err = diff.max().item()
    if not excess <= atol:
        raise AssertionError(f"kernel disagrees with plain version: max abs err {err:.3e}")
    return err


# --------------------------------------------------------------------- inputs
def flash_inputs(dev, dtype, *, sq, depths, q_lens, sk=2048, h=32, kv=8, d=64, seed=SEED):
    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(depths)
    return dict(
        q=torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype),
        k=torch.randn(b, sk, kv, d, generator=g, device=dev).to(dtype),
        v=torch.randn(b, sk, kv, d, generator=g, device=dev).to(dtype),
        q_offsets=torch.tensor(depths, dtype=torch.int32, device=dev),
        q_lens=torch.tensor(q_lens, dtype=torch.int32, device=dev),
    )


def flash_cases(dev, dtype):
    rng = np.random.default_rng(SEED)
    decode = rng.integers(0, 2048, size=8).tolist()
    chunk_lens = [64, 1, 0, 64, 17, 1, 64, 0]
    chunk_depths = [int(rng.integers(0, 2048 - n + 1)) for n in chunk_lens]
    return {
        "decode": (flash_inputs(dev, dtype, sq=1, depths=decode, q_lens=[1] * 8), {}),
        "fused_chunk": (flash_inputs(dev, dtype, sq=64, depths=chunk_depths, q_lens=chunk_lens), {}),
        "fused_chunk_window_softcap": (
            flash_inputs(dev, dtype, sq=64, depths=chunk_depths, q_lens=chunk_lens),
            {"window": 64, "softcap": 50.0},
        ),
    }


def run_flash(fn, inp, extra):
    d = inp["q"].shape[-1]
    return fn(inp["q"], inp["k"], inp["v"], inp["q_offsets"], inp["q_lens"],
              scale=d ** -0.5, causal=True, window=extra.get("window"),
              softcap=extra.get("softcap"))


def rms_inputs(dev, dtype, rows=512, d=2048):
    g = torch.Generator(device=dev).manual_seed(SEED)
    return (torch.randn(rows, d, generator=g, device=dev).to(dtype),
            torch.randn(d, generator=g, device=dev) * 0.1)


# --------------------------------------------------------------------- phases
def phase_card() -> dict:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[card] {name} count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(f"[card] nvidia-smi: {smi}")
    # fp32 matmuls in full fp32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"dev": dev, "name": name, "smi": smi}


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f}s")
    for line in _build.build_log().splitlines():
        if line.startswith("==") or "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def phase_check(dev) -> dict:
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case, (inp, extra) in flash_cases(dev, dtype).items():
            out = run_flash(fa.flash_attention, inp, extra)
            ref = run_flash(fa.flash_attention_plain, inp, extra)
            torch.cuda.synchronize(dev)
            err = within(out, ref)
            for bi, n in enumerate(inp["q_lens"].tolist()):
                if out[bi, n:].any():
                    raise AssertionError(f"flash {case}: row {bi} leaked past q_len={n}")
            errs[("flash_attention", case, dtype)] = err
            log(f"[check] flash_attention {case} {str(dtype)[6:]}: max abs err {err:.3e}")
        x, w = rms_inputs(dev, dtype)
        err = within(rn.rmsnorm(x, w), rn.rmsnorm_plain(x, w))
        errs[("rmsnorm", "rows512", dtype)] = err
        log(f"[check] rmsnorm [512, 2048] {str(dtype)[6:]}: max abs err {err:.3e}")
    return errs


def full_cfg(**kw):
    kw = dict(dict(scan_layers=False, remat=False, attention_impl="pallas"), **kw)
    return dataclasses.replace(get_config("llama3.2-1b"), **kw)


def make_engine(cfg, params, dev, *, slots, max_len):
    return ServingEngine(
        cfg, params, h100_cluster(1), devices=[dev], slots=slots, max_len=max_len,
        plan_cfg=PlanConfig(method="moirai", time_limit=20.0, objective="throughput",
                            serving_slots=slots),
        eos_id=-1,
    )


def drive(eng, cfg, dev, *, requests, max_new, seed=SEED, rid0=0):
    """Submit ``requests`` seeded prompts of 100-600 tokens and serve them
    all; returns the requests and the wall time of the serving alone."""
    rng = np.random.default_rng(seed)
    reqs = [
        Request(rid=rid0 + i, prompt=rng.integers(1, cfg.vocab_size, size=int(n)).tolist(),
                max_new_tokens=max_new)
        for i, n in enumerate(rng.integers(100, 601, size=requests))
    ]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize(dev)
    return reqs, time.perf_counter() - t0


def serve_engine_run(cfg, params, dev, *, requests, slots, max_len, max_new, seed=SEED):
    eng = make_engine(cfg, params, dev, slots=slots, max_len=max_len)
    reqs, wall = drive(eng, cfg, dev, requests=requests, max_new=max_new, seed=seed)
    return eng, reqs, wall


def host_line() -> str:
    """The host the run shares: CPU model (``lscpu``), cores it may use, load."""
    model = platform.machine() or "unknown"
    if shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        for line in out.splitlines():
            if line.startswith("Model name:"):
                model = f"{line.split(':', 1)[1].strip()} ({platform.machine()})"
                break
    usable = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    load = tuple(round(x, 2) for x in os.getloadavg()) if hasattr(os, "getloadavg") else "n/a"
    return f"cpu={model!r} cores={os.cpu_count()} usable={usable} loadavg={load}"


ENGINE_REPEATS = 5


def phase_serve(dev) -> dict:
    log(f"[serve] host: {host_line()}")
    log("[serve] repro_torch.launch.serve.main(['--arch', 'llama3.2-1b']) — CLI defaults")
    reset_counts()
    t0 = time.perf_counter()
    engine, reqs = serve.main(["--arch", "llama3.2-1b"])
    torch.cuda.synchronize(dev)
    cli_counts = counts()
    log(f"[serve] cli: {time.perf_counter() - t0:.1f}s incl. init, launches {cli_counts}")
    if not all(cli_counts.values()):
        raise AssertionError(f"a kernel of the main path never launched: {cli_counts}")
    if not all(r.done and len(r.out_tokens) == r.max_new_tokens for r in reqs):
        raise AssertionError("the CLI left requests unserved")
    del engine

    cfg = full_cfg()
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    eng = make_engine(cfg, params, dev, slots=8, max_len=2048)
    pl = eng.placement_result
    log(f"[serve] engine: placement method={pl.method} devices={sorted(set(pl.placement.values()))} "
        f"stages={len(eng.executor.stages)} (layers {[s.layer_ids for s in eng.executor.stages]})")
    # the same 16 requests served ENGINE_REPEATS times by one engine: the
    # spread of tok/s within one machine, the first run cold
    tok_s, first_tokens = [], None
    for rep in range(ENGINE_REPEATS):
        reset_counts()
        reqs, wall = drive(eng, cfg, dev, requests=16, max_new=32, rid0=100 * rep)
        eng_counts = counts()
        toks = sum(len(r.out_tokens) for r in reqs)
        prompt_toks = sum(len(r.prompt) for r in reqs)
        tok_s.append(toks / wall)
        if not all(eng_counts.values()):
            raise AssertionError(f"a kernel of the main path never launched: {eng_counts}")
        for r in reqs:
            if not (r.done and len(r.out_tokens) == 32
                    and all(0 <= t < cfg.vocab_size for t in r.out_tokens)):
                raise AssertionError(f"request {r.rid} not served right: {r.out_tokens}")
        out = [r.out_tokens for r in reqs]
        same = "" if first_tokens is None else f", tokens as run 1: {out == first_tokens}"
        first_tokens = first_tokens or out
        log(f"[serve] engine run {rep + 1}/{ENGINE_REPEATS}: 16 requests, {prompt_toks} prompt "
            f"tokens, {toks} generated tokens in {wall:.3f}s = {toks / wall:.1f} generated "
            f"tok/s, {(toks + prompt_toks) / wall:.1f} processed tok/s; launches "
            f"{eng_counts}{same}")
    log(f"[serve] engine gen tok/s over {ENGINE_REPEATS} runs: {[round(x, 1) for x in tok_s]}, "
        f"median {float(np.median(tok_s)):.1f}, spread (max-min)/median "
        f"{(max(tok_s) - min(tok_s)) / float(np.median(tok_s)):.3f}; host: {host_line()}")
    # launches per forward: one fused [8, 64] forward through the executor
    eng.caches = None
    eng._ensure_caches()
    reset_counts()
    tokens = torch.randint(1, cfg.vocab_size, (8, 64), dtype=torch.int32)
    logits, _ = eng.executor.forward(
        tokens, eng.caches, cache_pos=np.zeros(8, np.int32), kind="fused",
        q_lens=torch.full((8,), 64, dtype=torch.int32),
    )
    torch.cuda.synchronize(dev)
    per_fwd = counts()
    if not torch.isfinite(logits.float()).all() or logits.shape != (8, 64, cfg.vocab_size):
        raise AssertionError("fused forward gave non-finite or misshapen logits")
    log(f"[serve] launches per fused forward: {per_fwd}")
    del logits
    phase_trace(eng, cfg, dev)
    del eng, params
    torch.cuda.empty_cache()
    return {"cli": cli_counts, "per_forward": per_fwd, "tok_s": tok_s}


def phase_trace(eng, cfg, dev) -> None:
    """Where a serve step's time goes: a profiler trace of 16 engine steps
    (5 with 64-token prefill chunks of 8 new 300-token prompts, then decode),
    device time by kernel and the card's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 2)
    for i in range(8):
        eng.submit(Request(rid=1000 + i, prompt=rng.integers(1, cfg.vocab_size, size=300).tolist(),
                           max_new_tokens=64))
    eng.step()                                   # admission + first chunk, untraced
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(16):
            eng.step()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): a CPU op's row repeats
        # the device time of the kernels it launched
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0)
        if dt > 0:
            rows.append((dt, e.key, e.count))
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[trace] 16 engine steps: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms, "
        f"device idle share {1 - busy / wall:.3f}" if rows else
        "[trace] the profiler recorded no device time: not measured")
    for dt, key, n in sorted(rows, reverse=True)[:12]:
        log(f"[trace]   {dt / 1e3:9.3f} ms {100 * dt / 1e6 / wall:5.1f}% x{n:<5d} {key[:90]}")
    eng.run_until_drained()


def phase_parity(dev) -> None:
    # 2 full-width layers in fp32: kernels against plain versions, 32 greedy steps
    tokens = {}
    for impl in ("pallas", "naive"):
        cfg = full_cfg(n_layers=2, dtype="float32", attention_impl=impl)
        params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
        reset_counts()
        _, reqs, _ = serve_engine_run(cfg, params, dev, requests=6, slots=4,
                                      max_len=1024, max_new=32, seed=SEED + 1)
        tokens[impl] = [r.out_tokens for r in reqs]
        log(f"[parity] fp32 2 layers impl={impl}: launches {counts()}")
        del params
    if tokens["pallas"] != tokens["naive"]:
        raise AssertionError("fp32 greedy tokens differ between kernel and plain paths")
    log(f"[parity] fp32 2 layers: greedy tokens identical over 6 requests x 32 steps")

    # bf16 full depth: one prefill's logits, kernels vs plain
    logits = {}
    cfg = full_cfg()
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (2, 300), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(1))}
    for impl in ("pallas", "naive"):
        m = build_model(dataclasses.replace(cfg, attention_impl=impl))
        lg, _ = m.prefill(params, batch, 512)
        logits[impl] = lg.float()
    torch.cuda.synchronize(dev)
    diff = (logits["pallas"] - logits["naive"]).abs().max().item()
    if not torch.isfinite(logits["pallas"]).all():
        raise AssertionError("bf16 full-depth logits are not finite")
    agree = (logits["pallas"].argmax(-1) == logits["naive"].argmax(-1)).float().mean().item()
    log(f"[parity] bf16 16 layers prefill [2, 300]: last-token logit max abs diff {diff:.3e}, "
        f"argmax agreement {agree:.2f} (logit scale {logits['naive'].abs().max().item():.2f})")
    del params
    torch.cuda.empty_cache()


def time_ms(dev, fn, *, iters=50, flush=None) -> float:
    """Mean device time of one call, from CUDA events, after a warm-up.

    With ``flush`` the L2 is flushed before every call, each call timed on
    its own (the main path finds each layer's KV cache cold: 33 MB per
    layer at 8 slots x 2048).  Without, the calls run back to back behind a
    spin kernel that keeps the card busy while the host enqueues them, so
    host overhead between calls does not count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize(dev)
    if flush is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize(dev)
    return float(np.mean([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def time_opt(dev, fn, **kw):
    return None if fn is None else time_ms(dev, fn, **kw)


def flash_work(inp, extra) -> tuple:
    """Bytes the function must move and flops it must do for THESE inputs:
    each visible key of each valid row, K/V read up to each row's last
    visible key, q read and out written once."""
    q, k = inp["q"], inp["k"]
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    mask = fa.visible_mask(inp["q_offsets"], inp["q_lens"], sq, sk, causal=True,
                           window=extra.get("window"))
    n_vis = mask.sum().item()                       # (row, query, key) triples
    keys_read = mask.any(dim=1).sum().item()        # (row, key) pairs read
    es = q.element_size()
    byts = 2 * q.numel() * es + 2 * keys_read * kv * d * es + 2 * b * 4
    flops = 4 * d * h * n_vis
    return byts, flops


def bound(byts, flops, dtype):
    t_b, t_f = byts / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def sdpa_call(inp, extra):
    """One library call for the same function (yardstick only)."""
    q, k, v = (t.transpose(1, 2) for t in (inp["q"], inp["k"], inp["v"]))
    b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
    mask = fa.visible_mask(inp["q_offsets"], inp["q_lens"], sq, sk, causal=True,
                           window=extra.get("window"))[:, None]
    if "enable_gqa" not in (F.scaled_dot_product_attention.__doc__ or ""):
        return None      # this PyTorch has no GQA in SDPA: no one-call yardstick
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=q.shape[-1] ** -0.5, enable_gqa=True
    )


def phase_time(dev) -> dict:
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)   # > 50 MB L2
    rows = {}
    dtype = torch.bfloat16
    for case, (inp, extra) in flash_cases(dev, dtype).items():
        byts, flops = flash_work(inp, extra)
        b_ms, b_by = bound(byts, flops, dtype)
        rows[("flash_attention", case)] = dict(
            ms=time_ms(dev, lambda: run_flash(fa.flash_attention, inp, extra), flush=flush),
            plain_ms=time_ms(dev, lambda: run_flash(fa.flash_attention_plain, inp, extra),
                             iters=10, flush=flush),
            library_ms=time_opt(dev, sdpa_call(inp, extra), iters=20, flush=flush),
            bound_ms=b_ms, bound_by=b_by,
        )
    for nrows in (512, 8):
        x, w = rms_inputs(dev, dtype, rows=nrows)
        w1 = (1.0 + w).to(dtype)
        byts = 2 * x.numel() * x.element_size() + w.numel() * 4
        b_ms, b_by = bound(byts, 4 * x.numel(), torch.float32)
        # no flush: on the main path x was written by the op just before
        rows[("rmsnorm", f"rows{nrows}")] = dict(
            ms=time_ms(dev, lambda: rn.rmsnorm(x, w)),
            plain_ms=time_ms(dev, lambda: rn.rmsnorm_plain(x, w)),
            library_ms=time_opt(
                dev, (lambda: F.rms_norm(x, (x.shape[-1],), w1, 1e-6))
                if hasattr(F, "rms_norm") else None,
            ),
            bound_ms=b_ms, bound_by=b_by,
        )
    for (name, case), r in rows.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"[time] {name} {case} bf16: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
            f"kernel/bound {r['ms'] / r['bound_ms']:.1f}x")
    del flush
    return rows


def main() -> int:
    t_start = time.perf_counter()
    card = phase_card()
    dev = card["dev"]
    phase_build()
    errs = phase_check(dev)
    served = phase_serve(dev)
    phase_parity(dev)
    times = phase_time(dev)

    kernels = []
    for name, case, source, replaces in (
        ("flash_attention", "fused_chunk", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:41"),
        ("rmsnorm", "rows512", "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm/kernel.py:22"),
    ):
        t = times[(name, case)]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": served["cli"][name],
            "max_abs_err": errs[(name, case, torch.bfloat16)],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": case, "launches_per_forward": served["per_forward"][name],
        })
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    log(card["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
