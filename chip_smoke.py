"""Chip smoke test of the PyTorch/CUDA port: the quickest proof that it
builds, is right and serves on an NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the card: name, count, ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a) and
   print what ``-Xptxas -v`` reports for each;
3. hold each kernel against its plain PyTorch version at main-path shapes
   (fp32 ≤ 1e-4 max abs; bf16 within atol 1e-2 + rtol 1e-2, one bf16
   rounding apart); the paged flash kernel at pages of 16, 64 and 48
   tokens, with shared pages, unmapped entries and a trash page of large
   finite garbage that must change no output, and against the dense
   kernel on the gathered view of the same pools; both flash kernels at
   qwen2-moe's head dim 128 (16 query and 16 KV heads); a chunk of 100
   queries at depths 0 and 1000 at each head dim, dense and paged (bf16:
   the tensor-core chunk tile's ragged edges); the split-KV decode kernel
   at each model's heads, at depths 0, split-1, split, split+1 and 2047
   and an idle row, plain and with window 64 + softcap 50, dense and paged
   (P 16, 48, 64): paged bit-equal to dense on the gathered view (trash
   page garbage or zeroed) and two launches bit-identical; the flash
   kernels at qwen3-14b's heads (D 128, GQA 40 / 8) and gemma-7b's (D 256,
   16 / 16: decode, fused chunk, window 64 + softcap 50, the 100-query
   chunk, paged at P 16, 64 and 48, every case bit-identical twice and
   paged bit-equal to dense), the decode kernel at gemma2-27b's heads (D
   128, GQA 32 / 16) too; every D 256 instance built without a spill
   store (``[build]``); the grouped GEMM
   at qwen2-moe's gate/up and down shapes under decode and chunk routing,
   and on edge groupings; RMSNorm in fp32 and bf16 at every main-path
   shape of ``RMS_SHAPES`` (``time_grouped_gemm.py``), at row counts that
   leave a block's last row groups idle and at one row, all on the rows
   kernel, and on the generic kernel at widths no instance covers and at
   a misaligned x or w (which kernel ran is counted; two launches must be
   bit-identical);
4. serve full-width llama3.2-1b (bf16, random weights from a seed) through
   ``repro_torch.launch.serve.main`` with its defaults, then through
   ``ServingEngine`` with 16 requests of 100–600 prompt tokens, 8 slots,
   max_len 2048 and 32 new tokens each, served three times by one engine
   (tok/s of each run, their spread and the host's CPU) — both kernels
   must have launched in every run, and decode steps must have run the
   split-KV decode kernel;
5. parity on the card: 2 full-width layers in fp32 served with the kernels
   and with the plain versions give identical greedy tokens; the bf16
   full-depth logits of one prefill are compared too;
   A profiler trace of 16 engine steps shows device time by kernel and
   the card's idle share;
6. paged KV with prefix sharing: parity on the card (fp32, 2 layers: the
   paged engine with and without sharing gives the dense engine's greedy
   tokens), then full-width bf16 serving with ``--kv-page-tokens 64``
   through the CLI and through one ``ServingEngine`` (16 requests opening
   with one 512-token system prefix and a 100–600-token suffix, 8 slots,
   max_len 2048, 32 new tokens each, served three times, beside a dense
   engine on the same requests) — the paged kernel must have launched and
   pages must have been reused;
7. MoE: full-width qwen2-moe-a2.7b (24 layers, 60 routed experts padded
   to 64, top-4, bf16, random weights from a seed) — parity (2 full-width
   layers in fp32 with kernels and with plain versions give identical
   greedy tokens; the bf16 full-depth logits of one prefill are compared),
   then phases 4 and 6 for it: the CLI with its defaults and with
   ``--kv-page-tokens 64``, one dense ``ServingEngine`` serving the 16
   requests three times and a profiler trace of 16 of its steps, one paged
   engine on the shared-prefix requests three times beside a dense one.
   Every forward must launch the grouped-GEMM kernel 3 × 24 times, and the
   head-dim-128 flash kernel must have launched. Then qwen3-14b (40
   layers, d_model 5120, per-head q/k norms, GQA 40 / 8 at D 128, ~29.5 GB
   bf16): ``[parity-qwen3]`` as phase 5, ``[serve-qwen3]`` and
   ``[trace-qwen3]`` as phase 4. gemma-7b (28 layers, d_model 3072, 16
   heads of 256, GeGLU, tied and scaled embeddings, ~17.1 GB bf16):
   ``[parity-gemma]`` (phase 5, the fp32 engines dense and paged),
   ``[serve-gemma]``, ``[trace-gemma]`` and ``[serve-gemma-paged]`` (phases
   4 and 6). gemma2-27b (46 layers, window 4096 on every other layer,
   softcaps, post-norms, ~54.4 GB bf16): ``[parity-gemma2]`` (2 fp32
   layers, one row prefilled to 4300 tokens so the local layer's window
   masks keys in both the chunk tile and the decode kernel; 46 bf16
   layers' prefill logits), ``[serve-gemma2]`` and ``[trace-gemma2]``,
   dense KV. Every engine run's chunk steps must run a chunk tile. In
   every serve and parity run each forward must launch
   ``norms_per_forward(cfg)`` RMSNorms (2 a block, + 2 for q/k norms, + 2
   for post-norms, 2 a Mamba layer, + 1; qwen3-14b 161, gemma-7b 57,
   gemma2-27b 185), every one on the rows kernel;
8. SSM and hybrid: ``[check-ssd]`` holds the SSD chunked-scan kernel to
   its plain version (fp32 and bf16 within 1e-5 and 4e-2 of max |ref|,
   for y and the final state) at the reference test's shapes, both
   models' heads at S = 1, 17, 64, 200, from zero and random initial
   states, at mamba2's multi-chunk prefill (2 rows of 512 tokens, four
   chunks, a carried state), with the final state written over the
   initial one (as the model updates its cache), and with dt zeroed past
   per-row lengths; every bf16 call must run the tensor-core kernel and
   every fp32 call the CUDA-core one (counted by kernel), and two bf16
   launches at each fused-chunk shape must be bit-identical;
   phase 3 also holds both flash kernels at zamba2's head dim 80 (32
   heads, no GQA).
   ``[serve-ssm]``: full-width mamba2-130m and zamba2-2.7b (bf16, random
   weights from a seed) through ``build_model(cfg).fused_step``, driven
   like ``tests/test_fused_step.py::_fused_generate`` (8 requests of
   100–600 prompt tokens, 64-token chunks, 32 new tokens, three runs):
   every forward must launch RMSNorm 2 per Mamba layer + 2 per shared
   block + 1, the SSD kernel once per Mamba layer when S > 1 (never at
   S = 1), and zamba2's flash kernel once per shared block (9).
   ``[parity-ssm]``: fp32 kernels vs plain give identical greedy tokens
   (mamba2 at full depth, zamba2 at one 6-layer segment); bf16 full-depth
   prefill logits kernels vs plain and prefill_chunked vs prefill (the
   same argmax except at a bf16 tie of at most two bf16 steps); zamba2
   paged (P = 64) gives dense's greedy tokens.  ``[trace-ssm]``: a
   profiler trace of 16 zamba2 driver steps;
9. time each kernel, its plain version and one PyTorch library call for
   the same function (a yardstick only) with CUDA events at main-path
   shapes, beside the least time the card could take; the paged kernel
   also beside the dense kernel at the same depths and the two-call
   yardstick gather + SDPA (no single PyTorch call reads through a page
   table); the flash kernels at qwen2-moe's head dim 128, zamba2's 80 and
   gemma-7b's 256 too, and the bf16 chunk tile's fixed cost (8 rows at depth 0) and cost
   a key tile (one row at depth 1984: 32 key tiles in order), and the
   decode kernel's fixed cost (8 rows at depth 0, merge included) and
   deepest split walk (one row at depth 2047).  SDPA, the yardstick, is
   timed under each backend that takes the call, and the fastest is
   reported with its name; the grouped
   GEMM at qwen2-moe's decode and chunk routings, beside
   ``torch._grouped_mm`` where this PyTorch has it (else a per-expert
   ``torch.matmul`` loop, labelled so); the SSD kernel at both models'
   fused-chunk shapes and at mamba2's multi-chunk prefill (no single
   PyTorch call computes the scan); RMSNorm back to back at every shape of
   ``RMS_SHAPES``, beside ``F.rms_norm``, a copy and a read of the same
   bytes and an empty kernel's time (the floor), naming the instance.

The line before last is one JSON object ``{"kernels": [...]}``, and the last
``{"ok": true, "device": {...}}``.  It needs one CUDA card; without one it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import platform
import re
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
sys.path.insert(0, str(ROOT))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.devices import h100_cluster  # noqa: E402
from repro_torch.core.placement import PlanConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_gemm as gg  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.kv_pool import KVPool  # noqa: E402
from time_grouped_gemm import RMS_SHAPES, time_rms  # noqa: E402

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
    fa.paged_launches = 0
    fa.decode_launches = 0
    fa.paged_decode_launches = 0
    rn.launches = 0
    rn.rows_launches = 0
    rn.generic_launches = 0
    gg.launches = 0
    ssd.launches = 0
    ssd.mma_launches = 0
    ssd.core_launches = 0


def counts() -> dict:
    return {"flash_attention": fa.launches, "flash_attention_paged": fa.paged_launches,
            "flash_attention_decode": fa.decode_launches,
            "flash_attention_paged_decode": fa.paged_decode_launches,
            "rmsnorm": rn.launches, "rmsnorm_rows": rn.rows_launches,
            "rmsnorm_generic": rn.generic_launches, "grouped_gemm": gg.launches,
            "ssd_scan": ssd.launches,
            "ssd_scan_mma": ssd.mma_launches, "ssd_scan_core": ssd.core_launches}


def require(got: dict, names, what: str) -> None:
    """Fail unless every kernel in ``names`` launched in the run ``got``
    counts, and every RMSNorm ran on the rows kernel."""
    if not all(got[n] for n in names):
        raise AssertionError(f"{what}: a kernel of the path never launched: {got}")
    if got["rmsnorm_generic"] or got["rmsnorm_rows"] != got["rmsnorm"]:
        raise AssertionError(f"{what}: a norm ran on the generic RMSNorm kernel: {got}")


def require_chunk_tile(got: dict, paged: bool, what: str) -> None:
    """Fail unless the run's chunk steps went through a chunk tile: flash
    launches beyond the decode kernel's (the wrapper counts both)."""
    name = "flash_attention_paged" if paged else "flash_attention"
    if not got[name] > got[name + "_decode"]:
        raise AssertionError(f"{what}: no flash launch ran a chunk tile: {got}")


LLAMA = "llama3.2-1b"
MOE = "qwen2-moe-a2.7b"
MAMBA = "mamba2-130m"
ZAMBA = "zamba2-2.7b"
QWEN3 = "qwen3-14b"
GEMMA = "gemma-7b"
GEMMA2 = "gemma2-27b"
# phase tags: [serve], [serve-moe], ...
TAGS = {LLAMA: "", MOE: "-moe", QWEN3: "-qwen3", GEMMA: "-gemma", GEMMA2: "-gemma2"}
# the kernels each path must launch: dense or paged KV (decode steps on the
# split-KV decode kernel), plus the grouped GEMM for an MoE model
DENSE_PATH = ("flash_attention", "flash_attention_decode", "rmsnorm")
PAGED_PATH = ("flash_attention_paged", "flash_attention_paged_decode", "rmsnorm")


def path(arch: str, paged: bool) -> tuple:
    kernels = PAGED_PATH if paged else DENSE_PATH
    return kernels + (("grouped_gemm",) if arch == MOE else ())


def norms_per_forward(cfg) -> int:
    """RMSNorm launches of one forward: 2 an attention block (+ 2 for the
    per-head q/k norms, + 2 for post-norms), 2 a Mamba layer, plus the
    final norm; a hybrid model's shared attention block counts at each of
    its occurrences."""
    attn = 2 + 2 * cfg.qk_norm + 2 * cfg.post_block_norm
    if cfg.family == "ssm":
        return 2 * cfg.n_layers + 1
    if cfg.family == "hybrid":
        return 2 * cfg.n_layers + attn * (cfg.n_layers // cfg.shared_attn_every) + 1
    return attn * cfg.n_layers + 1


def require_per_forward(got: dict, cfg, what: str) -> None:
    """Every forward launches ``norms_per_forward(cfg)`` RMSNorms, all on
    the rows kernel, so the run's count must be a whole multiple of one
    forward's; an MoE run must also launch the grouped GEMM 3 times a
    layer in every forward."""
    norms = norms_per_forward(cfg)
    fwd = got["rmsnorm"] // norms
    if not (fwd > 0 and got["rmsnorm"] == fwd * norms == got["rmsnorm_rows"]):
        raise AssertionError(f"{what}: RMSNorm launches are not {norms} a forward, all on the "
                             f"rows kernel: {got}")
    if cfg.n_experts and got["grouped_gemm"] != 3 * cfg.n_layers * fwd:
        raise AssertionError(f"{what}: grouped GEMM launches are not 3 x {cfg.n_layers} per "
                             f"forward: {got}")


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


# attention heads (query, KV) and head dim of each served model
HEADS = {LLAMA: dict(h=32, kv=8, d=64), MOE: dict(h=16, kv=16, d=128),
         ZAMBA: dict(h=32, kv=32, d=80), QWEN3: dict(h=40, kv=8, d=128),
         GEMMA: dict(h=16, kv=16, d=256), GEMMA2: dict(h=32, kv=16, d=128)}


def flash_cases(dev, dtype, arch=LLAMA):
    rng = np.random.default_rng(SEED)
    decode = rng.integers(0, 2048, size=8).tolist()
    chunk_lens = [64, 1, 0, 64, 17, 1, 64, 0]
    chunk_depths = [int(rng.integers(0, 2048 - n + 1)) for n in chunk_lens]
    hk = HEADS[arch]
    return {
        "decode": (flash_inputs(dev, dtype, sq=1, depths=decode, q_lens=[1] * 8, **hk), {}),
        "fused_chunk": (flash_inputs(dev, dtype, sq=64, depths=chunk_depths, q_lens=chunk_lens,
                                     **hk), {}),
        "fused_chunk_window_softcap": (
            flash_inputs(dev, dtype, sq=64, depths=chunk_depths, q_lens=chunk_lens, **hk),
            {"window": 64, "softcap": 50.0},
        ),
        # the chunk tile's fixed cost (one key tile a block) and its cost a
        # key tile (one row: 32 key tiles walked in order by each block)
        "chunk_depth0": (flash_inputs(dev, dtype, sq=64, depths=[0] * 8, q_lens=[64] * 8, **hk),
                         {}),
        "chunk_one_row_depth1984": (
            flash_inputs(dev, dtype, sq=64, depths=[1984], q_lens=[64], **hk), {}),
        # the decode kernel's fixed cost (8 rows at depth 0: one key each,
        # the merge launched and idle) and its deepest split walk (one row
        # at depth 2047: 8 or 16 splits in parallel, then the merge)
        "decode_depth0": (flash_inputs(dev, dtype, sq=1, depths=[0] * 8, q_lens=[1] * 8, **hk),
                          {}),
        "decode_one_row_depth2047": (
            flash_inputs(dev, dtype, sq=1, depths=[2047], q_lens=[1], **hk), {}),
    }


def ragged_chunk_cases(dev, dtype, arch):
    """A chunk whose Sq (100) is not a multiple of the tensor-core tile's
    16-row warp slice, at depths 0 and 1000 (last keys 100 and 1100: not
    multiples of the 64-key tile), dense and paged (P = 64)."""
    hk = HEADS[arch]
    kw = dict(sq=100, depths=[0, 1000], q_lens=[100, 100], **hk)
    return flash_inputs(dev, dtype, **kw), paged_inputs(dev, dtype, P=64, **kw)


def run_flash(fn, inp, extra):
    d = inp["q"].shape[-1]
    return fn(inp["q"], inp["k"], inp["v"], inp["q_offsets"], inp["q_lens"],
              scale=d ** -0.5, causal=True, window=extra.get("window"),
              softcap=extra.get("softcap"))


def rms_inputs(dev, dtype, rows=512, d=2048):
    g = torch.Generator(device=dev).manual_seed(SEED)
    return (torch.randn(rows, d, generator=g, device=dev).to(dtype),
            torch.randn(d, generator=g, device=dev) * 0.1)


def paged_inputs(dev, dtype, *, P, depths, q_lens, sq, max_len=2048, h=32, kv=8, d=64,
                 shared=2, seed=SEED):
    """Pools and a page table as the engine builds them: every page a row's
    visible keys need is mapped, in a random order, rows 0 and 1 sharing
    their first ``shared`` pages; the other entries are -1.  The trash page
    holds large finite garbage that no query may see."""
    rng = np.random.default_rng(seed)
    b = len(depths)
    pps = -(-max_len // P)
    need = [-(-(dp + n) // P) for dp, n in zip(depths, q_lens)]
    num_pages = sum(need) + 3
    ids = iter(rng.permutation(num_pages).tolist())
    table = np.full((b, pps), -1, np.int32)
    for bi, n in enumerate(need):
        for j in range(n):
            share = bi == 1 and j < shared and table[0, j] >= 0
            table[bi, j] = table[0, j] if share else next(ids)
    g = torch.Generator(device=dev).manual_seed(seed)
    pool_k = torch.randn(num_pages + 1, P, kv, d, generator=g, device=dev).to(dtype)
    pool_v = torch.randn(num_pages + 1, P, kv, d, generator=g, device=dev).to(dtype)
    pool_k[-1] = 1e4
    pool_v[-1] = -1e4
    return dict(
        q=torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype),
        pool_k=pool_k, pool_v=pool_v, table=torch.from_numpy(table).to(dev),
        q_offsets=torch.tensor(depths, dtype=torch.int32, device=dev),
        q_lens=torch.tensor(q_lens, dtype=torch.int32, device=dev),
    )


def paged_cases(dev, dtype, arch=LLAMA):
    """Decode and fused-chunk rows at random depths (q_len 0, 1, 17, 64),
    row 1 reading row 0's shared pages; pages of 16, 64 and 48 tokens (48
    does not divide the kernel's 64-key tile); window and softcap.  For the
    MoE and hybrid models' head dims, pages of 64 only."""
    full = arch in (LLAMA, GEMMA)
    rng = np.random.default_rng(SEED)
    decode = rng.integers(0, 2048, size=8).tolist()
    lens = [64, 1, 0, 64, 17, 1, 64, 0]
    depths = [int(rng.integers(0, 2048 - n + 1)) for n in lens]
    depths[1] = depths[0] + 64
    hk = HEADS[arch]
    cases = {}
    for P in (16, 64, 48) if full else (64,):
        cases[f"fused_chunk_P{P}"] = (
            paged_inputs(dev, dtype, P=P, depths=depths, q_lens=lens, sq=64, **hk), {})
    cases["decode_P64"] = (
        paged_inputs(dev, dtype, P=64, depths=decode, q_lens=[1] * 8, sq=1, **hk), {})
    if full:
        cases["fused_chunk_P64_window_softcap"] = (
            paged_inputs(dev, dtype, P=64, depths=depths, q_lens=lens, sq=64, **hk),
            {"window": 64, "softcap": 50.0})
    return cases


# qwen2-moe-a2.7b's routed experts: 60 real of 64, top-4, d_model 2048,
# expert width 1408; gate/up multiply [M, 2048] by [64, 2048, 1408], down
# [M, 1408] by [64, 1408, 2048]
GG_SHAPES = {"gate_up": (2048, 1408), "down": (1408, 2048)}
GG_ROUTING = {"decode": 8, "chunk": 512}        # tokens routed: 8 slots x 1, 8 x 64


def routed_sizes(tokens, *, top_k=4, e_real=60, e_pad=64, seed=SEED):
    """Group sizes of ``tokens`` tokens each routed to ``top_k`` distinct
    experts of ``e_real`` (uniformly, numpy seed); padding experts empty."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(e_real, top_k, replace=False) for _ in range(tokens)])
    return np.bincount(ids.ravel(), minlength=e_pad).tolist()


def gg_inputs(dev, dtype, *, sizes, k, n, seed=SEED):
    g = torch.Generator(device=dev).manual_seed(seed)
    m = int(sum(sizes))
    return dict(
        x=torch.randn(m, k, generator=g, device=dev).to(dtype),
        w=(torch.randn(len(sizes), k, n, generator=g, device=dev) * k ** -0.5).to(dtype),
        group_sizes=torch.tensor(sizes, dtype=torch.int32, device=dev),
    )


def gg_cases(dev, dtype):
    """The four main-path shapes, then edge groupings at the gate/up
    shape: every row in one expert, the last expert only, groups of one
    row, and a ragged M (not a multiple of the kernel's 64-row tile)."""
    cases = {}
    for (proj, (k, n)), (routing, tokens) in (
        (a, b) for a in GG_SHAPES.items() for b in GG_ROUTING.items()
    ):
        cases[f"{proj}_{routing}"] = gg_inputs(dev, dtype, sizes=routed_sizes(tokens), k=k, n=n)
    k, n = GG_SHAPES["gate_up"]
    for name, sizes in (
        ("one_expert", [300] + [0] * 63),
        ("last_expert", [0] * 63 + [77]),
        ("rows_of_one", [1, 0] * 32),
        ("ragged_m", [65, 0, 1, 130, 3] + [0] * 59),
    ):
        cases[name] = gg_inputs(dev, dtype, sizes=sizes, k=k, n=n)
    return cases


def run_gg(fn, inp):
    return fn(inp["x"], inp["w"], inp["group_sizes"])


def run_paged(fn, inp, extra):
    d = inp["q"].shape[-1]
    return fn(inp["q"], inp["pool_k"], inp["pool_v"], inp["table"], inp["q_offsets"],
              inp["q_lens"], scale=d ** -0.5, causal=True, window=extra.get("window"),
              softcap=extra.get("softcap"))


def gathered(inp) -> dict:
    """The dense kernel's inputs for the same function: the logical view of
    both pools, gathered through the table."""
    return dict(q=inp["q"], k=fa.paged_view(inp["pool_k"], inp["table"]),
                v=fa.paged_view(inp["pool_v"], inp["table"]),
                q_offsets=inp["q_offsets"], q_lens=inp["q_lens"])


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
    entries = build_entries(_build.build_log())
    # the bf16 grouped-GEMM kernel keeps its 64 accumulators a thread in
    # registers, and every head-dim-256 flash instance (the decode kernel
    # at 1 and 8 rows, its merge, both chunk tiles; fp32 and bf16; dense
    # and paged) its output: a spill would put them in local memory
    for what, count, picked in (
        ("grouped_gemm_wgmma_kernel", 1,
         [e for e in entries if e["name"] == "grouped_gemm_wgmma_kernel"]),
        ("D 256 flash", 14,
         [e for e in entries if e["name"].startswith("flash_fwd") and "Li256E" in e["mangled"]]),
    ):
        for e in picked:
            log(f"[build] {what} {e['name']}: {e['registers']} registers, {e['spill_stores']} "
                "bytes spill stores")
        if len(picked) != count or any(e["spill_stores"] for e in picked):
            raise AssertionError(f"{what}: kernels missing or spilling: {picked}")


def build_entries(build_log: str) -> list:
    """Each kernel ``nvcc -Xptxas -v`` compiled: its mangled name, template
    name, registers and bytes of spill stores."""
    entries, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r"\d+([a-z_]+kernel)[IE]", m.group(1))
            cur = {"mangled": m.group(1), "name": name.group(1) if name else m.group(1),
                   "registers": None, "spill_stores": None}
            entries.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["spill_stores"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif cur is not None and "Used" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return entries


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
        for case, (inp, extra) in paged_cases(dev, dtype).items():
            out = run_paged(fa.flash_attention_paged, inp, extra)
            ref = run_paged(fa.flash_attention_paged_plain, inp, extra)
            dense = run_flash(fa.flash_attention, gathered(inp), extra)
            inp["pool_k"][-1] = 0
            inp["pool_v"][-1] = 0
            clean = run_paged(fa.flash_attention_paged, inp, extra)
            torch.cuda.synchronize(dev)
            err = within(out, ref)
            if not torch.equal(out, clean):
                raise AssertionError(f"flash_paged {case}: the trash page changed an output")
            for bi, n in enumerate(inp["q_lens"].tolist()):
                if out[bi, n:].any():
                    raise AssertionError(f"flash_paged {case}: row {bi} leaked past q_len={n}")
            errs[("flash_attention_paged", case, dtype)] = err
            log(f"[check] flash_attention_paged {case} {str(dtype)[6:]}: max abs err {err:.3e}; "
                f"vs the dense kernel on the gathered view: max abs diff "
                f"{(out.float() - dense.float()).abs().max().item():.3e}")
        # qwen2-moe's attention: head dim 128, no GQA
        for case, (inp, extra) in flash_cases(dev, dtype, MOE).items():
            out = run_flash(fa.flash_attention, inp, extra)
            err = within(out, run_flash(fa.flash_attention_plain, inp, extra))
            for bi, n in enumerate(inp["q_lens"].tolist()):
                if out[bi, n:].any():
                    raise AssertionError(f"flash d128 {case}: row {bi} leaked past q_len={n}")
            errs[("flash_attention", "d128_" + case, dtype)] = err
            log(f"[check] flash_attention d128 {case} {str(dtype)[6:]}: max abs err {err:.3e}")
        for case, (inp, extra) in paged_cases(dev, dtype, MOE).items():
            out = run_paged(fa.flash_attention_paged, inp, extra)
            err = within(out, run_paged(fa.flash_attention_paged_plain, inp, extra))
            dense = run_flash(fa.flash_attention, gathered(inp), extra)
            errs[("flash_attention_paged", "d128_" + case, dtype)] = err
            log(f"[check] flash_attention_paged d128 {case} {str(dtype)[6:]}: max abs err "
                f"{err:.3e}; vs the dense kernel on the gathered view: max abs diff "
                f"{(out.float() - dense.float()).abs().max().item():.3e}")
        # qwen3-14b's attention: head dim 128, GQA 40 / 8 (5 query heads a KV
        # head: decode rows on the decode kernel's 16-row instance)
        for case, (inp, extra) in flash_cases(dev, dtype, QWEN3).items():
            out = run_flash(fa.flash_attention, inp, extra)
            err = within(out, run_flash(fa.flash_attention_plain, inp, extra))
            for bi, n in enumerate(inp["q_lens"].tolist()):
                if out[bi, n:].any():
                    raise AssertionError(f"flash d128g5 {case}: row {bi} leaked past q_len={n}")
            errs[("flash_attention", "d128g5_" + case, dtype)] = err
            log(f"[check] flash_attention d128 GQA 40/8 {case} {str(dtype)[6:]}: max abs err "
                f"{err:.3e}")
        # zamba2-2.7b's shared attention: head dim 80, no GQA (decode rows on
        # the split-KV decode kernel); every output dim held to the plain
        # version
        for case, (inp, extra) in flash_cases(dev, dtype, ZAMBA).items():
            out = run_flash(fa.flash_attention, inp, extra)
            err = within(out, run_flash(fa.flash_attention_plain, inp, extra))
            for bi, n in enumerate(inp["q_lens"].tolist()):
                if out[bi, n:].any():
                    raise AssertionError(f"flash d80 {case}: row {bi} leaked past q_len={n}")
            errs[("flash_attention", "d80_" + case, dtype)] = err
            log(f"[check] flash_attention d80 {case} {str(dtype)[6:]}: max abs err {err:.3e}")
        for case, (inp, extra) in paged_cases(dev, dtype, ZAMBA).items():
            out = run_paged(fa.flash_attention_paged, inp, extra)
            err = within(out, run_paged(fa.flash_attention_paged_plain, inp, extra))
            dense = run_flash(fa.flash_attention, gathered(inp), extra)
            if not torch.equal(out, dense):
                raise AssertionError(f"flash_paged d80 {case}: differs from the dense kernel "
                                     "on the gathered view")
            errs[("flash_attention_paged", "d80_" + case, dtype)] = err
            log(f"[check] flash_attention_paged d80 {case} {str(dtype)[6:]}: max abs err "
                f"{err:.3e}; equal to the dense kernel on the gathered view")
        # gemma-7b's attention: head dim 256, no GQA (decode rows on the
        # decode kernel's 1-row instance); every case launched twice gives
        # the same bits; paged at P 16, 64 and 48, plain and with window 64
        # + softcap 50, bit-equal to the dense kernel on the gathered view
        for case, (inp, extra) in flash_cases(dev, dtype, GEMMA).items():
            out = run_flash(fa.flash_attention, inp, extra)
            again = run_flash(fa.flash_attention, inp, extra)
            err = within(out, run_flash(fa.flash_attention_plain, inp, extra))
            if not torch.equal(out, again):
                raise AssertionError(f"flash d256 {case}: two launches differ")
            for bi, n in enumerate(inp["q_lens"].tolist()):
                if out[bi, n:].any():
                    raise AssertionError(f"flash d256 {case}: row {bi} leaked past q_len={n}")
            errs[("flash_attention", "d256_" + case, dtype)] = err
            log(f"[check] flash_attention d256 {case} {str(dtype)[6:]}: max abs err {err:.3e}, two "
                "launches bit-identical")
        for case, (inp, extra) in paged_cases(dev, dtype, GEMMA).items():
            out = run_paged(fa.flash_attention_paged, inp, extra)
            again = run_paged(fa.flash_attention_paged, inp, extra)
            err = within(out, run_paged(fa.flash_attention_paged_plain, inp, extra))
            dense = run_flash(fa.flash_attention, gathered(inp), extra)
            if not (torch.equal(out, dense) and torch.equal(out, again)):
                raise AssertionError(f"flash_paged d256 {case}: not bit-equal to the dense kernel "
                                     "on the gathered view, or to itself")
            for bi, n in enumerate(inp["q_lens"].tolist()):
                if out[bi, n:].any():
                    raise AssertionError(f"flash_paged d256 {case}: row {bi} leaked past q_len={n}")
            errs[("flash_attention_paged", "d256_" + case, dtype)] = err
            log(f"[check] flash_attention_paged d256 {case} {str(dtype)[6:]}: max abs err "
                f"{err:.3e}; equal to the dense kernel on the gathered view, two launches "
                "bit-identical")
        for arch, tag in ((LLAMA, "d64"), (ZAMBA, "d80"), (MOE, "d128"), (GEMMA, "d256")):
            dense_inp, paged_inp = ragged_chunk_cases(dev, dtype, arch)
            out = run_flash(fa.flash_attention, dense_inp, {})
            err = within(out, run_flash(fa.flash_attention_plain, dense_inp, {}))
            paged = run_paged(fa.flash_attention_paged, paged_inp, {})
            p_err = within(paged, run_paged(fa.flash_attention_paged_plain, paged_inp, {}))
            if not torch.equal(paged, run_flash(fa.flash_attention, gathered(paged_inp), {})):
                raise AssertionError(f"flash_paged {tag} sq100: differs from the dense kernel "
                                     "on the gathered view")
            errs[("flash_attention", f"{tag}_sq100", dtype)] = err
            errs[("flash_attention_paged", f"{tag}_sq100_P64", dtype)] = p_err
            log(f"[check] flash_attention {tag} sq100 depths 0/1000 {str(dtype)[6:]}: max abs err "
                f"{err:.3e}; paged P64 {p_err:.3e}, equal to the dense kernel on the gathered view")
        for case, inp in gg_cases(dev, dtype).items():
            out = run_gg(gg.grouped_gemm, inp)
            err = within(out, run_gg(gg.grouped_gemm_plain, inp))
            gs = inp["group_sizes"]
            errs[("grouped_gemm", case, dtype)] = err
            log(f"[check] grouped_gemm {case} {str(dtype)[6:]} x {tuple(inp['x'].shape)} w "
                f"{tuple(inp['w'].shape)}: {int((gs > 0).sum())} experts with rows, largest "
                f"group {int(gs.max())}: max abs err {err:.3e}")
            del out
    return errs


def rms_case(x, w, what, errs, key, *, kernel) -> None:
    """One RMSNorm check: the kernel ``kernel`` ("rows" or "generic") ran
    once per call, within tolerance of the plain version, and two launches
    are bit-identical."""
    before = (rn.rows_launches, rn.generic_launches)
    out, again = rn.rmsnorm(x, w), rn.rmsnorm(x, w)
    ref = rn.rmsnorm_plain(x, w)
    torch.cuda.synchronize(x.device)
    ran = (rn.rows_launches - before[0], rn.generic_launches - before[1])
    if ran != ((2, 0) if kernel == "rows" else (0, 2)):
        raise AssertionError(f"rmsnorm {what}: expected the {kernel} kernel, launches {ran}")
    err = within(out, ref)
    if not torch.equal(out, again):
        raise AssertionError(f"rmsnorm {what}: two launches differ")
    errs[key] = err
    log(f"[check] rmsnorm {what} {str(x.dtype)[6:]} on {kernel}: max abs err {err:.3e}, two "
        "launches bit-identical")


def phase_check_rmsnorm(dev) -> dict:
    """RMSNorm against its plain version, fp32 and bf16: every main-path
    shape of ``RMS_SHAPES`` on the rows kernel (its instance), row counts
    that leave a block's last row groups idle (517, 20483) and one row;
    the generic kernel at widths no instance covers (100: element loads;
    1000: 16-byte loads) and at a misaligned x or w."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for nrows, d, what in RMS_SHAPES:
            x, w = rms_inputs(dev, dtype, rows=nrows, d=d)
            rms_case(x, w, f"[{nrows}, {d}] ({what}; {rn.plan(d, dtype).instance})", errs,
                     ("rmsnorm", f"{nrows}x{d}", dtype), kernel="rows")
        for nrows, d in ((517, 2048), (20483, 128), (1, 5120), (1, 128), (3, 4608)):
            x, w = rms_inputs(dev, dtype, rows=nrows, d=d)
            rms_case(x, w, f"[{nrows}, {d}]", errs, ("rmsnorm", f"{nrows}x{d}", dtype),
                     kernel="rows")
        for nrows, d in ((8, 100), (512, 1000), (3, 1000)):
            x, w = rms_inputs(dev, dtype, rows=nrows, d=d)
            rms_case(x, w, f"[{nrows}, {d}]", errs, ("rmsnorm", f"{nrows}x{d}", dtype),
                     kernel="generic")
        x, w = rms_inputs(dev, dtype, rows=65, d=2048)
        x_off = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view_as(x).copy_(x)
        w_off = torch.empty(w.numel() + 1, device=dev)[1:].copy_(w)
        rms_case(x_off, w, "[65, 2048] x off 16-byte alignment", errs,
                 ("rmsnorm", "65x2048_x_misaligned", dtype), kernel="generic")
        rms_case(x, w_off, "[65, 2048] w off 16-byte alignment", errs,
                 ("rmsnorm", "65x2048_w_misaligned", dtype), kernel="generic")
    return errs


def rows_sizes(m, *, e_real=60, e_pad=64, seed=SEED):
    """Group sizes of ``m`` rows spread uniformly at random over the
    ``e_real`` real of ``e_pad`` experts (any M, unlike ``routed_sizes``)."""
    rng = np.random.default_rng(seed)
    return np.bincount(rng.integers(0, e_real, size=m), minlength=e_pad).tolist()


def phase_check_gg_split(dev) -> dict:
    """The bf16 grouped GEMM's split-K (qwen2-moe's shapes): M on each side
    of the split threshold this card's SM count gives (``gg.split_k``), a K
    of 1416 whose last split ends in an 8-deep tail, two launches of one
    input bit-identical, and every case again, interleaved three times
    (a unit counter or an arrival counter left unreset would change an
    output); bf16 within atol 1e-2 + rtol 1e-2 of the plain version."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dtype = torch.bfloat16
    cases = {}
    for proj, (k, n) in GG_SHAPES.items():
        m_split = max(m for m in range(1, 1024) if gg.split_k(m, k, n, 64, sms) > 1)
        for m in (m_split, m_split + 1):
            cases[f"{proj}_m{m}"] = gg_inputs(dev, dtype, sizes=rows_sizes(m), k=k, n=n)
        cases[f"{proj}_k1416_decode"] = gg_inputs(dev, dtype, sizes=routed_sizes(8), k=1416, n=n)
    errs, refs, split = {}, {}, set()
    for case, inp in cases.items():
        m, k = inp["x"].shape
        n = inp["w"].shape[2]
        splits = gg.split_k(m, k, n, 64, sms)
        split.add(splits > 1)
        out = run_gg(gg.grouped_gemm, inp)
        again = run_gg(gg.grouped_gemm, inp)
        refs[case] = run_gg(gg.grouped_gemm_plain, inp)
        torch.cuda.synchronize(dev)
        err = within(out, refs[case])
        if not torch.equal(out, again):
            raise AssertionError(f"grouped_gemm {case}: two launches differ")
        errs[("grouped_gemm", case, dtype)] = err
        bounds = gg.split_ranges(k, splits)
        log(f"[check] grouped_gemm split-K {case} bf16 x {tuple(inp['x'].shape)} w "
            f"{tuple(inp['w'].shape)}: {splits} K split(s) {bounds}: max abs err {err:.3e}, two "
            "launches bit-identical")
    if split != {False, True}:
        raise AssertionError("grouped_gemm split-K cases do not fall on both sides of the threshold")
    worst = 0.0
    for _ in range(3):
        for case, inp in cases.items():
            worst = max(worst, within(run_gg(gg.grouped_gemm, inp), refs[case]))
    log(f"[check] grouped_gemm split-K: {len(cases)} shapes interleaved 3 times: max abs err "
        f"{worst:.3e}")
    return errs


def phase_check_decode(dev) -> dict:
    """The split-KV decode kernel against its plain version at each served
    model's heads, one query a row at depths 0, split-1, split, split+1 and
    2047 and an idle row (q_len 0), plain and with window 64 + softcap 50;
    dense, and paged at P 16, 48 and 64.  Paged must equal the dense kernel
    on the gathered view bit for bit, with the trash page's garbage and with
    it zeroed; every case launched twice must give the same bits."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for arch, tag in ((LLAMA, "d64"), (MOE, "d128"), (ZAMBA, "d80"), (QWEN3, "d128g5"),
                          (GEMMA, "d256"), (GEMMA2, "d128g2")):
            hk = HEADS[arch]
            split = fa._decode_split(dtype, hk["d"])
            depths, lens = [0, split - 1, split, split + 1, 2047, 1000], [1, 1, 1, 1, 1, 0]
            for extra in ({}, {"window": 64, "softcap": 50.0}):
                case = f"{tag}_decode_split" + ("_window_softcap" if extra else "")
                inp = flash_inputs(dev, dtype, sq=1, depths=depths, q_lens=lens, **hk)
                before = fa.decode_launches
                out = run_flash(fa.flash_attention, inp, extra)
                again = run_flash(fa.flash_attention, inp, extra)
                ref = run_flash(fa.flash_attention_plain, inp, extra)
                torch.cuda.synchronize(dev)
                if fa.decode_launches != before + 2:
                    raise AssertionError(f"flash {case}: the decode kernel did not run")
                err = within(out, ref)
                if not torch.equal(out, again) or out[lens.index(0)].any():
                    raise AssertionError(f"flash {case}: two launches differ, or an idle row leaked")
                errs[("flash_attention", case, dtype)] = err
                p_errs = []
                for P in (16, 48, 64):
                    pin = paged_inputs(dev, dtype, P=P, depths=depths, q_lens=lens, sq=1, **hk)
                    out = run_paged(fa.flash_attention_paged, pin, extra)
                    again = run_paged(fa.flash_attention_paged, pin, extra)
                    ref = run_paged(fa.flash_attention_paged_plain, pin, extra)
                    dense = run_flash(fa.flash_attention, gathered(pin), extra)
                    pin["pool_k"][-1] = 0
                    pin["pool_v"][-1] = 0
                    clean = run_paged(fa.flash_attention_paged, pin, extra)
                    torch.cuda.synchronize(dev)
                    p_err = within(out, ref)
                    if not (torch.equal(out, dense) and torch.equal(out, clean)
                            and torch.equal(out, again)):
                        raise AssertionError(f"flash_paged {case} P{P}: not bit-equal to the dense "
                                             "kernel, to the clean trash page, or to itself")
                    if out[lens.index(0)].any():
                        raise AssertionError(f"flash_paged {case} P{P}: an idle row leaked")
                    errs[("flash_attention_paged", f"{case}_P{P}", dtype)] = p_err
                    p_errs.append(p_err)
                log(f"[check] flash decode kernel {case} {str(dtype)[6:]} depths {depths} q_lens "
                    f"{lens}: dense max abs err {err:.3e}; paged P16/P48/P64 "
                    + "/".join(f"{e:.3e}" for e in p_errs)
                    + ", each bit-equal to the dense kernel (garbage and zeroed trash page) and "
                    "two launches bit-identical")
    return errs


def full_cfg(arch=LLAMA, **kw):
    kw = dict(dict(scan_layers=False, remat=False, attention_impl="pallas"), **kw)
    return dataclasses.replace(get_config(arch), **kw)


def free_card() -> None:
    """Return what dropped engines and weights held to the card."""
    gc.collect()
    torch.cuda.empty_cache()


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


ENGINE_REPEATS = 3


def phase_serve(dev, arch=LLAMA) -> dict:
    tag = f"[serve{TAGS[arch]}]"
    want = path(arch, paged=False)
    cfg = full_cfg(arch)
    log(f"{tag} host: {host_line()}")
    log(f"{tag} repro_torch.launch.serve.main(['--arch', '{arch}']) — CLI defaults")
    reset_counts()
    t0 = time.perf_counter()
    engine, reqs = serve.main(["--arch", arch])
    torch.cuda.synchronize(dev)
    cli_counts = counts()
    log(f"{tag} cli: {time.perf_counter() - t0:.1f}s incl. init, launches {cli_counts}")
    require(cli_counts, want, "dense serve CLI")
    require_per_forward(cli_counts, cfg, "dense serve CLI")
    if not all(r.done and len(r.out_tokens) == r.max_new_tokens for r in reqs):
        raise AssertionError("the CLI left requests unserved")
    del engine
    free_card()

    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    eng = make_engine(cfg, params, dev, slots=8, max_len=2048)
    pl = eng.placement_result
    log(f"{tag} engine: placement method={pl.method} devices={sorted(set(pl.placement.values()))} "
        f"stages={len(eng.executor.stages)} (layers {[s.layer_ids for s in eng.executor.stages]}); "
        f"card memory allocated {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
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
        require(eng_counts, want, "dense engine")
        require_per_forward(eng_counts, cfg, "dense engine")
        require_chunk_tile(eng_counts, False, "dense engine")
        for r in reqs:
            if not (r.done and len(r.out_tokens) == 32
                    and all(0 <= t < cfg.vocab_size for t in r.out_tokens)):
                raise AssertionError(f"request {r.rid} not served right: {r.out_tokens}")
        out = [r.out_tokens for r in reqs]
        same = "" if first_tokens is None else f", tokens as run 1: {out == first_tokens}"
        first_tokens = first_tokens or out
        log(f"{tag} engine run {rep + 1}/{ENGINE_REPEATS}: 16 requests, {prompt_toks} prompt "
            f"tokens, {toks} generated tokens in {wall:.3f}s = {toks / wall:.1f} generated "
            f"tok/s, {(toks + prompt_toks) / wall:.1f} processed tok/s; launches "
            f"{eng_counts}{same}")
    log(f"{tag} engine gen tok/s over {ENGINE_REPEATS} runs: {[round(x, 1) for x in tok_s]}, "
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
    log(f"{tag} launches per fused forward: {per_fwd}")
    require_per_forward(per_fwd, cfg, "fused forward")
    del logits
    phase_trace(eng, cfg, dev, tag=f"[trace{TAGS[arch]}]")
    del eng, params
    free_card()
    return {"cli": cli_counts, "per_forward": per_fwd, "tok_s": tok_s}


def phase_trace(eng, cfg, dev, tag="[trace]") -> None:
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
    report_trace(prof, wall, tag, "16 engine steps")
    eng.run_until_drained()


def device_busy_s(prof) -> float:
    """Seconds the card was busy: the union of the device-side events'
    intervals, so kernels that overlap (the decode merge, launched as a
    programmatic dependent, starts before the decode kernel ends) count
    once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and e.time_range.end > e.time_range.start)
    busy, lo, hi = 0, None, None
    for s, e in spans:
        if hi is None or s > hi:
            busy += 0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return (busy + (0 if hi is None else hi - lo)) / 1e6


def report_trace(prof, wall, tag, what) -> None:
    """Device time by kernel (device-side rows only) and the card's idle
    share of ``wall``."""
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
    busy = device_busy_s(prof)
    log(f"{tag} {what}: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms (kernel "
        f"times summed {sum(r[0] for r in rows) / 1e3:.2f} ms), device idle share "
        f"{1 - busy / wall:.3f}" if rows else
        f"{tag} the profiler recorded no device time: not measured")
    for dt, key, n in sorted(rows, reverse=True)[:12]:
        log(f"{tag}   {dt / 1e3:9.3f} ms {100 * dt / 1e6 / wall:5.1f}% x{n:<5d} {key[:90]}")
    # the flash tiles and the copies (cache writes among them), wherever
    # they rank
    flash = sorted(r for r in rows if "flash_fwd" in r[1])[::-1]
    if flash:
        log(f"{tag}   flash: " + "; ".join(f"{key.split('::', 1)[-1][:62]} {dt / 1e3:.3f} ms x{n}"
                                           for dt, key, n in flash))
    gemm = sorted(r for r in rows if "grouped_gemm" in r[1])[::-1]
    if gemm:
        log(f"{tag}   grouped GEMM: " + "; ".join(f"{key.split('::', 1)[-1][:62]} {dt / 1e3:.3f} "
                                                  f"ms x{n}" for dt, key, n in gemm))
    norms = sorted(r for r in rows if "rmsnorm" in r[1])[::-1]
    if norms:
        log(f"{tag}   rmsnorm: " + "; ".join(f"{key.split('::', 1)[-1][:62]} {dt / 1e3:.3f} ms "
                                             f"x{n}" for dt, key, n in norms))
    copies = sorted(r for r in rows if "Memcpy" in r[1] or "direct_copy" in r[1])[::-1]
    if copies:
        log(f"{tag}   copies: " + "; ".join(f"{key[:40]} {dt / 1e3:.3f} ms x{n}"
                                           for dt, key, n in copies))


def phase_parity(dev, arch=LLAMA, paged=False) -> None:
    """2 full-width layers in fp32: greedy tokens with the kernels and with
    the plain versions, through a dense engine and (``paged``) a paged one
    (P 64), all identical; then :func:`bf16_prefill_parity`."""
    tag = f"[parity{TAGS[arch]}]"
    # 2 full-width layers in fp32: kernels against plain versions, 32 greedy steps
    tokens = {}
    for impl in ("pallas", "naive"):
        cfg = full_cfg(arch, n_layers=2, dtype="float32", attention_impl=impl)
        params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
        reset_counts()
        _, reqs, _ = serve_engine_run(cfg, params, dev, requests=6, slots=4,
                                      max_len=1024, max_new=32, seed=SEED + 1)
        tokens[impl] = [r.out_tokens for r in reqs]
        got = counts()
        log(f"{tag} fp32 2 layers impl={impl}: launches {got}")
        if impl == "pallas":
            require(got, path(arch, paged=False), "fp32 parity")
            require_per_forward(got, cfg, "fp32 parity")
        if paged:
            eng = make_paged_engine(cfg, params, dev, slots=4, max_len=1024, page_tokens=64)
            reset_counts()
            reqs, _ = drive(eng, cfg, dev, requests=6, max_new=32, seed=SEED + 1)
            tokens[impl + " paged"] = [r.out_tokens for r in reqs]
            got = counts()
            log(f"{tag} fp32 2 layers impl={impl} paged P64: launches {got}")
            if impl == "pallas":
                require(got, path(arch, paged=True), "fp32 paged parity")
                require_per_forward(got, cfg, "fp32 paged parity")
            del eng
        del params
        free_card()
    for name, toks in tokens.items():
        if toks != tokens["naive"]:
            raise AssertionError(f"fp32 greedy tokens differ between {name} and the dense "
                                 "plain path")
    log(f"{tag} fp32 2 layers: greedy tokens identical over 6 requests x 32 steps ("
        + ", ".join(tokens) + ")")
    bf16_prefill_parity(dev, arch, tag)


def bf16_prefill_parity(dev, arch, tag) -> None:
    """bf16 at full depth: one [2, 300] prefill's last-token logits, kernels
    against plain versions (finite; difference and argmax agreement
    reported)."""
    logits = {}
    cfg = full_cfg(arch)
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
    log(f"{tag} bf16 {cfg.n_layers} layers prefill [2, 300]: last-token logit max abs diff "
        f"{diff:.3e}, argmax agreement {agree:.2f} (logit scale "
        f"{logits['naive'].abs().max().item():.2f})")
    del params
    free_card()


GEMMA2_DEEP = 4300      # prompt tokens of the row that passes gemma2's 4096-key window


def phase_parity_gemma2(dev) -> None:
    """gemma2-27b: 2 full-width layers in fp32 (layer 0 local, window 4096;
    layer 1 global), kernels against plain versions through one engine of
    2 slots and max_len 8192 on two requests, one of GEMMA2_DEEP prompt
    tokens: its later prefill chunks (the chunk tile) and every decode step
    (the decode kernel) see the local layer's window mask keys.  Greedy
    tokens must be identical.  Then :func:`bf16_prefill_parity` at 46
    layers.  The fp32 model at full depth (~109 GB) does not fit the card."""
    tag = "[parity-gemma2]"
    tokens = {}
    for impl in ("pallas", "naive"):
        cfg = full_cfg(GEMMA2, n_layers=2, dtype="float32", attention_impl=impl)
        params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
        eng = make_engine(cfg, params, dev, slots=2, max_len=8192)
        rng = np.random.default_rng(SEED + 5)
        reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, size=n).tolist(),
                        max_new_tokens=32) for i, n in enumerate((GEMMA2_DEEP, 700))]
        reset_counts()
        wall = serve_reqs(eng, reqs, dev)
        got = counts()
        tokens[impl] = [r.out_tokens for r in reqs]
        deepest = GEMMA2_DEEP + len(reqs[0].out_tokens) - 1
        log(f"{tag} fp32 2 layers impl={impl}: {wall:.2f}s; row 0 attended from depth "
            f"{deepest} (keys below {deepest - cfg.sliding_window + 1} masked in layer 0's "
            f"{cfg.sliding_window}-key window); launches {got}")
        if impl == "pallas":
            require(got, path(GEMMA2, paged=False), "gemma2 fp32 parity")
            require_per_forward(got, cfg, "gemma2 fp32 parity")
            require_chunk_tile(got, False, "gemma2 fp32 parity")
        if not all(r.done and len(r.out_tokens) == 32 for r in reqs):
            raise AssertionError(f"gemma2 parity requests not served: {tokens[impl]}")
        del eng, params
        free_card()
    if tokens["pallas"] != tokens["naive"]:
        raise AssertionError(f"gemma2 fp32 greedy tokens differ: {tokens}")
    log(f"{tag} fp32 2 layers: greedy tokens identical over 2 requests x 32 steps, one row "
        f"prefilled to {GEMMA2_DEEP} tokens, past layer 0's {cfg.sliding_window}-key window")
    bf16_prefill_parity(dev, GEMMA2, tag)


def shared_prefix_requests(cfg, *, n, prefix, suffix, max_new, rid0=0, seed=SEED):
    """``n`` requests opening with one ``prefix``-token system prompt and a
    suffix of ``suffix`` = (lo, hi) tokens, from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab_size, size=prefix).tolist()
    return [
        Request(rid=rid0 + i, prompt=system + rng.integers(1, cfg.vocab_size, size=int(m)).tolist(),
                max_new_tokens=max_new)
        for i, m in enumerate(rng.integers(suffix[0], suffix[1] + 1, size=n))
    ]


def make_paged_engine(cfg, params, dev, *, slots, max_len, page_tokens, sharing=True):
    return ServingEngine(
        cfg, params, h100_cluster(1), devices=[dev], slots=slots, max_len=max_len,
        plan_cfg=PlanConfig(method="moirai", time_limit=20.0, objective="throughput",
                            serving_slots=slots, kv_page_tokens=page_tokens,
                            prefix_sharing=sharing),
        eos_id=-1,
    )


def serve_reqs(eng, reqs, dev) -> float:
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def phase_parity_paged(dev) -> None:
    """fp32, 2 full-width layers: the paged engine, with prefix sharing and
    without, gives the dense engine's greedy tokens on shared-prefix
    traffic (8 requests, 128-token prefix, 4 slots, pages of 64)."""
    cfg = full_cfg(n_layers=2, dtype="float32")
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    tokens, stats = {}, {}
    for name, kw in (("dense", None), ("paged_shared", True), ("paged_private", False)):
        eng = (make_engine(cfg, params, dev, slots=4, max_len=1024) if kw is None else
               make_paged_engine(cfg, params, dev, slots=4, max_len=1024, page_tokens=64,
                                 sharing=kw))
        reqs = shared_prefix_requests(cfg, n=8, prefix=128, suffix=(30, 200), max_new=16,
                                      seed=SEED + 3)
        reset_counts()
        serve_reqs(eng, reqs, dev)
        got = counts()
        require(got, DENSE_PATH if kw is None else PAGED_PATH, f"parity {name}")
        tokens[name] = [r.out_tokens for r in reqs]
        stats[name] = eng.straggler_report()["kv"]
        log(f"[parity-paged] fp32 2 layers {name}: launches {got}, kv {stats[name]}, "
            f"skipped prefill chunks {eng.prefill_chunks_skipped}")
        del eng
    if stats["paged_shared"]["reused_pages"] == 0:
        raise AssertionError("parity traffic reused no page: sharing was not exercised")
    for name in ("paged_shared", "paged_private"):
        if tokens[name] != tokens["dense"]:
            raise AssertionError(f"fp32 greedy tokens differ between {name} and dense")
    log("[parity-paged] fp32 2 layers: paged (shared and private) greedy tokens identical "
        "to dense over 8 requests x 16 steps")
    del params
    torch.cuda.empty_cache()


PAGED_REPEATS = 3


def phase_serve_paged(dev, arch=LLAMA) -> dict:
    tag = f"[serve{TAGS[arch]}-paged]"
    want = path(arch, paged=True)
    cfg = full_cfg(arch)
    log(f"{tag} repro_torch.launch.serve.main(['--arch', '{arch}', '--kv-page-tokens', '64'])")
    reset_counts()
    t0 = time.perf_counter()
    engine, reqs = serve.main(["--arch", arch, "--kv-page-tokens", "64"])
    torch.cuda.synchronize(dev)
    cli_counts = counts()
    log(f"{tag} cli: {time.perf_counter() - t0:.1f}s incl. init, launches {cli_counts}")
    require(cli_counts, want, "paged serve CLI")
    require_per_forward(cli_counts, cfg, "paged serve CLI")
    if cli_counts["flash_attention"] or cli_counts["flash_attention_decode"]:
        raise AssertionError("the paged CLI run went through the dense flash kernel")
    if not all(r.done and len(r.out_tokens) == r.max_new_tokens for r in reqs):
        raise AssertionError("the paged CLI left requests unserved")
    del engine
    free_card()

    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    mk = lambda rep: shared_prefix_requests(cfg, n=16, prefix=512, suffix=(100, 600),  # noqa: E731
                                            max_new=32, rid0=100 * rep)
    eng = make_paged_engine(cfg, params, dev, slots=8, max_len=2048, page_tokens=64)
    tok_s, paged_tokens = [], None
    prev = {"reused_pages": 0, "cow_copies": 0, "evicted": 0, "alloc": 0}
    skipped0 = 0
    for rep in range(PAGED_REPEATS):
        reqs = mk(rep)
        reset_counts()
        wall = serve_reqs(eng, reqs, dev)
        got = counts()
        require(got, want, "paged engine")
        require_per_forward(got, cfg, "paged engine")
        require_chunk_tile(got, True, "paged engine")
        kv = eng.straggler_report()["kv"]
        delta = {k: kv[k] - prev[k] for k in prev}
        prev = {k: kv[k] for k in prev}
        skipped = eng.prefill_chunks_skipped - skipped0
        skipped0 = eng.prefill_chunks_skipped
        if delta["reused_pages"] <= 0:
            raise AssertionError(f"paged run {rep + 1} reused no page: {kv}")
        for r in reqs:
            if not (r.done and len(r.out_tokens) == 32
                    and all(0 <= t < cfg.vocab_size for t in r.out_tokens)):
                raise AssertionError(f"request {r.rid} not served right: {r.out_tokens}")
        toks = sum(len(r.out_tokens) for r in reqs)
        prompt_toks = sum(len(r.prompt) for r in reqs)
        tok_s.append(toks / wall)
        out = [r.out_tokens for r in reqs]
        same = "" if paged_tokens is None else (
            f", requests with run 1's tokens: {sum(a == b for a, b in zip(out, paged_tokens))}/16")
        paged_tokens = paged_tokens or out
        log(f"{tag} paged run {rep + 1}/{PAGED_REPEATS}: 16 requests, {prompt_toks} "
            f"prompt tokens, {toks} generated in {wall:.3f}s = {toks / wall:.1f} generated "
            f"tok/s; this run: prefix hits (reused pages) {delta['reused_pages']}, COW copies "
            f"{delta['cow_copies']}, evictions {delta['evicted']}, pages allocated "
            f"{delta['alloc']}, skipped prefill chunks {skipped}; launches {got}{same}")
    log(f"{tag} pool stats after {PAGED_REPEATS} runs: {eng.straggler_report()['kv']}")
    reset_counts()
    eng.caches = None
    eng._ensure_caches()
    tokens = torch.randint(1, cfg.vocab_size, (8, 64), dtype=torch.int32)
    eng.executor.forward(tokens, eng.caches, cache_pos=np.zeros(8, np.int32), kind="fused",
                         q_lens=torch.full((8,), 64, dtype=torch.int32),
                         page_table=eng._page_table())
    torch.cuda.synchronize(dev)
    per_fwd = counts()
    log(f"{tag} launches per fused forward: {per_fwd}")
    require_per_forward(per_fwd, cfg, "paged fused forward")
    del eng
    free_card()

    # the same requests through a dense engine, in the same call
    dense = make_engine(cfg, params, dev, slots=8, max_len=2048)
    dense_tok_s, agree = [], None
    for rep in range(2):
        reqs = mk(rep)
        wall = serve_reqs(dense, reqs, dev)
        dense_tok_s.append(sum(len(r.out_tokens) for r in reqs) / wall)
        if rep == 0:
            out = [r.out_tokens for r in reqs]
            same_req = sum(a == b for a, b in zip(out, paged_tokens))
            same_tok = sum(x == y for a, b in zip(out, paged_tokens) for x, y in zip(a, b))
            agree = (same_req, same_tok)
    log(f"{tag} generated tok/s, paged {[round(x, 1) for x in tok_s]} vs dense "
        f"{[round(x, 1) for x in dense_tok_s]} on the same requests; bf16 paged vs dense "
        f"tokens: {agree[0]}/16 requests and {agree[1]}/512 tokens identical (a shared "
        "prefix's KV is computed in another step shape, so bf16 identity is reported, not "
        "required)")
    del dense, params
    free_card()
    return {"cli": cli_counts, "per_forward": per_fwd, "tok_s": tok_s,
            "dense_tok_s": dense_tok_s}

# ---------------------------------------------------------------- SSM/hybrid
# the SSD heads of each model: (H, P, N, G); chunk 128 for both
SSD_HEADS = {MAMBA: dict(h=24, p=64, n=128, g=1), ZAMBA: dict(h=80, p=64, n=64, g=1)}
SSD_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-2}   # max err / max |ref|


def rel_err(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max() / (ref.float().abs().max() + 1e-9)).item()


def ssd_inputs(dev, dtype, *, b, s, h, p, g, n, init, seed=SEED):
    """The reference kernel test's distributions (x, B, C standard normal;
    dt = |N|·0.1 + 0.01; A = −(|N| + 0.5)), drawn on the card; an fp32
    standard-normal initial state when ``init``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=gen, device=dev).to(dtype)
    dt = torch.randn(b, s, h, generator=gen, device=dev).abs() * 0.1 + 0.01
    a = -(torch.randn(h, generator=gen, device=dev).abs() + 0.5)
    bm = torch.randn(b, s, g, n, generator=gen, device=dev).to(dtype)
    cm = torch.randn(b, s, g, n, generator=gen, device=dev).to(dtype)
    st = torch.randn(b, h, p, n, generator=gen, device=dev) if init else None
    return [x, dt, a, bm, cm], st


def check_ssd_case(name, dtype, args, st, chunk, errs) -> None:
    y, fin = ssd.ssd_scan(*args, chunk, st)
    yr, fr = ssd.ssd_scan_plain(*args, chunk, st)
    torch.cuda.synchronize()
    ey, es = rel_err(y, yr), rel_err(fin, fr)
    if not (ey < SSD_TOL[dtype] and es < SSD_TOL[dtype]):
        raise AssertionError(f"ssd_scan {name} {dtype}: y rel err {ey:.3e}, state {es:.3e}")
    errs[("ssd_scan", name, dtype)] = (y.float() - yr.float()).abs().max().item()
    log(f"[check-ssd] {name} {str(dtype)[6:]}: y max err / max |ref| {ey:.3e}, state {es:.3e}")


# the multi-chunk prefill shape: mamba2's heads, 2 rows of 512 tokens
# (four chunks of 128), from a carried state
SSD_PREFILL = dict(b=2, s=512, init=True, **SSD_HEADS[MAMBA])


def phase_check_ssd(dev) -> dict:
    """The SSD kernel against its plain version, fp32 and bf16: the
    reference test's shapes (G 2 and 4, S = 50 not a multiple of the
    chunk), both models' heads at S = 1, 17, 64 and 200, from a zero and a
    random initial state, and the multi-chunk prefill shape; dt zeroed past
    per-row lengths (the fused step's padding) must leave the state of the
    unpadded rows.  Every bf16 call must run the tensor-core kernel and
    every fp32 call the CUDA-core one, and two bf16 launches at each
    fused-chunk shape must be bit-identical."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        before = counts()
        for b, s, h, p, g, n, chunk in ((2, 64, 4, 16, 1, 32, 16), (1, 128, 8, 64, 2, 64, 32),
                                        (2, 50, 4, 16, 4, 32, 16)):
            for init in (False, True):
                args, st = ssd_inputs(dev, dtype, b=b, s=s, h=h, p=p, g=g, n=n, init=init)
                check_ssd_case(f"B{b} S{s} H{h} P{p} G{g} N{n} chunk{chunk} init={init}", dtype,
                               args, st, chunk, errs)
        for arch, hk in SSD_HEADS.items():
            for s in (1, 17, 64, 200):
                for init in (False, True):
                    args, st = ssd_inputs(dev, dtype, b=2, s=s, init=init, **hk)
                    check_ssd_case(f"{arch} S{s} init={init}", dtype, args, st, 128, errs)
        # fused chunk: 8 rows x 64 tokens, carried state (the timed shape)
        for arch, hk in SSD_HEADS.items():
            args, st = ssd_inputs(dev, dtype, b=8, s=64, init=True, **hk)
            check_ssd_case(f"{arch}_fused_chunk", dtype, args, st, 128, errs)
            # as the model runs it: the final state written over the initial
            # one (the cache's own slice)
            yr, fr = ssd.ssd_scan_plain(*args, 128, st)
            y, fin = ssd.ssd_scan(*args, 128, st, out_state=st)
            torch.cuda.synchronize(dev)
            ey, es = rel_err(y, yr), rel_err(st, fr)
            if not (fin.data_ptr() == st.data_ptr() and ey < SSD_TOL[dtype]
                    and es < SSD_TOL[dtype]):
                raise AssertionError(f"ssd_scan {arch} in place {dtype}: y rel err {ey:.3e}, "
                                     f"state {es:.3e}")
            log(f"[check-ssd] {arch}_fused_chunk in place {str(dtype)[6:]}: y max err / max "
                f"|ref| {ey:.3e}, state {es:.3e}")
            if dtype == torch.bfloat16:
                st0 = ssd_inputs(dev, dtype, b=8, s=64, init=True, **hk)[1]
                y1, f1 = ssd.ssd_scan(*args, 128, st0)
                y2, f2 = ssd.ssd_scan(*args, 128, st0)
                torch.cuda.synchronize(dev)
                if not (torch.equal(y1, y2) and torch.equal(f1, f2)):
                    raise AssertionError(f"ssd_scan {arch}_fused_chunk: two bf16 launches differ")
                log(f"[check-ssd] {arch}_fused_chunk bf16: two launches bit-identical")
        args, st = ssd_inputs(dev, dtype, **SSD_PREFILL)
        check_ssd_case(f"{MAMBA} prefill S{SSD_PREFILL['s']}", dtype, args, st, 128, errs)
        lens = [150, 37, 1, 0]
        args, st = ssd_inputs(dev, dtype, b=4, s=150, init=True, **SSD_HEADS[MAMBA])
        keep = torch.arange(150, device=dev)[None, :, None] < torch.tensor(
            lens, device=dev)[:, None, None]
        args[1] = args[1] * keep
        _, fin = ssd.ssd_scan(*args, 128, st)
        worst = 0.0
        for bi, n in enumerate(lens):
            ref = st[bi]
            if n:
                row = [t[bi:bi + 1, :n].contiguous() for t in (args[0], args[1], args[3], args[4])]
                ref = ssd.ssd_scan(row[0], row[1], args[2], row[2], row[3], 128,
                                   st[bi:bi + 1])[1][0]
            worst = max(worst, rel_err(fin[bi], ref))
        torch.cuda.synchronize(dev)
        if not worst < SSD_TOL[dtype]:
            raise AssertionError(f"ssd_scan masked rows {dtype}: state rel err {worst:.3e}")
        log(f"[check-ssd] dt zeroed past lengths {lens} {str(dtype)[6:]}: final state vs the "
            f"state at each length, max err / max |ref| {worst:.3e}")
        got = {k: v - before[k] for k, v in counts().items()}
        mine, other = (("ssd_scan_mma", "ssd_scan_core") if dtype == torch.bfloat16
                       else ("ssd_scan_core", "ssd_scan_mma"))
        if not (got["ssd_scan"] > 0 and got[mine] == got["ssd_scan"] and got[other] == 0):
            raise AssertionError(f"ssd_scan {dtype}: launches by kernel {got}")
        log(f"[check-ssd] {str(dtype)[6:]}: all {got['ssd_scan']} launches ran {mine}")
    return errs


def ssm_prompts(cfg, *, n=8, seed=SEED):
    """``n`` prompts of 100-600 tokens from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=int(m)).tolist()
            for m in rng.integers(100, 601, size=n)]


class FusedDriver:
    """Model-level fused greedy serving, the mirror of
    ``tests/test_fused_step.py::_fused_generate``: one ``fused_step`` per
    step over every row — prefill rows stream their next ``chunk`` tokens,
    decode rows feed their last token, finished rows idle at ``q_len = 0``
    — with S = 1 once every row decodes.  Each step's kernel launches are
    kept beside its S."""

    def __init__(self, model, params, prompts, max_new, dev, *, chunk=64, max_len=2048):
        self.model, self.params, self.prompts = model, params, prompts
        self.max_new, self.chunk, self.dev = max_new, chunk, dev
        b = len(prompts)
        self.caches = model.init_cache(b, max_len, dev)
        self.done = [0] * b
        self.out = [[] for _ in range(b)]
        self.finished = [False] * b
        self.steps = []          # (S, {kernel: launches}) per forward

    def step(self) -> None:
        b = len(self.prompts)
        live = [i for i in range(b) if not self.finished[i]]
        s = self.chunk if any(self.done[i] < len(self.prompts[i]) for i in live) else 1
        toks = np.zeros((b, s), np.int32)
        q_lens = np.zeros(b, np.int32)
        cache_pos = np.zeros(b, np.int32)
        pf = {}
        for i in live:
            if self.done[i] < len(self.prompts[i]):
                n = min(self.chunk, len(self.prompts[i]) - self.done[i])
                toks[i, :n] = self.prompts[i][self.done[i]:self.done[i] + n]
                q_lens[i], cache_pos[i], pf[i] = n, self.done[i], n
            else:
                toks[i, 0] = self.out[i][-1]
                q_lens[i] = 1
                cache_pos[i] = len(self.prompts[i]) + len(self.out[i]) - 1
        before = counts()
        logits, self.caches = self.model.fused_step(
            self.params, {"tokens": torch.from_numpy(toks).to(self.dev)}, self.caches,
            cache_pos, q_lens)
        nxt = logits.argmax(-1).cpu().numpy()
        after = counts()
        self.steps.append((s, {k: after[k] - before[k] for k in after}))
        for i in live:
            if i in pf:
                self.done[i] += pf[i]
                if self.done[i] == len(self.prompts[i]):
                    self.out[i].append(int(nxt[i, pf[i] - 1]))
            else:
                self.out[i].append(int(nxt[i, 0]))
            self.finished[i] = len(self.out[i]) >= self.max_new

    def run(self):
        while not all(self.finished):
            self.step()
        return self.out


def check_forwards(steps, cfg, what, *, kernels=True) -> None:
    """Every forward launched ``norms_per_forward(cfg)`` RMSNorms, all on
    the rows kernel, the SSD kernel once per Mamba layer when S > 1
    and never at S = 1 (the tensor-core kernel in bf16, the CUDA-core one
    in fp32), and (hybrid) one flash kernel per occurrence (the decode
    kernel at S = 1); without kernels, nothing."""
    n_shared = cfg.n_layers // cfg.shared_attn_every if cfg.family == "hybrid" else 0
    rep = cfg.n_heads // cfg.n_kv_heads
    norms = norms_per_forward(cfg)
    for s, d in steps:
        scans = cfg.n_layers if s > 1 else 0
        mma = cfg.dtype == "bfloat16"
        want = {"rmsnorm": norms, "rmsnorm_rows": norms,
                "rmsnorm_generic": 0, "ssd_scan": scans, "ssd_scan_mma": scans if mma else 0,
                "ssd_scan_core": 0 if mma else scans, "flash_attention": n_shared,
                "flash_attention_decode": n_shared if s * rep <= fa._DECODE_ROWS else 0}
        if not kernels:
            want = {k: 0 for k in want}
        other = {k: v for k, v in d.items() if k not in want and v}
        if any(d[k] != v for k, v in want.items()) or other:
            raise AssertionError(f"{what}: a forward at S={s} launched {d}, not {want}")


def phase_serve_ssm(dev, arch) -> dict:
    """Full width, bf16, random weights from a seed: the fused driver over
    8 requests of 100-600 prompt tokens (numpy seed 0), 32 new tokens
    each, chunks of 64, max_len 2048, three runs with fresh caches."""
    tag = "[serve-ssm]"
    cfg = full_cfg(arch)
    model = build_model(cfg)
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"{tag} {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"parameters; card memory allocated after init {torch.cuda.memory_allocated(dev) / 1e9:.2f} "
        f"GB; host: {host_line()}")
    prompts = ssm_prompts(cfg)
    tok_s, first, launches = [], None, None
    for rep in range(ENGINE_REPEATS):
        drv = FusedDriver(model, params, prompts, 32, dev)
        if rep == 0:
            log(f"{tag} {arch}: caches allocated, card memory "
                f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
        reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = drv.run()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        got = counts()
        require(got, ("rmsnorm", "ssd_scan") + (
            ("flash_attention", "flash_attention_decode") if arch == ZAMBA else ()), f"{arch} serve")
        check_forwards(drv.steps, cfg, f"{arch} serve")
        for o in out:
            if not (len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o)):
                raise AssertionError(f"{arch}: a request was not served right: {o}")
        toks = sum(len(o) for o in out)
        tok_s.append(toks / wall)
        same = "" if first is None else f", tokens as run 1: {out == first}"
        first = first or out
        launches = launches or got
        n_big = sum(1 for s, _ in drv.steps if s > 1)
        log(f"{tag} {arch} run {rep + 1}/{ENGINE_REPEATS}: 8 requests, "
            f"{sum(map(len, prompts))} prompt tokens, {toks} generated in {wall:.3f}s = "
            f"{toks / wall:.1f} generated tok/s; {len(drv.steps)} forwards ({n_big} at S=64); "
            f"launches {got}{same}")
    log(f"{tag} {arch} gen tok/s over {ENGINE_REPEATS} runs: {[round(x, 1) for x in tok_s]}; "
        f"peak card memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    del params
    free_card()
    return {"cli": launches, "tok_s": tok_s,
            "per_forward": {k: v for k, v in drv.steps[0][1].items()}}


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def greedy(model, params, prompt, max_new, dev, *, page_tokens=None, max_len=2048):
    """One request alone: ``prefill_chunked`` (64-token chunks), then
    ``decode_step``; dense KV, or page pools through a ``KVPool`` table (as
    ``tests/test_paged_kv.py::_greedy_paged``)."""
    kw, table = {}, None
    if page_tokens is not None:
        pool = KVPool(1, max_len, page_tokens, prefix_sharing=False)
        pool.alloc_sequence(0, list(prompt), min(len(prompt) + max_new, max_len))
        table = torch.from_numpy(pool.table_array()).to(dev)
        kw = dict(caches=model.init_paged_cache(pool.num_pages, page_tokens, 1, dev),
                  page_table=table)
    batch = {"tokens": torch.tensor([prompt], dtype=torch.int32, device=dev)}
    logits, caches = model.prefill_chunked(params, batch, max_len, chunk=64, **kw)
    toks = [int(logits[0].argmax())]
    pos = len(prompt)
    while len(toks) < max_new:
        logits, caches = model.decode_step(
            params, {"tokens": torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev)},
            caches, torch.tensor(pos), page_table=table)
        toks.append(int(logits[0].argmax()))
        pos += 1
    return toks


# a bf16 argmax flip is accepted only where the plain logits tie: their
# top logit exceeds the flipped-to logit by at most this many steps of bf16
# (2^(e-7) for logits of magnitude in [2^e, 2^(e+1))) at the logit scale
BF16_TIE_ULPS = 2


def bf16_tie_bound(scale: float) -> float:
    """The widest plain-logit gap still counted as a bf16 tie: fixed by
    the logit scale, whatever the two paths' measured difference."""
    return BF16_TIE_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7)


def argmax_ties(got, ref) -> list:
    """Rows whose argmax differs between ``got`` and ``ref`` [rows, V],
    each as (row, gap): ``ref``'s top logit minus its logit at ``got``'s
    argmax."""
    g = got.argmax(-1)
    gap = ref.max(-1).values - ref.gather(-1, g[:, None])[:, 0]
    return [(i, gap[i].item()) for i in range(ref.shape[0]) if g[i] != ref[i].argmax()]


def top2_gaps(logits) -> list:
    top = logits.topk(2, dim=-1).values
    return [round(x, 4) for x in (top[:, 0] - top[:, 1]).tolist()]


def phase_parity_ssm(dev) -> dict:
    """fp32 kernels vs plain versions (identical greedy tokens over the
    driver's traffic: mamba2 at full depth, zamba2 at one full-width
    segment); bf16 full depth, one [2, 300] prefill, kernels vs plain
    (last-token logits within 0.1 of the plain path's logit scale; the
    same argmax, except where the plain path's top logit exceeds its
    logit at the kernels' argmax by at most ``BF16_TIE_ULPS`` bf16 steps
    at the logit scale — a tie in the stored logits, reported with its
    gap) and prefill_chunked(64) vs prefill (the same argmax test); zamba2
    paged (P = 64) vs dense, bf16 full depth, identical greedy tokens."""
    tag = "[parity-ssm]"
    for arch, kw in ((MAMBA, {}), (ZAMBA, {"n_layers": 6})):
        tokens = {}
        for impl in ("pallas", "naive"):
            cfg = full_cfg(arch, dtype="float32", attention_impl=impl, **kw)
            model = build_model(cfg)
            params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
            drv = FusedDriver(model, params, ssm_prompts(cfg, seed=SEED + 1), 32, dev)
            reset_counts()
            tokens[impl] = drv.run()
            check_forwards(drv.steps, cfg, f"{arch} fp32 parity {impl}", kernels=impl == "pallas")
            log(f"{tag} {arch} fp32 {cfg.n_layers} layers impl={impl}: {len(drv.steps)} forwards, "
                f"launches {counts()}")
            del params, drv
            free_card()
        if tokens["pallas"] != tokens["naive"]:
            raise AssertionError(f"{arch}: fp32 greedy tokens differ between kernel and plain")
        log(f"{tag} {arch} fp32: greedy tokens identical, kernels vs plain, over 8 requests x 32 "
            "steps")

    paged_launches = None
    for arch in (MAMBA, ZAMBA):
        cfg = full_cfg(arch)
        params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (2, 300), device=dev,
                                         generator=torch.Generator(device=dev).manual_seed(1))}
        logits = {}
        for impl in ("pallas", "naive"):
            m = build_model(dataclasses.replace(cfg, attention_impl=impl))
            logits[impl] = m.prefill(params, batch, 512)[0].float()
        chunked = build_model(cfg).prefill_chunked(params, batch, 512, chunk=64)[0].float()
        torch.cuda.synchronize(dev)
        diff = (logits["pallas"] - logits["naive"]).abs().max().item()
        diff_chunked = (chunked - logits["pallas"]).abs().max().item()
        scale = logits["naive"].abs().max().item()
        if not torch.isfinite(logits["pallas"]).all():
            raise AssertionError(f"{arch}: bf16 full-depth logits are not finite")
        flips = argmax_ties(logits["pallas"], logits["naive"])
        flips_chunked = argmax_ties(chunked, logits["pallas"])
        tie = bf16_tie_bound(scale)
        log(f"{tag} {arch} bf16 {cfg.n_layers} layers prefill [2, 300]: last-token logit max abs "
            f"diff kernels vs plain {diff:.4f} (logit scale {scale:.3f}, bound {0.1 * scale:.4f}); "
            f"plain top-2 gaps {top2_gaps(logits['naive'])}; argmax flips (row, plain gap) {flips}; "
            f"prefill_chunked(64) vs prefill: max abs diff {diff_chunked:.4f}, argmax flips "
            f"{flips_chunked}; a flip passes only at a gap <= {tie:.6f} ({BF16_TIE_ULPS} bf16 "
            f"steps at the logit scale)")
        if not (diff <= 0.1 * scale and all(gap <= tie for _, gap in flips + flips_chunked)):
            raise AssertionError(f"{arch}: bf16 parity failed")
        if arch == ZAMBA:
            prompt = ssm_prompts(cfg, n=1, seed=SEED + 4)[0]
            model = build_model(cfg)
            dense = greedy(model, params, prompt, 32, dev)
            reset_counts()
            paged = greedy(model, params, prompt, 32, dev, page_tokens=64)
            paged_launches = counts()
            require(paged_launches, ("flash_attention_paged", "flash_attention_paged_decode",
                                     "ssd_scan", "rmsnorm"),
                    "zamba2 paged")
            if paged_launches["flash_attention"]:
                raise AssertionError("the paged zamba2 run went through the dense flash kernel")
            if paged != dense:
                raise AssertionError(f"zamba2 paged tokens differ from dense: {paged} vs {dense}")
            log(f"{tag} zamba2 bf16 {cfg.n_layers} layers, {len(prompt)}-token prompt, pages of 64: paged "
                f"greedy tokens identical to dense over 32 steps; paged launches {paged_launches}")
        del params
        free_card()
    return {"paged_cli": paged_launches}


def phase_trace_ssm(dev) -> None:
    """Where a zamba2 serve step's time goes: a profiler trace of 16 steps
    of the fused driver (after one untraced step), device time by kernel
    and the card's idle share."""
    from torch.profiler import ProfilerActivity, profile

    cfg = full_cfg(ZAMBA)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    drv = FusedDriver(model, params, ssm_prompts(cfg, seed=SEED + 2), 64, dev)
    drv.step()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(16):
            drv.step()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    n_big = sum(1 for s, _ in drv.steps[1:] if s > 1)
    report_trace(prof, wall, "[trace-ssm]", f"zamba2 16 driver steps ({n_big} at S=64)")
    del params, drv
    free_card()


def ssd_work(args, st, chunk) -> tuple:
    """Bytes the scan must move (x read, y written, B and C, dt, A, the
    fp32 state read and written) and flops it must do,
    2·L²·N + 2·L²·P + 4·L·N·P per (row, head, chunk of L tokens)."""
    x, dt, a, bm, cm = args
    b, s, h, p = x.shape
    n = bm.shape[3]
    es = x.element_size()
    byts = (2 * x.numel() * es + (bm.numel() + cm.numel()) * es + dt.numel() * 4 + a.numel() * 4
            + b * h * p * n * 4 * (2 if st is not None else 1))
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    flops = b * h * sum(2 * L * L * n + 2 * L * L * p + 4 * L * n * p for L in lens)
    return byts, flops


def time_ssd(dev, flush, rows, dtype) -> None:
    """The SSD kernel at each model's fused-chunk shape (8 rows x 64 tokens,
    chunk 128, carried state updated in place as the model does) and at the
    multi-chunk prefill shape, L2 flushed before each call; no single
    PyTorch call computes the scan, so there is no library time."""
    shapes = {f"{arch}_fused_chunk": dict(b=8, s=64, init=True, **hk)
              for arch, hk in SSD_HEADS.items()}
    shapes[f"{MAMBA}_prefill"] = SSD_PREFILL
    for case, shape in shapes.items():
        args, st = ssd_inputs(dev, dtype, **shape)
        byts, flops = ssd_work(args, st, 128)
        b_ms, b_by = bound(byts, flops, dtype)
        r = rows[("ssd_scan", case)] = dict(
            ms=time_ms(dev, lambda: ssd.ssd_scan(*args, 128, st, out_state=st), flush=flush),
            plain_ms=time_ms(dev, lambda: ssd.ssd_scan_plain(*args, 128, st), iters=10,
                             flush=flush),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=byts, flops=flops,
        )
        log(f"[time] ssd_scan {case} bf16 x {tuple(args[0].shape)} B/C "
            f"{tuple(args[3].shape)}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library none, bound {b_ms:.5f} ms ({b_by}: {byts / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP), kernel/bound {r['ms'] / b_ms:.1f}x")


SPIN_CYCLES = 1_000_000      # ~0.5 ms at the H100's clocks: longer than any call's enqueue


def time_ms(dev, fn, *, iters=50, flush=None) -> float:
    """Mean device time of one call, from CUDA events, after a warm-up.

    With ``flush`` the L2 is flushed before every call, each call timed on
    its own (the main path finds each layer's KV cache cold: 33 MB per
    layer at 8 slots x 2048); a spin kernel after the flush keeps the card
    busy while the host enqueues the call, so the time between the events
    is the call's device time and not its host enqueue (without it, a
    call whose enqueue outlasted the flush was timed at its enqueue).
    Without, the calls run back to back behind one spin kernel, so host
    overhead between calls does not count."""
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
        torch.cuda._sleep(SPIN_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize(dev)
    return float(np.mean([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def host_us(dev, fn, *, iters=200) -> float:
    """Mean host time of one call (argument checks, allocation, launch),
    the card kept busy by a spin kernel so that no call waits on it."""
    fn()
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(40 * SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    return t / iters * 1e6


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


SDPA_WARMUP = 10


def time_sdpa(dev, inp, extra, **kw):
    """The SDPA yardstick timed under each backend that takes the call
    (one that raises is skipped), each after SDPA_WARMUP untimed calls (a
    backend's first calls at a new shape build its plan), so the reading
    depends neither on which backend PyTorch would pick nor on the order of
    the cases: (fastest ms, its backend, every backend's ms), or (None,
    None, {})."""
    fn = sdpa_call(inp, extra)
    if fn is None:
        return None, None, {}
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sweep = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel(backend):
                for _ in range(SDPA_WARMUP):
                    fn()
                torch.cuda.synchronize(dev)
                sweep[name] = time_ms(dev, fn, **kw)
        except RuntimeError:
            continue
    if not sweep:
        return None, None, {}
    best = min(sweep, key=sweep.get)
    return sweep[best], best, sweep


def gg_work(inp) -> tuple:
    """Bytes the grouped GEMM must move and flops it must do for THESE
    inputs: the weights of each expert that has rows, read once; x read
    and out written once; the group sizes."""
    x, w, gs = inp["x"], inp["w"], inp["group_sizes"]
    m, k = x.shape
    n = w.shape[2]
    es = x.element_size()
    touched = int((gs > 0).sum().item())
    byts = touched * k * n * es + m * k * es + m * n * es + 4 * gs.numel()
    return byts, 2 * m * k * n


def gg_library(inp):
    """One PyTorch call for the same function (a yardstick only, never
    called by the port): ``torch._grouped_mm`` where this PyTorch has it,
    else a per-expert ``torch.matmul`` loop.  Returns (label, callable)."""
    x, w, gs = inp["x"], inp["w"], inp["group_sizes"]
    if hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        return "torch._grouped_mm", lambda: torch._grouped_mm(x, w, offs=offs)
    bounds = np.concatenate([[0], np.cumsum(gs.tolist())]).tolist()
    pieces = [(e, a, b) for e, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])) if b > a]
    return "per-expert torch.matmul loop", lambda: [x[a:b] @ w[e] for e, a, b in pieces]


def time_flash(dev, flush, rows, arch, prefix, dtype) -> None:
    """The dense flash kernel at ``arch``'s heads, decode and chunk (and
    window + softcap for llama), and the chunk tile's two probes (8 rows at
    depth 0; one row at depth 1984), L2 flushed before each call."""
    for case, (inp, extra) in flash_cases(dev, dtype, arch).items():
        if arch != LLAMA and extra:
            continue
        byts, flops = flash_work(inp, extra)
        b_ms, b_by = bound(byts, flops, dtype)
        lib_ms, lib, sweep = time_sdpa(dev, inp, extra, iters=20, flush=flush)
        rows[("flash_attention", prefix + case)] = dict(
            ms=time_ms(dev, lambda: run_flash(fa.flash_attention, inp, extra), flush=flush),
            plain_ms=time_ms(dev, lambda: run_flash(fa.flash_attention_plain, inp, extra),
                             iters=10, flush=flush),
            library_ms=lib_ms, library=f"SDPA ({lib})" if lib else None, sdpa_sweep=sweep,
            bound_ms=b_ms, bound_by=b_by,
        )


def time_paged(dev, flush, rows, arch, prefix, dtype) -> None:
    """The paged flash kernel at ``arch``'s heads, P = 64, beside the dense
    kernel at the same depths and the gather + SDPA yardstick."""
    rng = np.random.default_rng(SEED)
    decode = rng.integers(0, 2048, size=8).tolist()
    lens = [64, 1, 0, 64, 17, 1, 64, 0]
    depths = [int(rng.integers(0, 2048 - n + 1)) for n in lens]
    hk = HEADS[arch]
    for case, inp in (
        ("decode", paged_inputs(dev, dtype, P=64, depths=decode, q_lens=[1] * 8, sq=1, shared=0,
                                **hk)),
        ("fused_chunk", paged_inputs(dev, dtype, P=64, depths=depths, q_lens=lens, sq=64,
                                     shared=0, **hk)),
    ):
        dense_inp = gathered(inp)
        byts, flops = flash_work(dense_inp, {})
        # plus the table entries the kernel reads: one per page a row's
        # visible keys touch
        k_end = inp["q_offsets"] + inp["q_lens"]
        byts += int(((k_end + 63) // 64).sum().item()) * 4
        b_ms, b_by = bound(byts, flops, dtype)
        gather = lambda: (fa.paged_view(inp["pool_k"], inp["table"]),  # noqa: E731
                          fa.paged_view(inp["pool_v"], inp["table"]))
        rows[("flash_attention_paged", prefix + case)] = dict(
            ms=time_ms(dev, lambda: run_paged(fa.flash_attention_paged, inp, {}), flush=flush),
            plain_ms=time_ms(dev, lambda: run_paged(fa.flash_attention_paged_plain, inp, {}),
                             iters=10, flush=flush),
            dense_ms=time_ms(dev, lambda: run_flash(fa.flash_attention, dense_inp, {}),
                             flush=flush),
            gather_ms=time_ms(dev, gather, iters=20, flush=flush),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
        )
        r = rows[("flash_attention_paged", prefix + case)]
        r["sdpa_ms"], lib, _ = time_sdpa(dev, dense_inp, {}, iters=20, flush=flush)
        sd = "n/a" if r["sdpa_ms"] is None else f"{r['sdpa_ms']:.4f} ms ({lib})"
        log(f"[time] flash_attention_paged {prefix}{case} P=64 bf16: kernel {r['ms']:.4f} ms, "
            f"dense kernel at the same depths {r['dense_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, yardstick gather {r['gather_ms']:.4f} ms + SDPA {sd}, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), kernel/bound "
            f"{r['ms'] / r['bound_ms']:.1f}x")


def time_gg(dev, flush, rows, dtype) -> None:
    """The grouped GEMM at qwen2-moe's four main-path shapes, L2 flushed
    before each call (the main path meets each layer's experts cold)."""
    for proj, (k, n) in GG_SHAPES.items():
        for routing, tokens in GG_ROUTING.items():
            inp = gg_inputs(dev, dtype, sizes=routed_sizes(tokens), k=k, n=n)
            byts, flops = gg_work(inp)
            b_ms, b_by = bound(byts, flops, dtype)
            label, lib = gg_library(inp)
            ref = run_gg(gg.grouped_gemm_plain, inp)
            lib_out = lib()
            lib_out = torch.cat(lib_out) if isinstance(lib_out, list) else lib_out
            lib_err = (lib_out.float() - ref.float()).abs().max().item()
            m = inp["x"].shape[0]
            splits = gg.split_k(m, k, n, inp["w"].shape[0],
                                torch.cuda.get_device_properties(dev).multi_processor_count)
            r = rows[("grouped_gemm", f"{proj}_{routing}")] = dict(
                ms=time_ms(dev, lambda: run_gg(gg.grouped_gemm, inp), flush=flush),
                plain_ms=time_ms(dev, lambda: run_gg(gg.grouped_gemm_plain, inp), iters=10,
                                 flush=flush),
                library_ms=time_ms(dev, lib, iters=20, flush=flush), library=label,
                bound_ms=b_ms, bound_by=b_by, bytes=byts, flops=flops, splits=splits,
                host_us=host_us(dev, lambda: run_gg(gg.grouped_gemm, inp)),
                library_host_us=host_us(dev, lib),
            )
            log(f"[time] grouped_gemm {proj} {routing} bf16 x {tuple(inp['x'].shape)} w "
                f"{tuple(inp['w'].shape)}, {int((inp['group_sizes'] > 0).sum())} experts with "
                f"rows, {splits} K split(s): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
                f"ms, {label} {r['library_ms']:.4f} ms (max abs diff to plain {lib_err:.3e}), "
                f"bound {b_ms:.5f} ms ({b_by}: {byts / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
                f"kernel/bound {r['ms'] / b_ms:.2f}x; host time a call: kernel "
                f"{r['host_us']:.1f} us, {label} {r['library_host_us']:.1f} us")
            del inp, ref, lib_out


def phase_time(dev) -> dict:
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)   # > 50 MB L2
    rows = {}
    dtype = torch.bfloat16
    time_flash(dev, flush, rows, LLAMA, "", dtype)
    time_paged(dev, flush, rows, LLAMA, "", dtype)
    time_flash(dev, flush, rows, MOE, "d128_", dtype)
    time_paged(dev, flush, rows, MOE, "d128_", dtype)
    time_flash(dev, flush, rows, ZAMBA, "d80_", dtype)
    time_paged(dev, flush, rows, ZAMBA, "d80_", dtype)
    time_flash(dev, flush, rows, GEMMA, "d256_", dtype)
    time_paged(dev, flush, rows, GEMMA, "d256_", dtype)
    for (name, case), r in rows.items():
        if name == "flash_attention_paged":
            continue
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        if r.get("library"):
            lib += f" {r['library']}; every backend " + ", ".join(
                f"{k} {v:.4f}" for k, v in r["sdpa_sweep"].items())
        log(f"[time] {name} {case} bf16: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
            f"kernel/bound {r['ms'] / r['bound_ms']:.1f}x")
    time_gg(dev, flush, rows, dtype)
    time_ssd(dev, flush, rows, dtype)
    del flush
    # RMSNorm back to back (no flush: on the main path x was written by the
    # op just before), with time_grouped_gemm.py --kernel rmsnorm's function
    rows.update({("rmsnorm", case): r for case, r in time_rms(sys.modules[__name__], dev).items()})
    return rows


def decode_entries(name, times, errs, clis) -> dict:
    """The decode kernel's numbers at each head dim for the dense or the
    paged flash row: this run's main-path launches (``clis``: head-dim tag
    → (timing prefix, dense CLI counts, paged CLI counts)), timed decode
    shape, bound, plain and library times, and [check] error."""
    paged = name.endswith("paged")
    count = name + "_decode"
    out = {}
    for tag, (prefix, dense_cli, paged_cli) in clis.items():
        run = paged_cli if paged else dense_cli
        t = times[(name, prefix + "decode")]
        out[tag] = {
            "launches": run[count], "max_abs_err": errs[(name, prefix + (
                "decode_P64" if paged else "decode"), torch.bfloat16)],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        }
    return out


def main() -> int:
    t_start = time.perf_counter()
    card = phase_card()
    dev = card["dev"]
    phase_build()
    errs = phase_check(dev)
    errs.update(phase_check_gg_split(dev))
    errs.update(phase_check_decode(dev))
    errs.update(phase_check_ssd(dev))
    errs.update(phase_check_rmsnorm(dev))
    served = phase_serve(dev)
    phase_parity(dev)
    phase_parity_paged(dev)
    served_paged = phase_serve_paged(dev)
    phase_parity(dev, MOE)
    served_moe = phase_serve(dev, MOE)
    served_moe_paged = phase_serve_paged(dev, MOE)
    phase_parity(dev, QWEN3)
    served_qwen3 = phase_serve(dev, QWEN3)
    phase_parity(dev, GEMMA, paged=True)
    served_gemma = phase_serve(dev, GEMMA)
    served_gemma_paged = phase_serve_paged(dev, GEMMA)
    phase_parity_gemma2(dev)
    free_card()
    served_gemma2 = phase_serve(dev, GEMMA2)
    served_mamba = phase_serve_ssm(dev, MAMBA)
    served_zamba = phase_serve_ssm(dev, ZAMBA)
    parity_ssm = phase_parity_ssm(dev)
    phase_trace_ssm(dev)
    times = phase_time(dev)

    # the split-KV decode kernel's numbers at each head dim, dense and paged
    clis = {"d64": ("", served["cli"], served_paged["cli"]),
            "d128": ("d128_", served_moe["cli"], served_moe_paged["cli"]),
            "d80": ("d80_", served_zamba["cli"], parity_ssm["paged_cli"]),
            "d256": ("d256_", served_gemma["cli"], served_gemma_paged["cli"])}
    decode = {name: decode_entries(name, times, errs, clis)
              for name in ("flash_attention", "flash_attention_paged")}
    kernels = []
    for name, case, err_case, run, source, replaces in (
        ("flash_attention", "fused_chunk", "fused_chunk", served,
         "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:41"),
        ("flash_attention_paged", "fused_chunk", "fused_chunk_P64", served_paged,
         "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:120"),
        ("rmsnorm", "512x2048", "512x2048", served, "src/repro_torch/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm/kernel.py:22"),
        ("grouped_gemm", "gate_up_chunk", "gate_up_chunk", served_moe,
         "src/repro_torch/csrc/grouped_gemm.cu",
         "src/repro/kernels/grouped_gemm/kernel.py:29"),
    ):
        t = times[(name, case)]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": run["cli"][name],
            "max_abs_err": errs[(name, err_case, torch.bfloat16)],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": case, "launches_per_forward": run["per_forward"][name],
        }
        if name == "flash_attention_paged":
            row.update(dense_ms=t["dense_ms"], yardstick_gather_ms=t["gather_ms"],
                       yardstick_sdpa_ms=t["sdpa_ms"])
        if name.startswith("flash_attention"):
            # the head-dim-128 instance, on qwen2-moe's serve path
            t128 = times[(name, "d128_fused_chunk")]
            moe_run = served_moe_paged if name.endswith("paged") else served_moe
            row["d128"] = {
                "launches": moe_run["cli"][name], "ms": t128["ms"], "plain_ms": t128["plain_ms"],
                "bound_ms": t128["bound_ms"], "bound_by": t128["bound_by"],
                "library_ms": t128["library_ms"],
                "max_abs_err": errs[(name, "d128_" + err_case, torch.bfloat16)],
            }
            # the head-dim-80 instance, on zamba2's shared attention
            t80 = times[(name, "d80_fused_chunk")]
            row["d80"] = {
                "launches": (parity_ssm["paged_cli"] if name.endswith("paged")
                             else served_zamba["cli"])[name],
                "ms": t80["ms"], "plain_ms": t80["plain_ms"], "bound_ms": t80["bound_ms"],
                "bound_by": t80["bound_by"], "library_ms": t80["library_ms"],
                "max_abs_err": errs[(name, "d80_" + err_case, torch.bfloat16)],
            }
            # the head-dim-256 instance, on gemma-7b's serve path
            t256 = times[(name, "d256_fused_chunk")]
            gemma_run = served_gemma_paged if name.endswith("paged") else served_gemma
            row["d256"] = {
                "launches": gemma_run["cli"][name],
                "launches_per_forward": gemma_run["per_forward"][name],
                "ms": t256["ms"], "plain_ms": t256["plain_ms"], "bound_ms": t256["bound_ms"],
                "bound_by": t256["bound_by"], "library_ms": t256["library_ms"],
                "max_abs_err": errs[(name, "d256_" + err_case, torch.bfloat16)],
            }
            row["decode"] = decode[name]
        if name == "grouped_gemm":
            # the four main-path shapes: gate/up and down at decode and chunk
            row.update(library=t["library"], paged_launches=served_moe_paged["cli"][name],
                       shapes={c: {key: times[(name, c)][key] for key in (
                           "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "splits",
                           "host_us", "library_host_us")}
                           for c in ("gate_up_decode", "gate_up_chunk", "down_decode",
                                     "down_chunk")})
        if name == "rmsnorm":
            # every timed shape (its instance, floor and yardsticks) and each
            # served configuration's launches: the CLI run (the SSM models:
            # the first of their three runs) and one fused forward
            row["shapes"] = {c: dict(times[(name, c)], max_abs_err=errs[(name, c, torch.bfloat16)])
                             for _, c in sorted(k for k in times if k[0] == name)}
            row["launches_by_config"] = {
                arch: {"launches": run["cli"][name], "launches_per_forward": run["per_forward"][name],
                       "rows_kernel": run["cli"]["rmsnorm_rows"]}
                for arch, run in ((LLAMA, served), (MOE, served_moe), (QWEN3, served_qwen3),
                                  (GEMMA, served_gemma), (GEMMA2, served_gemma2),
                                  (MAMBA, served_mamba), (ZAMBA, served_zamba))}
        kernels.append(row)
    # the split-KV decode kernel (and its merge) as kernels of their own:
    # D 64 at the top, D 128, D 80 and D 256 nested, as the chunk rows
    for name, dec in decode.items():
        kernels.append(dict(
            name=name + "_decode", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:" + (
                "120" if name.endswith("paged") else "41"),
            shape="decode", d128=dec["d128"], d80=dec["d80"], d256=dec["d256"], **dec["d64"]))
    t_m, t_z = (times[("ssd_scan", f"{a}_fused_chunk")] for a in (MAMBA, ZAMBA))
    t_p = times[("ssd_scan", f"{MAMBA}_prefill")]
    kernels.append({
        "name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:31",
        "launches": served_mamba["cli"]["ssd_scan"],
        "max_abs_err": errs[("ssd_scan", f"{MAMBA}_fused_chunk", torch.bfloat16)],
        "ms": t_m["ms"], "plain_ms": t_m["plain_ms"], "bound_ms": t_m["bound_ms"],
        "bound_by": t_m["bound_by"], "library_ms": None, "shape": "mamba2_fused_chunk",
        "launches_per_forward": served_mamba["per_forward"]["ssd_scan"],
        "zamba2": {
            "launches": served_zamba["cli"]["ssd_scan"],
            "launches_per_forward": served_zamba["per_forward"]["ssd_scan"],
            "ms": t_z["ms"], "plain_ms": t_z["plain_ms"], "bound_ms": t_z["bound_ms"],
            "bound_by": t_z["bound_by"], "library_ms": None,
            "max_abs_err": errs[("ssd_scan", f"{ZAMBA}_fused_chunk", torch.bfloat16)],
        },
        "mamba2_prefill": {
            "shape": "2 x 512 tokens, chunk 128, carried state",
            "ms": t_p["ms"], "plain_ms": t_p["plain_ms"], "bound_ms": t_p["bound_ms"],
            "bound_by": t_p["bound_by"], "library_ms": None,
            "max_abs_err": errs[("ssd_scan", f"{MAMBA} prefill S{SSD_PREFILL['s']}",
                                 torch.bfloat16)],
        },
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
