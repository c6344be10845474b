"""Chip smoke test of the PyTorch/CUDA port: the quickest proof that it
builds, is right and serves on an NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the card: name, count, ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a) and
   print what ``-Xptxas -v`` reports for each — on a thread, while phase
   13's ``[train]``, ``[placeto]`` and ``[calibrate]`` (which launch no
   kernel) run first;
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
   bit-identical); ``[check] flash verify rows``: a speculative round's
   verify rows (q_len = Sq > 1 at decode depth: depths 0, split-1, split
   and 2048-Sq, beside a decode row and an idle row) at the six served head
   configurations, Sq from 2 to the decode kernel's last width and the
   first chunk-tile width, fp32 and bf16, plain and window 64 + softcap
   50, dense and paged (P 16, 64): the route asserted by the launch
   counters, within tolerance, bit-identical twice, zeros past q_len,
   paged bit-equal to dense;
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
   Every forward must launch the grouped-GEMM kernel 3 times a layer (3 ×
   24 in the CLI runs; the engines run 12 layers: ``SERVE_LAYERS``), and the
   head-dim-128 flash kernel must have launched. Then qwen3-14b (40
   layers, d_model 5120, per-head q/k norms, GQA 40 / 8 at D 128, ~29.5 GB
   bf16): ``[parity-qwen3]`` as phase 5, ``[serve-qwen3]`` and
   ``[trace-qwen3]`` as phase 4 (the CLI at 40 layers, the engine's runs
   and trace at 20: ``SERVE_LAYERS``). gemma-7b (28 layers, d_model 3072, 16
   heads of 256, GeGLU, tied and scaled embeddings, ~17.1 GB bf16):
   ``[parity-gemma]`` (phase 5, the fp32 engines dense and paged),
   ``[serve-gemma]``, ``[trace-gemma]`` and ``[serve-gemma-paged]`` (phases
   4 and 6; the engines at 14 of 28 layers). gemma2-27b (46 layers, window 4096 on every other layer,
   softcaps, post-norms, ~54.4 GB bf16): ``[parity-gemma2]`` (2 fp32
   layers, one row prefilled to 4300 tokens so the local layer's window
   masks keys in both the chunk tile and the decode kernel; 46 bf16
   layers' prefill logits), ``[serve-gemma2]`` and ``[trace-gemma2]``,
   dense KV (the CLI at 46 layers, the engine at 24). Every engine run's chunk steps must run a chunk tile. In
   every serve and parity run each forward must launch
   ``norms_per_forward(cfg)`` RMSNorms (2 a block, + 2 for q/k norms, + 2
   for post-norms, 2 a Mamba layer, + 1; qwen3-14b 161 (81 at 20 layers),
   gemma-7b 57 (29 at 14), gemma2-27b 185 (97 at 24)), every one on the
   rows kernel;
8. SSM and hybrid: ``[check-ssd]`` holds the SSD chunked-scan kernel to
   its plain version (fp32 and bf16 within 1e-5 and 4e-2 of max |ref|,
   for y and the final state) at the reference test's shapes, both
   models' heads at S = 1, 17, 64, 200, from zero and random initial
   states, at mamba2's multi-chunk prefill (2 rows of 512 tokens, four
   chunks, a carried state), with the final state written over the
   initial one (as the model updates its cache), and with dt zeroed past
   per-row lengths; every bf16 call must run the tensor-core kernel and
   every fp32 call the CUDA-core one (counted by kernel), and two bf16
   launches at each fused-chunk shape must be bit-identical; and at
   [mesh-ssm]'s prefill on one rank (40 of zamba2's 80 heads, 4 and 8
   rows of 256 tokens); phase 3 also holds both flash kernels at zamba2's
   head dim 80 (32 heads, no GQA), and the dense one as a rank of
   [mesh-ssm] runs it (16 / 16 heads, Sq 256 at depth 0 and decode rows,
   over 272 keys).
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
   paged (P = 64) gives dense's greedy tokens.  ``[trace-ssm]`` (zamba2 at
   18 layers): a
   profiler trace of 16 zamba2 driver steps;
9. speculation (llama3.2-1b, then the SSM families): ``[parity-spec]``,
   fp32 full width at 8 layers, 8 slots, max_len 2048, 16 requests of 100–600 prompt
   tokens, 32 new: the speculative engine's tokens equal the plain
   engine's at k = 3 ([8, 4] verify rows on the decode kernel) and k = 4
   (the chunk tile), dense and paged (P 64), with a draft of the target's
   weights + 2e-3 N(0, 1) (acceptance partial), and with the target as
   its own draft (every proposal accepted); every target and draft
   forward is held to its RMSNorm and flash launches and route.
   ``[serve-spec]``: the serve CLI with ``--draft llama3.2-1b
   --spec-tokens 4``, then bf16 [serve] traffic through a plain and a
   speculative engine (k = 4, a draft of the target's first 2 layers,
   proposals pinned at acceptance 0.75 by an oracle hook on the plain
   run's tokens), three runs each in turns: gen tok/s, acceptance,
   tokens a round, the share of tokens equal to the plain run.
   ``[trace-spec]``: a profiler trace of 16 speculative steps.
   ``[parity-spec-ssm]``: ``spec_generate`` in fp32 equal to sequential
   greedy for mamba2-130m (noise 2e-3 and 0.5: zero acceptance) and
   zamba2-2.7b (12 layers, paged P 64);
10. the multi-replica router and the chaos harness (llama3.2-1b; every
   modeled device of ``h100_cluster(k)`` mapped onto the one card, the
   replicas stepped in turn on its stream; a device crash is a modeled
   fault that replans, nothing on the card fails). ``[parity-router]``,
   fp32, 2 full-width layers, dense and paged (P 64): a one-replica
   ``Router.from_service_plan``, two replicas under ``least_loaded`` and
   ``shortest_prefill``, and two replicas with replica 0's device crashed
   at router step 20 (its requests retried on replica 1 through a
   re-prefill) give a direct engine's tokens; so does one engine on three
   modeled devices taking a crash mid-prefill, a stall and its recover, a
   link degrade and its recover; then two retire → spawn cycles with the
   card's allocated memory before and after (a retired replica's KV caches
   must be released) and each spawn's plan and build time.
   ``[parity-router-moe]``: qwen2-moe-a2.7b, fp32, 2 layers, two replicas
   sharing the grouped GEMM's scratch give a direct engine's tokens, both
   launching it.  ``[serve-router]``: the CLI at full width in bf16 with
   ``--replicas 2``, ``--replicas auto --cluster-size 4`` and a written-out
   ``--fault-schedule`` (a link degrade, a stall that recovers, a crash);
   each submission ends in one typed terminal state, the counters sum to
   the submissions, and the launches are the sum of the replicas'
   forwards, each held to its per-forward counts; then phase 4's traffic
   through one engine of 16 slots and a router of two 8-slot replicas, in
   turns, three runs each (the router's host cost on one card);
11. enc-dec and VLM (model level; the engine refuses both families):
   ``[check] flash non-causal`` holds the dense kernel at ``causal=False``
   and seamless's heads (D 64, 16 / 16), fp32 and bf16, to its plain
   version: encoder shapes ``[2, S_enc]`` over S_enc in {1, 37, 500,
   1024} keys (S_enc = 1 on the decode kernel), cross-attention decode
   rows ``[8, 1]`` over {37, 500, 1024} keys with idle rows and a cross
   chunk ``[8, 64]`` over 500 keys with rows of 64, 17, 1 and 0 queries
   (route by the counters, two launches bit-identical, zeros past
   q_len); ``[check] flash GQA 28/4`` both flash kernels at qwen2-vl's
   heads (D 128, 7 query heads a KV head), causal, dense and paged P 64,
   at [8, 1], [8, 2] (the decode kernel) and [8, 64] (the chunk tile).
   ``[parity-encdec]``: seamless at full width, 2 + 2 layers in fp32, 8
   requests of 512 frames and 8-96-token prompts through an enc-dec fused
   driver (``encdec.encode`` once, then ``fused_step`` at chunk 64, 32
   greedy tokens): kernels and their plain versions (``plain_kernels``)
   give identical tokens, dense and paged P 64, and ``prefill_chunked``
   gives ``prefill``'s argmax.  ``[serve-encdec]``: 24 + 24 layers in
   bf16, the same traffic three times (gen tok/s, peak memory), every
   encoder pass at 24 non-causal flash calls and 49 RMSNorms and every
   decoder forward at 48 flash calls (24 non-causal cross calls) and 73
   RMSNorms; ``[trace-encdec]``: 16 paged decoder steps, the flash rows
   split into cross-attention (``DenseKV``) and self-attention
   (``PagedKV``).  ``[parity-vlm]``: qwen2-vl at full width, 2 layers in
   fp32, 8 requests of 16 text embeds, a 16 x 16 patch grid and 32 text
   embeds at Qwen2-VL-style (t, h, w) streams: whole-prompt prefill and 31
   decode steps, kernels vs plain identical; then the fused driver at the
   default streams, dense and paged, identical.  ``[serve-vlm]``: 28
   layers in bf16, the same prompt shape three times, every forward at 28
   flash and 57 RMSNorm launches; ``[trace-vlm]``: 16 decode steps;
12. time each kernel, its plain version and one PyTorch library call for
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
   bytes and an empty kernel's time (the floor), naming the instance; the
   verify rows [8, 4] and [8, 5] at D 64, dense and paged; the
   non-causal calls (encoder [1, 512] over 512 keys, cross [8, 1] and
   [8, 64] over 512 encoder keys, SDPA with ``is_causal=False`` and no
   mask beside them) and GQA 28 / 4 at [8, 1] and [8, 64], dense and
   paged;
13. training and the planner tools (no kernel: the trainer refuses
   ``attention_impl="pallas"``, since the kernels are forward-only).
   ``[train]``: ``python -m repro_torch.launch.train --arch llama3.2-1b
   --steps 20 --global-batch 8 --seq-len 128 --checkpoint-every 20`` at
   full width (bf16 params, fp32 moments, remat) into a temp directory,
   then again with ``--steps 30`` (a preemption: 10 steps resumed from
   step 20); every loss finite, ``steps_run`` 20 then 10, the latest
   committed step 20 then 30; losses, median step time, tokens/s, peak
   memory and the async checkpoint's snapshot and write times.
   ``[parity-train]``: one train step on the card and the same step on
   the CPU through the same port code — llama3.2-1b at full width cut to
   2 layers in fp32, fp32 moments at accum 1 and quant8 at accum 2, then
   every family's smoke config — loss within 1e-4 relative, grad norm
   1e-3, updated params within half a step's largest move
   (``PARITY_TRAIN_PARAM_TOL``), fp32 moments within 1e-6 and int8 ones
   within a quantization step; a pallas config refused.  ``[placeto]``:
   ``plan(method="placeto")`` for llama3.2-1b's block graph on
   ``h100_cluster(2)``, the policy on the card, beside ``moirai``'s
   objective.  ``[calibrate]``: the calibration CLI on the card, its byte
   counts equal to the CPU's, the fitted fractions.
14. the sharded trainer, right after the build (its ranks only load the
   built library): four ranks share ``cuda:0``, joined by gloo (NCCL
   refuses two ranks on one GPU), DTensor's functional collectives routed
   through gloo's eager calls.  ``[mesh-train]``: llama3.2-1b at full
   width on (2 data x 2 model), bf16, fp32 ZeRO-1 moments, 8 x 128
   tokens a step from the seeded pipeline, 2 steps, each loss and grad
   norm within 1e-2 relative of the same steps in one process on the
   card; 2 layers in fp32 within 1e-5 (loss), 1e-4 (grad norm) and 5e-4
   (every param); qwen2-moe pure DP x EP at full width, 2 of 24 layers,
   2 bf16 steps against one process taking the sharded objective, held
   as llama's bf16 steps; step times, peak memory a rank, each
   collective's calls, bytes and seconds.  ``[mesh-moe]``: ``moe_ep`` at
   qwen2-moe's widths, pure DP x EP on four EP ranks and TP inside the
   experts on (2 x 2), bf16 and fp32, capacity 1.25 and 8.0: 3
   grouped-GEMM launches a rank a call (the wrapper's counter), each held
   to ``grouped_gemm_plain`` on its inputs, the layer to its plain route
   (the same drops) and at 8.0 to ``moe_reference``; then the grouped
   GEMM at the EP shapes timed alone, beside ``torch._grouped_mm``.
   ``[mesh-elastic]``: the bf16 llama state after [mesh-train]'s first
   step, written by those four ranks as step 42 (rank 0 writes), resumed
   by two on (1 x 2) from the host: the step, every tensor bit-equal to
   the checkpoint, the next loss within 1e-5 relative of the four ranks'
   second step.  ``[mesh-ssm]`` (the same ranks): zamba2-2.7b at full
   width (d_model 2560, 80 heads of 64, N 64, the shared D 80 block) on
   (2 x 2), its Mamba trunk cut by heads over "model" as the reference's
   rules cut it (40 heads a rank), kernel config: 8 prompts of 256 tokens
   prefilled and 16 greedy decode steps, fp32 at 6 layers (one segment)
   with tokens identical to one process on the card and logits within
   1e-4 of the logit scale, bf16 at 12 layers
   (two shared-block occurrences; zamba2 has 54) with every forward's
   logits within 0.1 of the logit scale of one process fed the same
   tokens, an argmax flip only at a bf16 tie; on every rank every
   forward's launches (the SSD scan once a Mamba layer at S > 1 on 40
   heads, RMSNorm ``norms_per_forward(cfg, heads_cut=True)``, all on the
   rows kernel, flash once a shared block) and no Mamba weight gathered;
   a decode step's collectives and time; one train step at 6 layers in
   bf16 (plain config), loss and grad norm within 1e-2 of one process.
15. the launch tools.  ``[dryrun]``: the dry-run of every arch at
   decode_32k, long_500k and train_4k, and of arctic-480b at prefill_32k,
   on the (16 x 16) production mesh (the other prefill cells and the
   (2 x 16 x 16) mesh are left to the CLI): one rank's step on fake CUDA
   tensors over a fake process group of 256 ranks, counted against one
   H100's terms.  It needs no card: its processes (``DRYRUN_JOBS``,
   niced, each queue a process group) start with the script, run beside
   the build, the trainer and the sharded trainer, are stopped before the
   first kernel check and go on only once ``[dryrun-card]`` is done, so no
   host-timed phase shares the host with them.  A line a cell (dominant
   term, the three terms, ``fit_estimate_gb``, ``fits_80gb``),
   arctic-480b x train_4k on a line of its own; any cell in error fails.
   ``[roofline-fd]``: the finite difference of llama3.2-1b x decode_32k
   and qwen2-moe-a2.7b x train_4k, each rebuilt count equal to the
   direct one.  ``[dryrun-card]``: llama3.2-1b at full width on a
   one-rank mesh (``CARD_CELLS``: decode_32k at 16 rows, prefill_32k at
   1, train_4k at 4), each through ``run_cell`` on fake tensors and on
   real ones: FLOPs, bytes and collective bytes identical, the predicted
   peak within 15% of ``max_memory_allocated``, the median of 5
   synchronized steps at or above ``step_time_lb_s`` (``lb / measured``
   printed); the serving cells again at ``attention_impl="pallas"`` (flash
   and RMSNorm launches required), held to that step's own bound: the
   counter's count of the rest of the step plus each launch's work
   (``kernel_work``: ``flash_work`` and ``rms_work`` on its inputs).

16. the port's examples (``repro_torch.examples``, the counterparts of
   ``examples/*.py``), each through its ``main()`` as ``python -m`` runs
   it.  ``[example-quickstart]`` and ``[example-placement]``: child
   processes started with the script beside the dry-run's queues (niced,
   each in a session of its own, stopped with them before the first
   host-timed phase, resumed and collected at the end): exit 0,
   quickstart's graph (307 operators, 386 flows, 258 after GCOF), msct,
   getf and round_robin at the CPU's figures (818.006 / 570.399 /
   2773.116 ms; ``QUICKSTART_MS``), the six placement rows finite with msct
   and getf at the CPU's (``PLACEMENT_MS``), placeto's policy on the card;
   moirai's figures and whether it is <= min(msct, getf) are printed, not
   held (its MILP runs to a wall-clock limit on a shared host).
   ``[example-train]``: ``train_demo --steps 300 --d-model 512 --layers
   12`` (fp32) in a child process beside ``[train]``, in the kernels'
   build window: every loss finite, the last below the first; losses,
   wall time, tokens/s, peak memory.  ``[example-serve]`` (after the parity
   runs): ``serve_demo.main()`` at its defaults (smoke llama, D 32 — the
   flash kernel's head-dim-32 instance, held in ``[check]`` at the smoke
   heads and the demo's own calls —, fp32, one modeled H100), every
   forward on the flash and RMSNorm kernels (``check_forwards``); the same
   demo under ``plain_kernels()`` with identical tokens; ``demo()`` on
   ``h100_cluster(2, heterogeneous=True)`` mapped onto the card, request
   99 after device 0 fails equal to a fresh engine's; ``demo()`` at full
   width (16 layers, bf16), every request served on the kernels.

Each phase's wall time is printed as a ``[phase]`` line.

The line before last is one JSON object ``{"kernels": [...]}``, and the last
``{"ok": true, "device": {...}}``.  It needs one CUDA card; without one it
exits non-zero and prints no result.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
import pickle
import platform
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import namedtuple
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
sys.path.append(str(ROOT / "tests"))

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.costmodel import expected_accepted_tokens  # noqa: E402
from repro_torch.core.devices import h100_cluster  # noqa: E402
from repro_torch.core.placement import PlanConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_gemm as gg  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.transformer import torch_dtype  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.kv_pool import KVPool  # noqa: E402
from time_grouped_gemm import RMS_SHAPES, time_rms  # noqa: E402
from _mrope_streams import image_streams  # noqa: E402

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
    fa.noncausal_launches = 0
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
            "flash_attention_noncausal": fa.noncausal_launches,
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
SEAMLESS = "seamless-m4t-large-v2"
VLM = "qwen2-vl-7b"
# llama3.2-1b at smoke size (D 32, 4 / 2 heads, fp32): the serve demo's
# config ([example-serve])
SMOKE = "llama3.2-1b-smoke"
# phase tags: [serve], [serve-moe], ...
TAGS = {LLAMA: "", MOE: "-moe", QWEN3: "-qwen3", GEMMA: "-gemma", GEMMA2: "-gemma2"}
# the engine runs and traces of [serve-moe], [serve-moe-paged],
# [serve-qwen3], [serve-gemma], [serve-gemma-paged] and [serve-gemma2] cut
# in depth (their CLI runs keep every layer) so that the script, with the
# sharded trainer's phases, stays near 950 s of its 1200
SERVE_LAYERS = {MOE: 12, QWEN3: 20, GEMMA: 14, GEMMA2: 24}
# the kernels each path must launch: dense or paged KV (decode steps on the
# split-KV decode kernel), plus the grouped GEMM for an MoE model
DENSE_PATH = ("flash_attention", "flash_attention_decode", "rmsnorm")
PAGED_PATH = ("flash_attention_paged", "flash_attention_paged_decode", "rmsnorm")


def path(arch: str, paged: bool) -> tuple:
    kernels = PAGED_PATH if paged else DENSE_PATH
    return kernels + (("grouped_gemm",) if arch == MOE else ())


def norms_per_forward(cfg, *, heads_cut: bool = False) -> int:
    """RMSNorm launches of one forward: 2 an attention block (+ 2 for the
    per-head q/k norms, + 2 for post-norms), 2 a Mamba layer, plus the
    final norm; a hybrid model's shared attention block counts at each of
    its occurrences; an enc-dec model's decoder forward has 3 a layer (self,
    cross, MLP) and its encoder pass 2 a layer + 1 (``encode_norms``).
    ``heads_cut``: on a mesh that cuts the Mamba heads a layer launches 1,
    its ``ln``: the gated norm reduces its sums over the ranks in plain
    PyTorch (``ssm.gated_norm``), not on the kernel."""
    attn = 2 + 2 * cfg.qk_norm + 2 * cfg.post_block_norm
    mamba = 1 if heads_cut else 2
    if cfg.family == "encdec":
        return 3 * cfg.n_layers + 1
    if cfg.family == "ssm":
        return mamba * cfg.n_layers + 1
    if cfg.family == "hybrid":
        return mamba * cfg.n_layers + attn * (cfg.n_layers // cfg.shared_attn_every) + 1
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
         SMOKE: dict(h=4, kv=2, d=32),
         ZAMBA: dict(h=32, kv=32, d=80), QWEN3: dict(h=40, kv=8, d=128),
         GEMMA: dict(h=16, kv=16, d=256), GEMMA2: dict(h=32, kv=16, d=128),
         SEAMLESS: dict(h=16, kv=16, d=64), VLM: dict(h=28, kv=4, d=128)}


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


def mesh_ssm_flash_cases(dev, dtype) -> dict:
    """[mesh-ssm]'s flash calls on one rank of its (2 x 2) mesh: zamba2's
    shared block on half its heads (16 / 16, D 80) and half the rows, over
    the dense cache of ``MESH_SSM_PROMPT + MESH_SSM_STEPS`` keys: the
    prompts' prefill (Sq 256 at depth 0) and a decode row each at the last
    step's depth."""
    hk = dict(HEADS[ZAMBA], h=HEADS[ZAMBA]["h"] // 2, kv=HEADS[ZAMBA]["kv"] // 2)
    b, s, sk = MESH_SSM_ROWS // 2, MESH_SSM_PROMPT, MESH_SSM_PROMPT + MESH_SSM_STEPS
    return {f"sq{s}": flash_inputs(dev, dtype, sq=s, depths=[0] * b, q_lens=[s] * b, sk=sk, **hk),
            "decode": flash_inputs(dev, dtype, sq=1, depths=[sk - 1] * b, q_lens=[1] * b,
                                   sk=sk, **hk)}


def run_flash(fn, inp, extra):
    d = inp["q"].shape[-1]
    return fn(inp["q"], inp["k"], inp["v"], inp["q_offsets"], inp["q_lens"],
              scale=d ** -0.5, causal=extra.get("causal", True), window=extra.get("window"),
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
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f}s: "
        f"{os.path.basename(_build.load()._name)} (the [mesh-*] ranks load it, never build)")
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


def check_flash_call(dev, case, inp, extra, errs, key, *, on_decode=None, paged=False) -> float:
    """One flash call held to its plain version: the route by the launch
    counters (the decode kernel up to ``fa._decode_rows`` rows a KV head, a
    chunk tile past it; ``on_decode`` states it where the case knows it)
    and the causal flag by the non-causal counter; within tolerance,
    bit-identical to a second launch, exact zeros past q_len; paged,
    bit-equal to the dense kernel on the gathered view, and the trash
    page's garbage changes no output.  Records and returns the max abs
    error under ``errs[key]``."""
    q = inp["q"]
    kv = (inp["pool_k"] if paged else inp["k"]).shape[-2]
    if on_decode is None:
        on_decode = q.shape[1] * (q.shape[2] // kv) <= fa._decode_rows(q.shape[3])
    causal = extra.get("causal", True)
    kernel, plain = ((fa.flash_attention_paged, fa.flash_attention_paged_plain) if paged
                     else (fa.flash_attention, fa.flash_attention_plain))
    run = run_paged if paged else run_flash
    names = (("flash_attention_paged", "flash_attention_paged_decode") if paged
             else ("flash_attention", "flash_attention_decode")) + ("flash_attention_noncausal",)
    before = counts()
    out = run(kernel, inp, extra)
    again = run(kernel, inp, extra)
    after = counts()
    ref = run(plain, inp, extra)
    torch.cuda.synchronize(dev)
    ran = tuple(after[n] - before[n] for n in names)
    want = (2, 2 if on_decode else 0, 0 if causal else 2)
    if ran != want:
        raise AssertionError(f"{case}: launches (all, decode, non-causal) {ran}, expected {want} "
                             f"({'decode' if on_decode else 'chunk'} route)")
    err = within(out, ref)
    if not torch.equal(out, again):
        raise AssertionError(f"{case}: two launches differ")
    for bi, n in enumerate(inp["q_lens"].tolist()):
        if out[bi, n:].any():
            raise AssertionError(f"{case}: row {bi} leaked past q_len={n}")
    if paged:
        if not torch.equal(out, run_flash(fa.flash_attention, gathered(inp), extra)):
            raise AssertionError(f"{case}: not bit-equal to the dense kernel on the gathered "
                                 "view")
        inp["pool_k"][-1] = 0
        inp["pool_v"][-1] = 0
        if not torch.equal(out, run(kernel, inp, extra)):
            raise AssertionError(f"{case}: the trash page changed an output")
    errs[key] = err
    return err


# the flash cases' head configurations in [check]: tag, and the prefix of
# their error keys (llama's carry none)
CHECK_HEADS = ((LLAMA, "d64", ""), (MOE, "d128", "d128_"), (QWEN3, "d128 GQA 40/8", "d128g5_"),
               (ZAMBA, "d80", "d80_"), (GEMMA, "d256", "d256_"),
               (SEAMLESS, "d64 16/16", "d64mha_"), (SMOKE, "d32 4/2", "d32_"))


def demo_flash_cases(dev, dtype) -> dict:
    """The serve demo's flash calls ([example-serve]: smoke llama, 4 / 2
    heads of 32, 4 slots, max_len 128): a 4-token prompt's prefill at
    depth 0 beside idle rows, and decode rows at depths up to 11."""
    kw = dict(sk=128, **HEADS[SMOKE])
    return {"demo_prefill": flash_inputs(dev, dtype, sq=4, depths=[0, 0, 0, 0],
                                         q_lens=[4, 4, 0, 4], **kw),
            "demo_decode": flash_inputs(dev, dtype, sq=1, depths=[4, 7, 11, 0],
                                        q_lens=[1, 1, 1, 0], **kw)}


def phase_check(dev) -> dict:
    """Every flash case of ``flash_cases`` and ``paged_cases`` at each served
    head configuration (llama's D 64 GQA 32 / 8; qwen2-moe's D 128 and
    qwen3's GQA 40 / 8; zamba2's D 80; gemma-7b's D 256; seamless's causal
    decoder self-attention, D 64 at 16 / 16; the smoke configs' D 32 at 4 /
    2, and the serve demo's own calls), and a ragged chunk (Sq 100)
    at each head dim, dense and paged (pages of 16, 64 and 48 tokens), fp32
    and bf16, each call held by ``check_flash_call``; zamba2's shared block
    as one rank of [mesh-ssm] runs it (``mesh_ssm_flash_cases``).  Then the
    grouped GEMM's cases."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for arch, tag, prefix in CHECK_HEADS:
            for case, (inp, extra) in flash_cases(dev, dtype, arch).items():
                err = check_flash_call(dev, f"flash {tag} {case}", inp, extra, errs,
                                       ("flash_attention", prefix + case, dtype))
                log(f"[check] flash_attention {tag} {case} {dt}: max abs err {err:.3e}, two "
                    "launches bit-identical")
            for case, (inp, extra) in paged_cases(dev, dtype, arch).items():
                err = check_flash_call(dev, f"flash_paged {tag} {case}", inp, extra, errs,
                                       ("flash_attention_paged", prefix + case, dtype),
                                       paged=True)
                log(f"[check] flash_attention_paged {tag} {case} {dt}: max abs err {err:.3e}; "
                    "equal to the dense kernel on the gathered view, two launches "
                    "bit-identical, the trash page changes nothing")
        for case, inp in demo_flash_cases(dev, dtype).items():
            err = check_flash_call(dev, f"flash d32 {case}", inp, {}, errs,
                                   ("flash_attention", f"d32_{case}", dtype))
            log(f"[check] flash_attention d32 4/2 (the serve demo's) {case} {dt} q "
                f"{tuple(inp['q'].shape)} k {tuple(inp['k'].shape)}: max abs err {err:.3e}, two "
                "launches bit-identical")
        for arch, tag in ((LLAMA, "d64"), (ZAMBA, "d80"), (MOE, "d128"), (GEMMA, "d256"),
                          (SEAMLESS, "d64mha"), (SMOKE, "d32")):
            dense_inp, paged_inp = ragged_chunk_cases(dev, dtype, arch)
            err = check_flash_call(dev, f"flash {tag} sq100", dense_inp, {}, errs,
                                   ("flash_attention", f"{tag}_sq100", dtype))
            p_err = check_flash_call(dev, f"flash_paged {tag} sq100", paged_inp, {}, errs,
                                     ("flash_attention_paged", f"{tag}_sq100_P64", dtype),
                                     paged=True)
            log(f"[check] flash_attention {tag} sq100 depths 0/1000 {dt}: max abs err "
                f"{err:.3e}; paged P64 {p_err:.3e}, equal to the dense kernel on the gathered view")
        for case, inp in mesh_ssm_flash_cases(dev, dtype).items():
            err = check_flash_call(dev, f"flash d80 16/16 {case}", inp, {}, errs,
                                   ("flash_attention", f"d80h16_{case}", dtype))
            log(f"[check] flash_attention d80 16/16 ([mesh-ssm]'s rank) {case} {dt} q "
                f"{tuple(inp['q'].shape)} k {tuple(inp['k'].shape)}: max abs err {err:.3e}, two "
                "launches bit-identical")
        for case, inp in gg_cases(dev, dtype).items():
            out = run_gg(gg.grouped_gemm, inp)
            err = within(out, run_gg(gg.grouped_gemm_plain, inp))
            gs = inp["group_sizes"]
            errs[("grouped_gemm", case, dtype)] = err
            log(f"[check] grouped_gemm {case} {dt} x {tuple(inp['x'].shape)} w "
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


# the head configurations served, for the verify-row checks: (tag, arch)
VERIFY_HEADS = ((ZAMBA, "d80"), (LLAMA, "d64"), (MOE, "d128"), (QWEN3, "d128g5"),
                (GEMMA2, "d128g2"), (GEMMA, "d256"))


def verify_sqs(hk) -> list:
    """The verify widths Sq to check at heads ``hk``: 2 up to the last on
    the decode kernel (``Sq · H / KV <= fa._decode_rows(D)``), and the first
    that goes to a chunk tile."""
    last = fa._decode_rows(hk["d"]) // (hk["h"] // hk["kv"])
    return list(range(2, last + 2))


def phase_check_verify(dev) -> dict:
    """Verify rows (``q_len = Sq > 1`` at decode depth, as a speculative
    round feeds them) against the plain version at each served head
    configuration, fp32 and bf16, plain and with window 64 + softcap 50:
    each call mixes four verify rows (depths 0, split-1, split and
    2048-Sq, the last query on key 2047), a decode row (q_len 1) and an
    idle row (q_len 0).  The launch counters must show the route the
    wrapper's rule predicts (the decode kernel up to ``fa._decode_rows``
    rows per KV head, a chunk tile past it); every call is within
    tolerance of the plain version, bit-equal to a second launch and exact
    zeros past q_len; paged at P 16 and 64 is bit-equal to the dense kernel
    on the gathered view, with the trash page's garbage and with it
    zeroed."""
    errs = {}
    n_calls = 0
    for arch, tag in VERIFY_HEADS:
        hk = HEADS[arch]
        rep = hk["h"] // hk["kv"]
        for dtype in (torch.float32, torch.bfloat16):
            split = fa._decode_split(dtype, hk["d"])
            for extra in ({}, {"window": 64, "softcap": 50.0}):
                worst, routes = 0.0, []
                for sq in verify_sqs(hk):
                    on_decode = sq * rep <= fa._decode_rows(hk["d"])
                    depths = [0, split - 1, split, 2048 - sq, 1000, 500]
                    lens = [sq] * 4 + [1, 0]
                    case = f"{tag}_verify_sq{sq}" + ("_window_softcap" if extra else "")
                    inp = flash_inputs(dev, dtype, sq=sq, depths=depths, q_lens=lens, **hk)
                    err = check_flash_call(dev, f"flash {case}", inp, extra, errs,
                                           ("flash_attention", case, dtype),
                                           on_decode=on_decode)
                    worst = max(worst, err)
                    for P in (16, 64):
                        pin = paged_inputs(dev, dtype, P=P, depths=depths, q_lens=lens, sq=sq,
                                           **hk)
                        p_err = check_flash_call(dev, f"flash_paged {case} P{P}", pin, extra,
                                                 errs, ("flash_attention_paged",
                                                        f"{case}_P{P}", dtype),
                                                 on_decode=on_decode, paged=True)
                        worst = max(worst, p_err)
                    n_calls += 13
                    routes.append(f"{sq}:{'decode' if on_decode else 'chunk'}")
                log(f"[check] flash verify rows {tag} (H {hk['h']} / KV {hk['kv']}, D {hk['d']}) "
                    f"{str(dtype)[6:]}{' window 64 + softcap 50' if extra else ''}: Sq "
                    f"{' '.join(routes)}; rows at depths 0/{split - 1}/{split}/2048-Sq + a decode "
                    f"and an idle row; dense and paged P16/P64 max abs err {worst:.3e}; route by "
                    "the counters, two launches bit-identical, zeros past q_len, paged bit-equal "
                    "to dense (garbage and zeroed trash page)")
    log(f"[check] flash verify rows: {n_calls} calls at {len(VERIFY_HEADS)} head configurations")
    return errs


# the non-causal calls of an enc-dec model at seamless's heads (D 64, 16 /
# 16): the encoder's self-attention over S_enc frames, each a key (S_enc = 1
# on the decode kernel), and the decoder's cross-attention over S_enc keys,
# decode rows and a fused chunk, with idle and partial rows
NONCAUSAL_ENC = (1, 37, 500, 1024)
NONCAUSAL_CROSS_DECODE = (37, 500, 1024)


def noncausal_cases(dev, dtype) -> dict:
    """name → (inputs, on the decode kernel); every call ``causal=False``.
    The query offsets are decoder depths: a non-causal call must ignore
    them."""
    hk = HEADS[SEAMLESS]
    rng = np.random.default_rng(SEED + 11)
    cases = {}
    for s_enc in NONCAUSAL_ENC:
        cases[f"encoder_S{s_enc}"] = (flash_inputs(dev, dtype, sq=s_enc, depths=[0, 0],
                                                   q_lens=[s_enc] * 2, sk=s_enc, **hk), s_enc == 1)
    for s_enc in NONCAUSAL_CROSS_DECODE:
        cases[f"cross_decode_S{s_enc}"] = (flash_inputs(
            dev, dtype, sq=1, depths=rng.integers(0, 128, size=8).tolist(),
            q_lens=[1, 0, 1, 1, 0, 1, 1, 1], sk=s_enc, **hk), True)
    cases["cross_chunk_S500"] = (flash_inputs(
        dev, dtype, sq=64, depths=rng.integers(0, 64, size=8).tolist(),
        q_lens=[64, 17, 1, 0, 64, 33, 0, 64], sk=500, **hk), False)
    return cases


def phase_check_noncausal(dev) -> dict:
    """``[check] flash non-causal``: the dense kernel at ``causal=False``
    (seamless's D 64, 16 / 16), fp32 and bf16, against its plain version
    with the stated tolerances: encoder shapes ``[2, S_enc, 16, 64]`` over
    S_enc in {1, 37, 500, 1024} keys, cross-attention decode rows ``[8, 1]``
    over {37, 500, 1024} keys with idle rows, and a cross chunk ``[8, 64]``
    over 500 keys with rows of 64, 17, 1 and 0 queries; the key axis is the
    frame count (its tail masked by ``kp < k_len`` alone), the route by the
    counters, two launches bit-identical, zeros past q_len, every call
    counted as non-causal."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case, (inp, on_decode) in noncausal_cases(dev, dtype).items():
            err = check_flash_call(dev, f"flash non-causal {case}", inp, {"causal": False},
                                   errs, ("flash_attention", f"noncausal_{case}", dtype),
                                   on_decode=on_decode)
            log(f"[check] flash non-causal {case} {str(dtype)[6:]} q {tuple(inp['q'].shape)} "
                f"over {inp['k'].shape[1]} keys, q_lens {inp['q_lens'].tolist()}: "
                f"{'decode' if on_decode else 'chunk'} route, max abs err {err:.3e}, two launches "
                "bit-identical, zeros past q_len")
    return errs


def gqa7_cases(dev, dtype, paged) -> dict:
    """qwen2-vl's heads (D 128, 28 / 4: 7 query heads a KV head), causal, at
    ragged depths: decode rows [8, 1] (7 rows a KV head), two-query rows
    [8, 2] (14), a fused chunk [8, 64] (448: the chunk tile's 64-row blocks,
    all full), a ragged chunk [8, 100] (700 rows: the last block partial)
    and the whole-prompt prefill [8, 304] of ``VLM_PROMPT`` (2128 rows: the
    last block partial), its rows 0 and 1 at depth 0 with all 304 queries
    as [serve-vlm] sends them; each name → (inputs, on the decode kernel)."""
    hk = HEADS[VLM]
    rng = np.random.default_rng(SEED + 12)
    prompt = VLM_PROMPT[0] + VLM_PROMPT[1] * VLM_PROMPT[2] + VLM_PROMPT[3]
    cases = {}
    for sq, lens in ((1, [1, 1, 0, 1, 1, 1, 0, 1]), (2, [2, 1, 0, 2, 2, 2, 1, 2]),
                     (64, [64, 1, 0, 64, 17, 1, 64, 0]), (100, [100, 1, 0, 100, 17, 100, 64, 0]),
                     (prompt, [prompt, prompt, 0, 100, prompt, 1, 17, prompt])):
        depths = [int(rng.integers(0, 2048 - sq + 1)) for _ in lens]
        if sq == prompt:
            depths[:2] = [0, 0]
        kw = dict(sq=sq, depths=depths, q_lens=lens, **hk)
        inp = paged_inputs(dev, dtype, P=64, **kw) if paged else flash_inputs(dev, dtype, **kw)
        cases[f"sq{sq}"] = (inp, sq * hk["h"] // hk["kv"] <= fa._decode_rows(hk["d"]))
    return cases


def phase_check_gqa7(dev) -> dict:
    """``[check] flash GQA 28/4``: both flash kernels at qwen2-vl's heads,
    causal, dense and paged (P 64), fp32 and bf16, each call held to its
    plain version with its route logged and asserted, two launches
    bit-identical, zeros past q_len, paged bit-equal to the dense kernel
    on the gathered view."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for paged in (False, True):
            for case, (inp, on_decode) in gqa7_cases(dev, dtype, paged).items():
                name = "flash_attention_paged" if paged else "flash_attention"
                err = check_flash_call(dev, f"flash GQA 28/4 {case}", inp, {}, errs,
                                       (name, f"d128g7_{case}", dtype), on_decode=on_decode,
                                       paged=paged)
                rows = inp["q"].shape[1] * HEADS[VLM]["h"] // HEADS[VLM]["kv"]
                log(f"[check] flash GQA 28/4 {'paged P64' if paged else 'dense'} {case} "
                    f"{str(dtype)[6:]}: {rows} rows a KV head on the "
                    f"{'decode kernel' if on_decode else 'chunk tile'}, depths "
                    f"{inp['q_offsets'].tolist()}, q_lens {inp['q_lens'].tolist()}: max abs err "
                    f"{err:.3e}, two launches bit-identical"
                    + (", bit-equal to the dense kernel on the gathered view" if paged else ""))
    return errs


def full_cfg(arch=LLAMA, **kw):
    kw = dict(dict(scan_layers=False, remat=False, attention_impl="pallas"), **kw)
    return dataclasses.replace(get_config(arch), **kw)


def free_card() -> None:
    """Return what dropped engines and weights held to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def serve_plan(slots, page_tokens=None, sharing=True) -> PlanConfig:
    return PlanConfig(method="moirai", time_limit=20.0, objective="throughput",
                      serving_slots=slots, kv_page_tokens=page_tokens, prefix_sharing=sharing)


def make_engine(cfg, params, dev, *, slots, max_len, page_tokens=None, cluster=None):
    """An engine on ``cluster`` (default ``h100_cluster(1)``), every modeled
    device mapped onto the card."""
    return ServingEngine(
        cfg, params, cluster or h100_cluster(1), devices=[dev], slots=slots, max_len=max_len,
        plan_cfg=serve_plan(slots, page_tokens), eos_id=-1,
    )


def seeded_requests(cfg, *, requests, max_new, seed=SEED, rid0=0) -> list:
    """``requests`` prompts of 100-600 tokens from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    return [
        Request(rid=rid0 + i, prompt=rng.integers(1, cfg.vocab_size, size=int(n)).tolist(),
                max_new_tokens=max_new)
        for i, n in enumerate(rng.integers(100, 601, size=requests))
    ]


def drive(eng, cfg, dev, *, requests, max_new, seed=SEED, rid0=0):
    """Submit ``requests`` seeded prompts of 100-600 tokens and serve them
    all; returns the requests and the wall time of the serving alone."""
    reqs = seeded_requests(cfg, requests=requests, max_new=max_new, seed=seed, rid0=rid0)
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
    cli_cfg = full_cfg(arch)
    # the engine's runs and trace at the depth the script's time allows
    cfg = full_cfg(arch, n_layers=SERVE_LAYERS.get(arch, cli_cfg.n_layers))
    log(f"{tag} host: {host_line()}")
    log(f"{tag} repro_torch.launch.serve.main(['--arch', '{arch}']) — CLI defaults")
    reset_counts()
    t0 = time.perf_counter()
    engine, reqs = serve.main(["--arch", arch])
    torch.cuda.synchronize(dev)
    cli_counts = counts()
    log(f"{tag} cli: {time.perf_counter() - t0:.1f}s incl. init, launches {cli_counts}")
    require(cli_counts, want, "dense serve CLI")
    require_per_forward(cli_counts, cli_cfg, "dense serve CLI")
    if not all(r.done and len(r.out_tokens) == r.max_new_tokens for r in reqs):
        raise AssertionError("the CLI left requests unserved")
    del engine
    free_card()

    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    eng = make_engine(cfg, params, dev, slots=8, max_len=2048)
    pl = eng.placement_result
    log(f"{tag} engine: {cfg.n_layers} of {cli_cfg.n_layers} layers, "
        f"placement method={pl.method} devices={sorted(set(pl.placement.values()))} "
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


def device_events(prof) -> tuple:
    """The trace's device-side events (kernels, copies), read from the
    profiler's raw results: its per-op event tree (``events()``,
    ``key_averages()``), which these numbers do not need, takes seconds to
    build for each trace.  Returns ``(rows, busy_s)``: rows ``(device us,
    name, calls)``, one a name; ``busy_s`` the union of the events'
    intervals, so kernels that overlap (the decode merge, launched as a
    programmatic dependent, starts before the decode kernel ends) count
    once."""
    by_name, spans = {}, []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA") or e.is_user_annotation():
            continue
        start, end = e.start_ns(), e.end_ns()
        if end <= start:
            continue
        spans.append((start, end))
        ns, n = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (ns + end - start, n + 1)
    busy, lo, hi = 0, None, None
    for start, end in sorted(spans):
        if hi is None or start > hi:
            busy += 0 if hi is None else hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    rows = [(ns / 1e3, name, n) for name, (ns, n) in by_name.items()]
    return rows, (busy + (0 if hi is None else hi - lo)) / 1e9


def report_trace(prof, wall, tag, what) -> list:
    """Device time by kernel (device-side rows only) and the card's idle
    share of ``wall``; returns the rows (:func:`device_events`)."""
    t0 = time.perf_counter()
    rows, busy = device_events(prof)
    log(f"{tag} {what}: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms (kernel "
        f"times summed {sum(r[0] for r in rows) / 1e3:.2f} ms), device idle share "
        f"{1 - busy / wall:.3f}; {len(rows)} kernel names read in "
        f"{time.perf_counter() - t0:.2f}s" if rows else
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
    return rows


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
        plan_cfg=serve_plan(slots, page_tokens, sharing), eos_id=-1,
    )


def serve_reqs(eng, reqs, dev) -> float:
    """Submit ``reqs`` to an engine or a router and serve them all; the
    wall time of the serving alone."""
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
    cli_cfg = full_cfg(arch)
    cfg = full_cfg(arch, n_layers=SERVE_LAYERS.get(arch, cli_cfg.n_layers))
    log(f"{tag} repro_torch.launch.serve.main(['--arch', '{arch}', '--kv-page-tokens', '64'])")
    reset_counts()
    t0 = time.perf_counter()
    engine, reqs = serve.main(["--arch", arch, "--kv-page-tokens", "64"])
    torch.cuda.synchronize(dev)
    cli_counts = counts()
    log(f"{tag} cli: {time.perf_counter() - t0:.1f}s incl. init, launches {cli_counts}")
    require(cli_counts, want, "paged serve CLI")
    require_per_forward(cli_counts, cli_cfg, "paged serve CLI")
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
    log(f"{tag} engine: {cfg.n_layers} of {cli_cfg.n_layers} layers")
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

# -------------------------------------------------------------- speculation
SPEC_K = (3, 4)          # llama verify rows: [8, 4] on the decode kernel, [8, 5] on a chunk tile
SPEC_NOISE = 2e-3        # the noisy draft: the target's weights + SPEC_NOISE · N(0, 1)
SPEC_ALPHA = 0.75        # [serve-spec]'s pinned acceptance
SPEC_SERVE_K = 4
SPEC_TRUTH_PASSES = 8    # pinned_truth's limit
DRAFT_LAYERS = 2         # [serve-spec]'s draft: the target's first 2 layers
# one executor forward: the engine whose step ran it, the executor, the
# clock's reading (a router's step), S and the kernel launches it made
Forward = namedtuple("Forward", "engine executor clock s launches")


class EngineForwards:
    """Every stage-executor forward while active, as a :class:`Forward`:
    the engine is the one whose ``step`` ran the forward (a router steps its
    replicas in turn), so executors a replan rebuilt count for their engine
    too; the executor tells a speculative engine's target from its draft.
    The executor synchronizes the card after every stage, so the counts
    between a forward's start and end are its own."""

    def __init__(self, clock=lambda: 0):
        self.steps = []
        self.clock = clock

    def __enter__(self):
        from repro_torch.serving.stage_executor import StageExecutor

        self._saved = StageExecutor.forward, ServingEngine.step
        fwd, step = self._saved
        current, steps, clock = [None], self.steps, self.clock

        def engine_step(eng):
            current[0] = eng
            try:
                return step(eng)
            finally:
                current[0] = None

        def counted(ex, tokens, *args, **kw):
            before = counts()
            out = fwd(ex, tokens, *args, **kw)
            after = counts()
            steps.append(Forward(current[0], ex, clock(), int(tokens.shape[1]),
                                 {k: after[k] - before[k] for k in after}))
            return out

        StageExecutor.forward, ServingEngine.step = counted, engine_step
        return self

    def __exit__(self, *exc):
        from repro_torch.serving.stage_executor import StageExecutor

        StageExecutor.forward, ServingEngine.step = self._saved
        return False

    def of(self, eng=None, *, executor=None) -> list:
        """The forwards of ``eng`` (or of ``executor``) as (S, launches),
        for :func:`check_forwards`."""
        return [(f.s, f.launches) for f in self.steps
                if (eng is None or f.engine is eng)
                and (executor is None or f.executor is executor)]


def spec_path(cfg, k, paged) -> tuple:
    """The kernels a speculative llama run must launch: RMSNorm, the dense
    flash kernel and its decode kernel (the draft's dense caches: [8, 64]
    catch-ups and [8, 1] proposals), and for a paged target the paged
    kernel, on the decode kernel when [8, k+1] verify rows take it."""
    out = ("rmsnorm", "flash_attention", "flash_attention_decode")
    if paged:
        on_decode = (k + 1) * (cfg.n_heads // cfg.n_kv_heads) <= fa._decode_rows(
            cfg.resolved_head_dim)
        out += ("flash_attention_paged",) + (("flash_attention_paged_decode",) if on_decode
                                             else ())
    return out


def forward_shapes(steps) -> dict:
    """How many forwards ran at each S."""
    out = {}
    for s, _ in steps:
        out[s] = out.get(s, 0) + 1
    return dict(sorted(out.items()))


def verify_launches(steps, k, paged) -> int:
    """Flash launches of the target's verify forwards, [slots, k+1]."""
    name = "flash_attention_paged" if paged else "flash_attention"
    return sum(d[name] for s, d in steps if s == k + 1)


def map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tensors(v, fn) for v in tree]
    return fn(tree)


def noisy_copy(params, scale, seed, dev):
    """A draft correlated with the target: every float tensor of ``params``
    plus ``scale · N(0, 1)``, drawn in order from a generator seeded
    ``seed`` (as tests/test_spec_decode.py perturbs the reference's)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return map_tensors(params, lambda t: (t.float() + scale * torch.randn(
        t.shape, generator=g, device=dev)).to(t.dtype) if t.is_floating_point() else t)


def truncated_draft(cfg, params, n_layers):
    """A draft that shares the target's tensors: its embedding, its first
    ``n_layers`` layers, its final norm and head (nothing copied)."""
    dcfg = dataclasses.replace(cfg, n_layers=n_layers)
    dp = {"embed": params["embed"], "layers": params["layers"][:n_layers],
          "ln_final": params["ln_final"]}
    if not cfg.tie_embeddings:
        dp["lm_head"] = params["lm_head"]
    return dcfg, dp


def make_spec_engine(cfg, params, dev, dcfg, dparams, *, k, slots=8, max_len=2048,
                     page_tokens=None, method="moirai"):
    return ServingEngine(
        cfg, params, h100_cluster(1), devices=[dev], slots=slots, max_len=max_len,
        plan_cfg=PlanConfig(method=method, time_limit=20.0, objective="throughput",
                            serving_slots=slots, spec_tokens=k, kv_page_tokens=page_tokens),
        eos_id=-1, draft_cfg=dcfg, draft_params=dparams,
    )


def spec_requests(cfg, *, n=16, max_new=32, seed=SEED, rid0=0):
    """``n`` requests of 100-600 seeded prompt tokens, as :func:`drive`'s."""
    rng = np.random.default_rng(seed)
    return [Request(rid=rid0 + i, prompt=rng.integers(1, cfg.vocab_size, size=int(m)).tolist(),
                    max_new_tokens=max_new)
            for i, m in enumerate(rng.integers(100, 601, size=n))]


def oracle_hook(continuations, alpha, seed):
    """Proposals pinned at per-token acceptance ``alpha`` (the logic of
    benchmarks/spec_decode.py's oracle draft): the true continuation, each
    token replaced with probability ``1 - alpha`` by one the target cannot
    predict there; requests without a continuation keep the draft's own.
    Each decision is drawn from a generator keyed on (seed, request,
    position), so a run's decisions follow from its truth alone, not from
    the order the engine asks in.  A position's decision counts once: it is
    proposed again only after an earlier proposal of its round was
    rejected, which voids it there."""

    def hook(req, proposals):
        if req.rid not in continuations:
            return proposals
        cont = continuations[req.rid]
        done = len(req.out_tokens)
        out = []
        for j in range(len(proposals)):
            true_tok = cont[done + j] if done + j < len(cont) else 0
            keep = np.random.default_rng([seed, req.rid, done + j]).random() < alpha
            out.append(true_tok if keep else (true_tok + 1) % 500)
        return out

    return hook


def pinned_truth(plain, spec, mk, dev, tag):
    """The oracle's truth for the requests ``mk()`` makes: the tokens the
    speculative engine itself commits under it.  The plain engine's tokens
    are only a first guess in bf16: a verify row runs another kernel route
    than a decode row, a flipped argmax sends the run off the guess, and
    every later proposal of that request is then rejected (acceptance far
    below ``SPEC_ALPHA``).  So the spec engine serves under the guess, its
    tokens become the next guess, until a run commits exactly its guess.
    Each pass reproduces the last one up to the step where that one left
    its guess, so the first such step moves later every pass.  Returns the
    truth and the plain engine's tokens."""
    reqs = mk()
    serve_reqs(plain, reqs, dev)
    first = [list(r.out_tokens) for r in reqs]
    truth = {r.rid: list(r.out_tokens) for r in reqs}
    for it in range(1, SPEC_TRUTH_PASSES + 1):
        spec._spec_stats = {}
        spec._proposal_hook = oracle_hook(truth, SPEC_ALPHA, SEED)
        reqs = mk()
        serve_reqs(spec, reqs, dev)
        got = {r.rid: list(r.out_tokens) for r in reqs}
        same = sum(x == y for r in reqs for x, y in zip(got[r.rid], truth[r.rid]))
        log(f"{tag} truth pass {it}: {same}/{sum(map(len, got.values()))} spec tokens equal "
            f"to the guess, {spec_line(spec)}")
        if got == truth:
            return truth, first
        truth = got
    raise AssertionError(f"{tag}: the spec engine left its own tokens after "
                         f"{SPEC_TRUTH_PASSES} passes")


def check_pinned(eng, alpha, k, what) -> dict:
    """The observed tokens a round against ``expected_accepted_tokens``:
    a round commits T = min(G, k) + 1 tokens, G the leading accepted
    proposals (P(T = t) = alpha^(t-1) (1 - alpha) for t <= k, alpha^k for
    k + 1); the mean of ``rounds`` rounds must lie within 4 standard errors."""
    rep = eng.speculation_report()["classes"]["default"]
    p = [alpha ** (t - 1) * (1 - alpha) for t in range(1, k + 1)] + [alpha ** k]
    mean = sum(t * q for t, q in zip(range(1, k + 2), p))
    sd = math.sqrt(sum((t - mean) ** 2 * q for t, q in zip(range(1, k + 2), p)))
    want = expected_accepted_tokens(alpha, k)
    tol = 4 * sd / math.sqrt(rep["rounds"])
    if abs(rep["tokens_per_round"] - want) > tol:
        raise AssertionError(f"{what}: {rep['tokens_per_round']:.3f} tokens a round over "
                             f"{rep['rounds']} rounds, expected {want:.3f} +- {tol:.3f} at "
                             f"a = {alpha}")
    return dict(rep, expected_tokens_per_round=want, tolerance=tol)


def spec_line(eng) -> str:
    rep = eng.speculation_report()["classes"]["default"]
    return (f"{rep['rounds']} rounds, acceptance {rep['acceptance_rate']:.3f}, "
            f"{rep['tokens_per_round']:.3f} tokens a round")


def phase_parity_spec(dev) -> dict:
    """fp32, full-width llama3.2-1b cut to 8 layers (the script's time
    limit), 8 slots, max_len 2048, 16
    requests of 100-600 prompt tokens, 32 new each: the speculative
    engine's tokens equal the plain engine's at k = 3 (verify rows on the
    decode kernel) and k = 4 (the chunk tile), dense and paged (P 64), with
    a noisy draft of the same size (partial acceptance required); with the
    target as its own draft, every proposal is accepted (k + 1 tokens a
    round).  Target and draft forwards are held to their launches each.
    The engines plan with ETF: on one card every method places both models
    on it, and the joint Moirai solve over two 16-layer models runs to its
    20 s limit ([serve-spec] and the CLI keep Moirai)."""
    tag = "[parity-spec]"
    cfg = full_cfg(LLAMA, dtype="float32", n_layers=8)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    draft = noisy_copy(params, SPEC_NOISE, SEED + 7, dev)
    mk = lambda: spec_requests(cfg, seed=SEED + 1)  # noqa: E731
    verify, plain = {}, {}
    for paged in (False, True):
        kv = "paged P64" if paged else "dense"
        eng = (make_paged_engine(cfg, params, dev, slots=8, max_len=2048, page_tokens=64)
               if paged else make_engine(cfg, params, dev, slots=8, max_len=2048))
        reqs = mk()
        reset_counts()
        wall = serve_reqs(eng, reqs, dev)
        require(counts(), path(LLAMA, paged), f"fp32 plain {kv}")
        plain[paged] = [r.out_tokens for r in reqs]
        log(f"{tag} fp32 plain engine {kv}: {wall:.2f}s, launches {counts()}")
        del eng
        for k in SPEC_K:
            eng = make_spec_engine(cfg, params, dev, cfg, draft, k=k,
                                   page_tokens=64 if paged else None, method="etf")
            reqs = mk()
            reset_counts()
            with EngineForwards() as fl:
                wall = serve_reqs(eng, reqs, dev)
            got = counts()
            tsteps, dsteps = fl.of(executor=eng.executor), fl.of(executor=eng._draft_executor)
            require(got, spec_path(cfg, k, paged), f"fp32 spec {kv} k={k}")
            check_forwards(tsteps, cfg, f"spec {kv} k={k} target", paged=paged)
            check_forwards(dsteps, cfg, f"spec {kv} k={k} draft")
            verify[(paged, k)] = verify_launches(tsteps, k, paged)
            if not verify[(paged, k)]:
                raise AssertionError(f"spec {kv} k={k}: no [8, {k + 1}] verify forward ran")
            rep = eng.speculation_report()["classes"]["default"]
            if [r.out_tokens for r in reqs] != plain[paged]:
                diff = sum(a != b for a, b in zip([r.out_tokens for r in reqs], plain[paged]))
                raise AssertionError(f"spec {kv} k={k}: fp32 tokens differ from the plain "
                                     f"engine's in {diff} of 16 requests")
            if not 0 < rep["acceptance_rate"] < 1:
                raise AssertionError(f"spec {kv} k={k}: acceptance not partial: {rep}")
            route = "decode kernel" if (k + 1) * 4 <= fa._decode_rows(64) else "chunk tile"
            log(f"{tag} fp32 spec {kv} k={k}, draft = target + {SPEC_NOISE} N(0,1): {wall:.2f}s, "
                f"{spec_line(eng)}; tokens equal to the plain engine's (16 x 32); target "
                f"forwards by S {forward_shapes(tsteps)}, draft {forward_shapes(dsteps)}; "
                f"verify [8, {k + 1}] on the {route}: {verify[(paged, k)]} flash launches; every "
                f"forward {norms_per_forward(cfg)} RMSNorms on the rows kernel and {cfg.n_layers} "
                f"flash calls on the route the rule gives; launches {got}")
            del eng
            free_card()
    k = SPEC_K[-1]
    eng = make_spec_engine(cfg, params, dev, cfg, params, k=k, method="etf")
    reqs = mk()
    wall = serve_reqs(eng, reqs, dev)
    rep = eng.speculation_report()["classes"]["default"]
    if [r.out_tokens for r in reqs] != plain[False]:
        raise AssertionError("self-draft spec: fp32 tokens differ from the plain engine's")
    if not (rep["acceptance_rate"] == 1.0 and rep["tokens_per_round"] == k + 1):
        raise AssertionError(f"self-draft spec: not every proposal accepted: {rep}")
    log(f"{tag} fp32 self draft k={k}: {wall:.2f}s, {spec_line(eng)}; tokens equal to the plain "
        "engine's")
    del eng, params, draft
    free_card()
    return verify


def phase_serve_spec(dev) -> dict:
    """bf16, full-width llama3.2-1b: the CLI with ``--draft llama3.2-1b
    --spec-tokens 4``, then [serve]'s traffic (8 slots, max_len 2048, 16
    requests of 100-600 prompt tokens, 32 new) through a plain engine and a
    speculative one (k = 4, a draft of the target's first 2 layers,
    embedding, final norm and head), three runs each in turns; the
    proposals pinned at acceptance SPEC_ALPHA by an oracle hook on the
    spec engine's own tokens (:func:`pinned_truth`), each run held to
    them and its tokens a round to ``expected_accepted_tokens``.  Then
    [trace-spec]."""
    tag = "[serve-spec]"
    cfg = full_cfg(LLAMA)
    log(f"{tag} repro_torch.launch.serve.main(['--arch', '{LLAMA}', '--draft', '{LLAMA}', "
        "'--spec-tokens', '4'])")
    reset_counts()
    t0 = time.perf_counter()
    engine, reqs = serve.main(["--arch", LLAMA, "--draft", LLAMA, "--spec-tokens", "4"])
    torch.cuda.synchronize(dev)
    cli = counts()
    rep = engine.speculation_report()["classes"]
    log(f"{tag} cli: {time.perf_counter() - t0:.1f}s incl. init, launches {cli}, speculation "
        f"{rep}")
    require(cli, DENSE_PATH, "spec serve CLI")
    require_per_forward(cli, cfg, "spec serve CLI")
    if not (rep and all(r.done and len(r.out_tokens) == r.max_new_tokens for r in reqs)):
        raise AssertionError("the spec CLI left requests unserved or ran no round")
    del engine
    free_card()

    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    dcfg, dparams = truncated_draft(cfg, params, DRAFT_LAYERS)
    plain = make_engine(cfg, params, dev, slots=8, max_len=2048)
    t0 = time.perf_counter()
    spec = make_spec_engine(cfg, params, dev, dcfg, dparams, k=SPEC_SERVE_K)
    res = spec._spec_result
    log(f"{tag} spec engine built in {time.perf_counter() - t0:.1f}s: joint placement "
        f"{res.method} ({res.status}) over {len(spec._spec_merged.nodes)} nodes (target "
        f"{len(spec.graph.nodes)}, draft {len(spec._draft_graph.nodes)}); card memory "
        f"allocated {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
    mk = lambda: spec_requests(cfg)  # noqa: E731
    truth, first = pinned_truth(plain, spec, mk, dev, tag)
    plain_tok_s, spec_tok_s = [], []
    out = {}
    for rep_i in range(ENGINE_REPEATS):
        reqs = mk()
        wall = serve_reqs(plain, reqs, dev)
        plain_tok_s.append(sum(len(r.out_tokens) for r in reqs) / wall)
        spec._spec_stats = {}
        spec._proposal_hook = oracle_hook(truth, SPEC_ALPHA, SEED)
        reqs = mk()
        reset_counts()
        with EngineForwards() as fl:
            wall = serve_reqs(spec, reqs, dev)
        got = counts()
        tsteps, dsteps = fl.of(executor=spec.executor), fl.of(executor=spec._draft_executor)
        require(got, DENSE_PATH, "spec engine")
        check_forwards(tsteps, cfg, "spec engine target")
        check_forwards(dsteps, dcfg, "spec engine draft")
        for r in reqs:
            if not (r.done and len(r.out_tokens) == 32
                    and all(0 <= t < cfg.vocab_size for t in r.out_tokens)):
                raise AssertionError(f"request {r.rid} not served right: {r.out_tokens}")
        if any(r.out_tokens != truth[r.rid] for r in reqs):
            raise AssertionError(f"spec run {rep_i + 1} left the pinned truth")
        rep = check_pinned(spec, SPEC_ALPHA, SPEC_SERVE_K, f"spec run {rep_i + 1}")
        toks = sum(len(r.out_tokens) for r in reqs)
        spec_tok_s.append(toks / wall)
        same = sum(x == y for r, b in zip(reqs, first) for x, y in zip(r.out_tokens, b))
        if rep_i == 0:
            out = {"verify_launches": verify_launches(tsteps, SPEC_SERVE_K, False),
                   "spec": rep, "target_shapes": forward_shapes(tsteps),
                   "draft_shapes": forward_shapes(dsteps)}
        log(f"{tag} run {rep_i + 1}/{ENGINE_REPEATS}: plain {plain_tok_s[-1]:.1f} gen tok/s; "
            f"spec k={SPEC_SERVE_K} {spec_tok_s[-1]:.1f} gen tok/s ({toks} tokens in {wall:.3f}s, "
            f"{len(tsteps)} target forwards by S {forward_shapes(tsteps)}, draft "
            f"{forward_shapes(dsteps)}), {spec_line(spec)} (expected "
            f"{rep['expected_tokens_per_round']:.3f} +- {rep['tolerance']:.3f} at a = "
            f"{SPEC_ALPHA}); tokens equal to the pinned truth; to the plain bf16 run's "
            f"{same}/{16 * 32}; launches {got}")
    med_p, med_s = float(np.median(plain_tok_s)), float(np.median(spec_tok_s))
    log(f"{tag} gen tok/s over {ENGINE_REPEATS} runs in turns: plain "
        f"{[round(x, 1) for x in plain_tok_s]} (median {med_p:.1f}), spec "
        f"{[round(x, 1) for x in spec_tok_s]} (median {med_s:.1f}), spec / plain "
        f"{med_s / med_p:.3f} at acceptance {out['spec']['acceptance_rate']:.3f}, "
        f"{out['spec']['tokens_per_round']:.3f} tokens a round; every target forward "
        f"{norms_per_forward(cfg)} RMSNorms, draft {norms_per_forward(dcfg)}; host: {host_line()}")
    phase_trace_spec(plain, spec, cfg, dev)
    del plain, spec, params, dparams
    free_card()
    out.update(cli=cli, plain_tok_s=plain_tok_s, spec_tok_s=spec_tok_s)
    return out


def phase_trace_spec(plain, spec, cfg, dev) -> None:
    """Where a speculative step's time goes: a profiler trace of 16 steps of
    the spec engine on 8 new 300-token prompts (after one untraced step),
    the oracle pinned on the spec engine's own tokens for them."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(1, cfg.vocab_size, size=300).tolist() for _ in range(8)]
    mk = lambda: [Request(rid=1000 + i, prompt=p, max_new_tokens=64)  # noqa: E731
                  for i, p in enumerate(prompts)]
    truth, _ = pinned_truth(plain, spec, mk, dev, "[trace-spec]")
    spec._proposal_hook = oracle_hook(truth, SPEC_ALPHA, SEED)
    spec._spec_stats = {}
    reqs = mk()
    for r in reqs:
        spec.submit(r)
    spec.step()
    torch.cuda.synchronize(dev)
    with EngineForwards() as fl, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(16):
            spec.step()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    report_trace(prof, wall, "[trace-spec]",
                 f"16 speculative engine steps (target forwards by S "
                 f"{forward_shapes(fl.of(executor=spec.executor))}, draft "
                 f"{forward_shapes(fl.of(executor=spec._draft_executor))}; "
                 f"{spec_line(spec)})")
    spec.run_until_drained()
    if any(r.out_tokens != truth[r.rid] for r in reqs):
        raise AssertionError("[trace-spec]: the traced run left the pinned truth")


# ------------------------------------------------------------ router, chaos
ROUTER_SLOTS = 4          # [parity-router]'s engines: 4 slots, max_len 1024 (as [parity])
ROUTER_MAX_LEN = 1024
ROUTER_CRASH_STEP = 20    # router step of [parity-router]'s crash: every row decoding
TERMINAL = ("finished", "shed", "expired", "failed")


def check_launch_sum(fl, cfg, got, what, *, paged=False) -> int:
    """Every forward of the run launched what one forward of ``cfg`` must
    (:func:`check_forwards`), and the run's counters are exactly their sum:
    Σ over replicas of forwards × the per-forward launches.  Returns the
    number of forwards."""
    steps = fl.of()
    check_forwards(steps, cfg, what, paged=paged)
    total = {k: sum(d[k] for _, d in steps) for k in got}
    if total != got:
        raise AssertionError(f"{what}: launches {got} are not the sum of the engines' forwards "
                             f"{total}")
    return len(steps)


def check_terminal(router, reqs, what, n0=0) -> dict:
    """Every submission of the run (the router's terminal records from
    ``n0`` on) ended in exactly one typed terminal state, and the served
    ones plus the shed / expired / failed counters (less earlier runs')
    sum to the submissions."""
    st = router.stats()
    if not all(r.done and r.state in TERMINAL for r in reqs):
        raise AssertionError(f"{what}: a request did not reach a terminal state: "
                             f"{[(r.rid, r.state) for r in reqs]}")
    ends = router.finished[n0:]
    if sorted(id(r) for r in ends) != sorted(id(r) for r in reqs):
        raise AssertionError(f"{what}: {len(ends)} terminal records for {len(reqs)} submissions")
    c = st["counters"]
    earlier = sum(r.state != "finished" for r in router.finished[:n0])
    served = sum(r.state == "finished" for r in ends)
    if served + c["shed"] + c["expired"] + c["failed"] - earlier != len(reqs):
        raise AssertionError(f"{what}: {served} served and counters {c} do not sum to "
                             f"{len(reqs)}")
    return st


def cache_bytes(eng) -> int:
    """Bytes of the engine's KV caches on the card (0 before its first step
    and after :meth:`ServingEngine.release_caches`)."""
    return sum(t.numel() * t.element_size() for t in _tensors(eng.caches or []))


def service_router(cfg, params, dev, cluster, n, *, slots, max_len, page_tokens=None,
                   dispatch="least_loaded", **router_kw):
    """``Router.from_service_plan`` over ``n`` replicas the replica planner
    chose on ``cluster``, every modeled device mapped onto the card."""
    from repro_torch.core.modelgraph import transformer_graph
    from repro_torch.core.replica import plan_replicas
    from repro_torch.serving.router import Router, RouterConfig

    pc = serve_plan(slots, page_tokens)
    graph = transformer_graph(cfg, seq_len=max_len, granularity="block")
    svc = plan_replicas(graph, cluster, pc, replicas=n)
    return Router.from_service_plan(
        cfg, params, cluster, svc, slots=slots, max_len=max_len, plan_cfg=pc,
        config=RouterConfig(dispatch=dispatch, **router_kw), devices=[dev], eos_id=-1,
    )


def faulted_engine(cfg, params, dev, page_tokens):
    """One engine on ``h100_cluster(3)`` (three modeled devices, one card)
    replaying a crash of device 2 at step 2 (prefill chunks in flight), a
    stall of device 1 at step 8 recovered at 11, and a degrade of link
    (0, 1) at step 16 recovered at 19.  Each fault's engine state is kept:
    the rows still mid-prefill when it landed."""
    from repro_torch.serving.faults import FaultEvent, FaultInjector, FaultSchedule

    eng = make_engine(cfg, params, dev, slots=ROUTER_SLOTS, max_len=ROUTER_MAX_LEN,
                      page_tokens=page_tokens, cluster=h100_cluster(3))
    eng.attach_fault_injector(FaultInjector(FaultSchedule([
        FaultEvent(step=2, kind="device_crash", device=2),
        FaultEvent(step=8, kind="device_stall", device=1, factor=0.3, duration=3),
        FaultEvent(step=16, kind="link_degrade", link=(0, 1), factor=0.25, duration=3),
    ])))
    eng.mid_prefill = []
    apply = eng.apply_fault

    def recorded(ev):
        eng.mid_prefill.append(sum(eng._prefill_done.get(s, 0) < len(t)
                                   for s, t in eng._prefill_toks.items()))
        return apply(ev)

    eng.apply_fault = recorded
    return eng


FAULT_REPLANS = ["device 2 failed", "injected stall on device 1 (×0.3)", "device 1 recovered",
                 "injected link fault (0, 1) (bw ×0.25)", "link (0, 1) recovered"]


def phase_parity_router(dev) -> dict:
    """fp32, 2 full-width llama3.2-1b layers (as [parity]), 4 slots, max_len
    1024, 6 requests of 100-600 prompt tokens, 32 new, on ``h100_cluster(2)``
    mapped onto the card, dense and paged (P 64): a one-replica
    ``Router.from_service_plan``, a two-replica router under each dispatch
    policy, and a two-replica router whose replica 0 loses its device at
    router step 20 (its requests retried on replica 1 through a re-prefill)
    all give the direct engine's tokens; so does one engine on three modeled
    devices taking a crash mid-prefill, a stall and its recover, a link
    degrade and its recover (every replan logged).  Every forward is held to
    its launches, and each run's counters to the sum of its forwards.  Then
    two replica retire → spawn cycles on ``h100_cluster(4)`` with the card's
    memory before and after."""
    from repro_torch.serving.faults import FaultEvent, FaultInjector, FaultSchedule

    tag = "[parity-router]"
    cfg = full_cfg(LLAMA, n_layers=2, dtype="float32")
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    mk = lambda: seeded_requests(cfg, requests=6, max_new=32, seed=SEED + 1)  # noqa: E731
    cluster = h100_cluster(2)
    out, wants = {}, {}
    for paged in (False, True):
        kv = "paged P64" if paged else "dense"
        pt = 64 if paged else None
        direct = make_engine(cfg, params, dev, slots=ROUTER_SLOTS, max_len=ROUTER_MAX_LEN,
                             page_tokens=pt, cluster=cluster)
        reqs = mk()
        serve_reqs(direct, reqs, dev)
        want = wants[paged] = [r.out_tokens for r in reqs]
        del direct
        runs = (("1 replica", 1, "least_loaded", None), ("2 replicas", 2, "least_loaded", None),
                ("2 replicas", 2, "shortest_prefill", None),
                ("2 replicas, crash", 2, "least_loaded", ROUTER_CRASH_STEP))
        for name, n, dispatch, crash in runs:
            t0 = time.perf_counter()
            router = service_router(cfg, params, dev, cluster, n, slots=ROUTER_SLOTS,
                                    max_len=ROUTER_MAX_LEN, page_tokens=pt, dispatch=dispatch)
            build = time.perf_counter() - t0
            if crash is not None:
                router.attach_fault_injector(FaultInjector(FaultSchedule([FaultEvent(
                    step=crash, kind="device_crash", device=router.replicas[0].devices[0])])))
            what = f"{kv} {name} {dispatch}"
            reqs = mk()
            reset_counts()
            with EngineForwards(clock=lambda: router.step_count) as fl:
                wall = serve_reqs(router, reqs, dev)
            got = counts()
            require(got, path(LLAMA, paged), what)
            fwds = check_launch_sum(fl, cfg, got, what, paged=paged)
            st = check_terminal(router, reqs, what)
            if [r.out_tokens for r in reqs] != want:
                diff = sum(r.out_tokens != w for r, w in zip(reqs, want))
                raise AssertionError(f"{what}: fp32 tokens differ from the direct engine's in "
                                     f"{diff} of 6 requests")
            if st["finished_by_state"] != {"finished": 6}:
                raise AssertionError(f"{what}: not every request finished: {st}")
            per = {r.name: len(fl.of(r.engine)) for r in router.replicas}
            if n == 2 and not all(per.values()):
                raise AssertionError(f"{what}: a replica ran no forward: {per}")
            note = ""
            if crash is not None:
                c = st["counters"]
                if not (c["crashed_replicas"] == 1 and c["retried"] >= 1):
                    raise AssertionError(f"{what}: the crash did not retire replica 0 and retry "
                                         f"its requests: {c}")
                survivor = router.replicas[1].engine
                resumed = sum(1 for f in fl.steps if f.engine is survivor and f.clock > crash
                              and f.s > 1)
                if not resumed:
                    raise AssertionError(f"{what}: no chunk forward re-prefilled the retried rows")
                note = (f"; crash at router step {crash}: counters {c}, {resumed} chunk forwards "
                        "on replica1 after it (the retried rows' re-prefill)")
                out[("retried", paged)] = c["retried"]
            out[(name, dispatch, paged)] = got
            log(f"{tag} fp32 2 layers {what}: built in {build:.2f}s, served in {wall:.2f}s over "
                f"{router.step_count} router steps; tokens equal to the direct engine's (6 x 32); "
                f"forwards by replica {per}, {fwds} in all, each with its launches; launches "
                f"{got}{note}")
            del router
        eng = faulted_engine(cfg, params, dev, pt)
        reqs = mk()
        reset_counts()
        with EngineForwards() as fl:
            serve_reqs(eng, reqs, dev)
        got = counts()
        check_launch_sum(fl, cfg, got, f"{kv} faulted engine", paged=paged)
        reasons = [h["reason"] for h in eng.replan_history]
        kinds = [e["kind"] for e in eng.fault_log]
        if reasons != FAULT_REPLANS or kinds != ["device_crash", "device_stall", "recover",
                                                 "link_degrade", "recover"]:
            raise AssertionError(f"{kv} faulted engine: faults {kinds}, replans {reasons}")
        if not eng.mid_prefill[0]:
            raise AssertionError(f"{kv} faulted engine: the crash found no row mid-prefill")
        if [r.out_tokens for r in reqs] != want:
            raise AssertionError(f"{kv} faulted engine: fp32 tokens differ from the direct "
                                 "engine's")
        log(f"{tag} fp32 2 layers {kv} engine on h100-x3, faults {kinds} (rows mid-prefill when "
            f"each landed: {eng.mid_prefill}), replans {reasons}: tokens equal to the direct "
            f"engine's; launches {got}")
        out[("faults", paged)] = got
        del eng
        free_card()
    out["memory"] = retire_spawn_cycles(cfg, params, dev, mk, wants[False])
    del params
    free_card()
    return out


def retire_spawn_cycles(cfg, params, dev, mk, want) -> dict:
    """Two replicas of two modeled devices each on ``h100_cluster(4)``
    (health floor 0.75) serve the parity traffic while two cycles run:
    (1) a stall of device 1 at ×0.25 drains replica0 (health 0.625), and
    the pool replan spawns replica2 on its healthy device 0 through
    ``engine_factory``; the traffic is submitted again; (2) a crash of
    device 0 retires replica2 (its last device: its requests are retried),
    and a stall of device 3 drains replica1, whose device 2 hosts the
    spawned replica3.  The card's allocated memory is read before and
    after each cycle: a retired replica's KV caches must not stay resident.
    Every request's tokens must be the direct engine's."""
    from repro_torch.serving.faults import FaultEvent
    from repro_torch.serving.router import Replica, Router, RouterConfig

    tag = "[parity-router]"
    cluster = h100_cluster(4)
    spawns = []

    def factory(devs):
        t0 = time.perf_counter()
        eng = make_engine(cfg, params, dev, slots=ROUTER_SLOTS, max_len=ROUTER_MAX_LEN,
                          cluster=cluster.subcluster(devs))
        spawns.append((list(devs), eng.placement_result.method, len(eng.executor.stages),
                       time.perf_counter() - t0))
        return eng

    router = Router([Replica(name=f"replica{i}", devices=[2 * i, 2 * i + 1],
                             engine=factory([2 * i, 2 * i + 1])) for i in range(2)],
                    engine_factory=factory, config=RouterConfig(health_floor=0.75,
                                                                retry_backoff=1))
    spawns.clear()
    reqs = mk()
    for r in reqs:
        router.submit(r)
    for _ in range(3):
        router.step()
    torch.cuda.synchronize(dev)

    def submit_again():
        for r in mk():
            r.rid += 100
            reqs.append(r)
            router.submit(r)

    def live() -> str:
        return ", ".join(f"{r.name} {r.state} {cache_bytes(r.engine) / 1e6:.1f} MB"
                         for r in router.replicas)

    def spawned(n):
        """Step until the n-th spawn, then 3 steps more: the spawned
        replica takes work and allocates its caches."""
        for _ in range(200):
            if sum(e["kind"] == "replica_spawn" for e in router.events) >= n:
                break
            router.step()
        else:
            raise AssertionError(f"{tag} cycles: no spawn #{n}: {router.events[-8:]}")
        if n == 1:
            submit_again()
        for _ in range(3):
            router.step()
        torch.cuda.synchronize(dev)

    per_cache = cache_bytes(router.replicas[0].engine)
    mem = [torch.cuda.memory_allocated(dev)]
    log(f"{tag} cycles: before, {live()}; card memory allocated {mem[0] / 1e9:.4f} GB; one "
        f"replica's KV caches {per_cache / 1e6:.1f} MB")
    router.apply_fault(FaultEvent(step=0, kind="device_stall", device=1, factor=0.25))
    spawned(1)
    mem.append(torch.cuda.memory_allocated(dev))
    log(f"{tag} cycles: after cycle 1 (drain of replica0 → spawn on [0]; the traffic again), "
        f"{live()}; card "
        f"memory allocated {mem[1] / 1e9:.4f} GB")
    router.apply_fault(FaultEvent(step=0, kind="device_crash", device=0))
    router.apply_fault(FaultEvent(step=0, kind="device_stall", device=3, factor=0.25))
    spawned(2)
    mem.append(torch.cuda.memory_allocated(dev))
    log(f"{tag} cycles: after cycle 2 (crash of replica2, drain of replica1 → spawn on [2]), "
        f"{live()}; card memory allocated {mem[2] / 1e9:.4f} GB")
    router.run_until_drained()
    st = check_terminal(router, reqs, "retire/spawn cycles")
    kinds = [e["kind"] for e in router.events]
    if not (st["counters"]["crashed_replicas"] == 1 and kinds.count("replica_spawn") == 2
            and kinds.count("drain_complete") == 2):
        raise AssertionError(f"{tag} cycles: {st['counters']}, events {kinds}")
    if [r.out_tokens for r in reqs] != want + want:
        raise AssertionError(f"{tag} cycles: fp32 tokens differ from the direct engine's")
    retired = [r for r in router.replicas if r.state == "retired"]
    if any(r.engine.caches is not None for r in retired):
        raise AssertionError(f"{tag} cycles: a retired replica kept its caches")
    live_bytes = sum(cache_bytes(r.engine) for r in router.replicas)
    if mem[2] > mem[0] - 2 * per_cache + live_bytes + per_cache // 2:
        raise AssertionError(f"{tag} cycles: card memory grew over the cycles: {mem}")
    for devs, method, stages, secs in spawns:
        log(f"{tag} spawn on {devs}: plan {method}, {stages} stage(s), engine built in "
            f"{secs:.3f}s")
    log(f"{tag} cycles: card memory allocated {[round(m / 1e9, 4) for m in mem]} GB before, "
        f"after cycle 1, after cycle 2; {len(retired)} retired replicas released "
        f"{len(retired) * per_cache / 1e6:.1f} MB of KV caches; tokens equal to the direct "
        f"engine's; counters {st['counters']}")
    return {"memory_allocated": mem, "cache_bytes": per_cache, "spawns": spawns}


def phase_parity_router_moe(dev) -> dict:
    """fp32, 2 full-width qwen2-moe-a2.7b layers: two replicas on
    ``h100_cluster(2)``, both on the card and stepped in turn, give one
    direct engine's tokens, and every forward of both launches the grouped
    GEMM 3 times a layer: the replicas share its per-card scratch."""
    tag = "[parity-router-moe]"
    cfg = full_cfg(MOE, n_layers=2, dtype="float32")
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    mk = lambda: seeded_requests(cfg, requests=6, max_new=32, seed=SEED + 1)  # noqa: E731
    cluster = h100_cluster(2)
    direct = make_engine(cfg, params, dev, slots=ROUTER_SLOTS, max_len=ROUTER_MAX_LEN,
                         cluster=cluster)
    reqs = mk()
    serve_reqs(direct, reqs, dev)
    want = [r.out_tokens for r in reqs]
    del direct
    router = service_router(cfg, params, dev, cluster, 2, slots=ROUTER_SLOTS,
                            max_len=ROUTER_MAX_LEN)
    reqs = mk()
    reset_counts()
    with EngineForwards() as fl:
        wall = serve_reqs(router, reqs, dev)
    got = counts()
    require(got, path(MOE, paged=False), "moe router")
    fwds = check_launch_sum(fl, cfg, got, "moe router")
    check_terminal(router, reqs, "moe router")
    per = {r.name: sum(d["grouped_gemm"] for _, d in fl.of(r.engine)) for r in router.replicas}
    if not all(per.values()):
        raise AssertionError(f"{tag} a replica never launched the grouped GEMM: {per}")
    if [r.out_tokens for r in reqs] != want:
        raise AssertionError(f"{tag} fp32 tokens differ from the direct engine's")
    log(f"{tag} fp32 2 layers, 2 replicas in turn: {wall:.2f}s, tokens equal to the direct "
        f"engine's (6 x 32); {fwds} forwards, each with 3 x {cfg.n_layers} grouped GEMMs; "
        f"grouped GEMM launches by replica {per}; launches {got}")
    del router, params
    free_card()
    return got


def chaos_schedule(path):
    """The chaos run's schedule over two single-device replicas, saved to
    ``path``: a degrade of link (0, 1) at router step 1, recovered at 3 (no
    replica owns that link, so the router logs it ignored); a stall of
    device 0 to x0.6 at step 2, recovered at 4 (above the 0.5 health floor:
    replica0 stays in service; [parity-router] drains a replica below it);
    a crash of device 1 at step 6, once both replicas hold requests, whose
    requests replica0 then serves."""
    from repro_torch.serving.faults import FaultEvent, FaultSchedule

    s = FaultSchedule([
        FaultEvent(step=1, kind="link_degrade", link=(0, 1), factor=0.5, duration=2),
        FaultEvent(step=2, kind="device_stall", device=0, factor=0.6, duration=2),
        FaultEvent(step=6, kind="device_crash", device=1),
    ], name="chip-chaos")
    s.save(str(path))
    return s


ROUTER_CLI = {
    "two": ["--replicas", "2", "--cluster-size", "2"],
    "auto": ["--replicas", "auto", "--cluster-size", "4"],
    "chaos": ["--replicas", "2", "--cluster-size", "2", "--fault-schedule"],
}


def phase_serve_router(dev) -> dict:
    """bf16, full-width llama3.2-1b: the serve CLI with ``--replicas 2
    --cluster-size 2``, ``--replicas auto --cluster-size 4`` and ``--replicas
    2 --cluster-size 2 --fault-schedule`` (:func:`chaos_schedule`); each
    run's submissions all end in one typed terminal state, the counters sum
    to them, and the kernel launches are the sum of the replicas' forwards.
    Then phase 4's traffic (16 requests of 100-600 prompt tokens, 32 new)
    through one engine of 16 slots and a two-replica router of 8 slots each
    on the one card, in turns, three runs each: the router's host cost, not
    a replica speed-up (the replicas share the card and are stepped one
    after another)."""
    import tempfile

    tag = "[serve-router]"
    cfg = full_cfg(LLAMA)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        sched_path = Path(tmp) / "chaos.json"
        sched = chaos_schedule(sched_path)
        log(f"{tag} chaos schedule '{sched.name}': "
            + "; ".join(f"s{e.step} {e.kind} " + (f"device {e.device}" if e.device is not None
                                                  else f"link {e.link}")
                        + (f" x{e.factor:.3f}" if e.kind in ("device_stall", "link_degrade")
                           else "") + (f" for {e.duration}" if e.duration else "")
                        for e in sched))
        for name, flags in ROUTER_CLI.items():
            argv = ["--arch", LLAMA, *flags] + ([str(sched_path)] if name == "chaos" else [])
            log(f"{tag} repro_torch.launch.serve.main({argv})")
            reset_counts()
            t0 = time.perf_counter()
            with EngineForwards() as fl:
                router, reqs = serve.main(argv)
            torch.cuda.synchronize(dev)
            got = counts()
            require(got, DENSE_PATH, f"router CLI {name}")
            fwds = check_launch_sum(fl, cfg, got, f"router CLI {name}")
            st = check_terminal(router, reqs, f"router CLI {name}")
            if not all(len(r.out_tokens) == r.max_new_tokens for r in reqs
                       if r.state == "finished"):
                raise AssertionError(f"router CLI {name}: a finished request is short")
            per = {r.name: len(fl.of(r.engine)) for r in router.replicas}
            if name == "chaos":
                c = st["counters"]
                if not (c["crashed_replicas"] == 1 and c["retried"] >= 1):
                    raise AssertionError(f"router CLI chaos: the crash retired no replica: {c}")
            log(f"{tag} cli {name}: {time.perf_counter() - t0:.1f}s incl. init and plan, "
                f"{len(router.replicas)} replicas {[(r.name, r.devices, r.state) for r in router.replicas]}, "
                f"{fwds} forwards by replica {per}, each with its launches; counters "
                f"{st['counters']}, terminal {st['finished_by_state']}; launches {got}")
            out[name] = got
            del router
            free_card()
    out["cli"] = out["two"]
    out.update(router_tok_s(cfg, dev))
    return out


def router_tok_s(cfg, dev) -> dict:
    """Phase 4's traffic through one engine (16 slots) and a two-replica
    router (8 slots each) on the one card, three runs each in turns; the
    card's memory before and after the router's construction (the replicas
    share the weights)."""
    tag = "[serve-router]"
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    engine = make_engine(cfg, params, dev, slots=16, max_len=2048)
    torch.cuda.synchronize(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    router = service_router(cfg, params, dev, h100_cluster(2), 2, slots=8, max_len=2048)
    build = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    mem1 = torch.cuda.memory_allocated(dev)
    log(f"{tag} two-replica router (8 slots each) built in {build:.2f}s: card memory allocated "
        f"{mem0 / 1e9:.4f} GB before, {mem1 / 1e9:.4f} GB after (+{(mem1 - mem0) / 1e6:.2f} MB "
        f"for both replicas: the weights are shared)")
    eng_tok_s, router_tok_s, same = [], [], []
    for rep in range(ENGINE_REPEATS):
        reqs = seeded_requests(cfg, requests=16, max_new=32, rid0=100 * rep)
        with EngineForwards() as efl:
            wall = serve_reqs(engine, reqs, dev)
        eng_tok_s.append(sum(len(r.out_tokens) for r in reqs) / wall)
        ref = [r.out_tokens for r in reqs]
        rreqs = seeded_requests(cfg, requests=16, max_new=32, rid0=100 * rep)
        n0 = len(router.finished)
        reset_counts()
        with EngineForwards() as fl:
            wall = serve_reqs(router, rreqs, dev)
        got = counts()
        require(got, DENSE_PATH, "router tok/s")
        check_launch_sum(fl, cfg, got, "router tok/s")
        check_terminal(router, rreqs, "router tok/s", n0)
        for r in rreqs:
            if not (r.state == "finished" and len(r.out_tokens) == 32
                    and all(0 <= t < cfg.vocab_size for t in r.out_tokens)):
                raise AssertionError(f"request {r.rid} not served right: {r.out_tokens}")
        router_tok_s.append(sum(len(r.out_tokens) for r in rreqs) / wall)
        same.append(sum(x == y for r, b in zip(rreqs, ref) for x, y in zip(r.out_tokens, b)))
        per = {r.name: len(fl.of(r.engine)) for r in router.replicas}
        log(f"{tag} run {rep + 1}/{ENGINE_REPEATS}: engine (16 slots) {eng_tok_s[-1]:.1f} gen "
            f"tok/s ({len(efl.steps)} forwards); router (2 x 8 slots) {router_tok_s[-1]:.1f} gen "
            f"tok/s ({wall:.3f}s, "
            f"{router.step_count} router steps so far, forwards by replica {per}); tokens equal "
            f"to the engine's bf16 run {same[-1]}/{16 * 32}")
    torch.cuda.synchronize(dev)
    kv = {r.name: cache_bytes(r.engine) for r in router.replicas}
    med_e, med_r = float(np.median(eng_tok_s)), float(np.median(router_tok_s))
    spread = lambda xs: (max(xs) - min(xs)) / float(np.median(xs))  # noqa: E731
    log(f"{tag} gen tok/s over {ENGINE_REPEATS} runs in turns: engine "
        f"{[round(x, 1) for x in eng_tok_s]} (median {med_e:.1f}, spread {spread(eng_tok_s):.3f}), "
        f"router {[round(x, 1) for x in router_tok_s]} (median {med_r:.1f}, spread "
        f"{spread(router_tok_s):.3f}), router / engine {med_r / med_e:.3f}; KV caches by replica "
        f"{ {k: round(v / 1e6, 1) for k, v in kv.items()} } MB, the engine's "
        f"{cache_bytes(engine) / 1e6:.1f} MB; card memory allocated "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.4f} GB; host: {host_line()}")
    del engine, router, params
    free_card()
    return {"engine_tok_s": eng_tok_s, "router_tok_s": router_tok_s, "replica_kv_bytes": kv,
            "router_build_bytes": mem1 - mem0}


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


# [mesh-ssm]'s scans: zamba2's heads cut over a 2-wide model axis
SSD_MESH = dict(SSD_HEADS[ZAMBA], h=SSD_HEADS[ZAMBA]["h"] // 2)

# the multi-chunk prefill shape: mamba2's heads, 2 rows of 512 tokens
# (four chunks of 128), from a carried state
SSD_PREFILL = dict(b=2, s=512, init=True, **SSD_HEADS[MAMBA])


def phase_check_ssd(dev) -> dict:
    """The SSD kernel against its plain version, fp32 and bf16: the
    reference test's shapes (G 2 and 4, S = 50 not a multiple of the
    chunk), both models' heads at S = 1, 17, 64 and 200, from a zero and a
    random initial state, the multi-chunk prefill shape, and [mesh-ssm]'s
    prefill on zamba2's heads cut over 2 model ranks (40 heads; 4 and 8
    rows of 256 tokens, from a zero and a random state); dt zeroed past
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
        # [mesh-ssm]'s prefill on one rank (half the rows, half the heads),
        # and at all of its rows
        for b in (MESH_SSM_ROWS // 2, MESH_SSM_ROWS):
            for init in (False, True):
                args, st = ssd_inputs(dev, dtype, b=b, s=MESH_SSM_PROMPT, init=init, **SSD_MESH)
                check_ssd_case(f"{ZAMBA} on 2 model ranks B{b} S{MESH_SSM_PROMPT} "
                               f"H{SSD_MESH['h']} init={init}", dtype, args, st, 128, errs)
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
    kept beside its S.  ``page_tokens``: the KV cache in page pools, one
    ``KVPool`` table for all rows; ``cross``: an enc-dec model's cross K/V
    (one encoder pass); ``embeds``: feed ``params["embed"][token]`` as
    ``embeds`` (a stub-frontend model, at the default M-RoPE streams)."""

    def __init__(self, model, params, prompts, max_new, dev, *, chunk=64, max_len=2048,
                 page_tokens=None, cross=None, embeds=False):
        self.model, self.params, self.prompts = model, params, prompts
        self.max_new, self.chunk, self.dev = max_new, chunk, dev
        b = len(prompts)
        self.table = None
        if page_tokens is None:
            self.caches = model.init_cache(b, max_len, dev)
        else:
            pool = KVPool(b, max_len, page_tokens, prefix_sharing=False)
            for i, p in enumerate(prompts):
                pool.alloc_sequence(i, list(p), min(len(p) + max_new, max_len))
            self.caches = model.init_paged_cache(pool.num_pages, page_tokens, b, dev)
            self.table = torch.from_numpy(pool.table_array()).to(dev)
        if cross is not None:
            self.caches["cross"] = cross
        self.embeds = embeds
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
        tok = torch.from_numpy(toks).to(self.dev)
        batch = {"embeds": self.params["embed"][tok.long()]} if self.embeds else {"tokens": tok}
        kw = {} if self.table is None else {"page_table": self.table}
        before = counts()
        logits, self.caches = self.model.fused_step(self.params, batch, self.caches, cache_pos,
                                                    q_lens, **kw)
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


def check_forwards(steps, cfg, what, *, kernels=True, paged=False) -> None:
    """Every forward launched ``norms_per_forward(cfg)`` RMSNorms, all on
    the rows kernel; one flash call per attention block (a dense or MoE
    model's layers, a hybrid's shared-block occurrences) on the paged
    kernel when ``paged`` and the dense one otherwise, on the decode kernel
    exactly when ``S · H / KV <= fa._decode_rows(D)`` (the wrapper's rule);
    the SSD kernel once per Mamba layer when S > 1 and never at S = 1 (the
    tensor-core kernel in bf16, the CUDA-core one in fp32); the grouped
    GEMM 3 times an MoE layer; an enc-dec decoder's cross-attention once a
    layer more, non-causal, on the dense kernel whatever the self cache;
    nothing else.  Without kernels, nothing."""
    mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    attn = (cfg.n_layers // cfg.shared_attn_every if cfg.family == "hybrid"
            else 0 if cfg.family == "ssm" else cfg.n_layers)
    rep = cfg.n_heads // cfg.n_kv_heads
    name = "flash_attention_paged" if paged else "flash_attention"
    norms = norms_per_forward(cfg)
    mma = cfg.dtype == "bfloat16"
    for s, d in steps:
        scans = mamba if s > 1 else 0
        dec = attn if s * rep <= fa._decode_rows(cfg.resolved_head_dim) else 0
        want = {"rmsnorm": norms, "rmsnorm_rows": norms,
                "rmsnorm_generic": 0, "ssd_scan": scans, "ssd_scan_mma": scans if mma else 0,
                "ssd_scan_core": 0 if mma else scans, name: attn, name + "_decode": dec,
                "grouped_gemm": 3 * cfg.n_layers if cfg.n_experts else 0,
                "flash_attention_noncausal": 0}
        if cfg.family == "encdec":
            want["flash_attention"] = want.get("flash_attention", 0) + attn
            want["flash_attention_decode"] = want.get("flash_attention_decode", 0) + dec
            want["flash_attention_noncausal"] = attn
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


SPEC_SSM_NEW = 32


def phase_parity_spec_ssm(dev) -> dict:
    """``spec_generate`` in fp32 at full width against the port's own
    sequential greedy loop (:func:`greedy`): every token equal.  mamba2-130m
    as target and draft (the recurrent draft's snapshot, the target's
    verify-then-commit rewind), with a noisy draft and with a garbage one
    (noise 0.5: acceptance near zero, pure rollback traffic); zamba2-2.7b at
    full width cut to 12 layers (two shared-attention segments: the
    script's time limit) as the target, paged at P 64, with a noisy zamba2
    draft."""
    from repro_torch.models.speculative import spec_generate

    tag = "[parity-spec-ssm]"
    out = {}
    for arch, n, noises, page in ((MAMBA, 4, (SPEC_NOISE, 0.5), None),
                                  (ZAMBA, 3, (SPEC_NOISE,), 64)):
        cfg = full_cfg(arch, dtype="float32", **({"n_layers": 12} if arch == ZAMBA else {}))
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
        prompts = ssm_prompts(cfg, n=n, seed=SEED + 6)
        t0 = time.perf_counter()
        seq = [greedy(model, params, p, SPEC_SSM_NEW, dev) for p in prompts]
        t_seq = time.perf_counter() - t0
        for noise in noises:
            draft = noisy_copy(params, noise, SEED + 7, dev)
            stats = {}
            reset_counts()
            t0 = time.perf_counter()
            got = spec_generate(model, params, model, draft, prompts, [SPEC_SSM_NEW] * n,
                                spec_tokens=3, chunk=64, max_len=2048, page_tokens=page,
                                stats=stats)
            wall = time.perf_counter() - t0
            launched = counts()
            # zamba2: the paged target's verify forwards are [3, 64] (chunk
            # 64), on the paged chunk tile; the draft's caches are dense
            require(launched, ("rmsnorm", "ssd_scan") + (
                ("flash_attention_paged", "flash_attention", "flash_attention_decode")
                if page else ()), f"{arch} spec_generate")
            a = stats["accepted"] / stats["proposed"]
            if got != seq:
                raise AssertionError(f"{arch} noise {noise}: spec_generate's tokens differ from "
                                     f"sequential greedy in "
                                     f"{sum(x != y for x, y in zip(got, seq))} of {n} rows")
            if noise == 0.5 and not a <= 0.05:
                raise AssertionError(f"{arch} noise 0.5: acceptance {a:.3f}, not near zero")
            out[(arch, noise)] = dict(stats, acceptance=a)
            log(f"{tag} {arch} fp32 {cfg.n_layers} layers, {n} prompts of "
                f"{[len(p) for p in prompts]} tokens, {SPEC_SSM_NEW} new, k=3, chunk 64"
                f"{f', target paged P{page}' if page else ''}; draft = target + {noise} N(0,1): "
                f"{stats['rounds']} rounds, acceptance {a:.3f}; tokens equal to sequential greedy "
                f"({wall:.2f}s; sequential {t_seq:.2f}s); launches {launched}")
            del draft
        del params
        free_card()
    return out


def phase_trace_ssm(dev) -> None:
    """Where a zamba2 serve step's time goes: a profiler trace of 16 steps
    of the fused driver (after one untraced step), device time by kernel
    and the card's idle share; zamba2 at full width cut to 18 layers (three
    shared-attention segments: the script's time limit)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = full_cfg(ZAMBA, n_layers=18)
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


# ----------------------------------------------------------- enc-dec and VLM
@contextlib.contextmanager
def plain_kernels():
    """The parity runs' yardstick: within the block, every kernel wrapper an
    attention model calls runs its plain version on the card's tensors, with
    the same masking rule (the slot-based causal test of the flash kernels,
    which the ``naive`` impl does not share once M-RoPE's temporal stream
    is not the slot index), and launches nothing."""
    saved = (fa.flash_attention, fa.flash_attention_paged, rn.rmsnorm)

    def lens(q, q_lens):
        return torch.full((q.shape[0],), q.shape[1], dtype=torch.int32, device=q.device) \
            if q_lens is None else q_lens

    fa.flash_attention = lambda q, k, v, offs, q_lens=None, **kw: fa.flash_attention_plain(
        q, k, v, offs, lens(q, q_lens), **kw)
    fa.flash_attention_paged = lambda q, pk, pv, t, offs, q_lens=None, **kw: (
        fa.flash_attention_paged_plain(q, pk, pv, t, offs, lens(q, q_lens), **kw))
    rn.rmsnorm = rn.rmsnorm_plain
    try:
        yield
    finally:
        fa.flash_attention, fa.flash_attention_paged, rn.rmsnorm = saved


ENC_FRAMES = 512          # frames an enc-dec request carries
ENCDEC_MAX_LEN = 256      # the decoder's self cache: prompts of 8-96 tokens + 32 new


def encode_norms(cfg) -> int:
    """RMSNorm launches of an enc-dec model's encoder pass: 2 a layer and
    the final norm."""
    return 2 * cfg.n_encoder_layers + 1


def encdec_traffic(cfg, dev, *, n=8, seed=SEED):
    """``n`` requests: ``ENC_FRAMES`` frames of N(0, 1) each and a decoder
    prompt of 8-96 tokens (numpy seed ``seed``)."""
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(
        rng.standard_normal((n, ENC_FRAMES, cfg.d_model)).astype(np.float32)).to(dev)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(m)).tolist()
               for m in rng.integers(8, 97, size=n)]
    return frames, prompts


def encode_checked(params, frames, cfg, what, *, kernels=True):
    """One encoder pass and its decoder layers' cross K/V; the pass must
    launch ``encode_norms(cfg)`` RMSNorms on the rows kernel and one
    non-causal flash call a layer (none without kernels)."""
    before = counts()
    memory = encdec.encode(params, frames, cfg)
    after = counts()
    got = {k: after[k] - before[k] for k in after}
    n, layers = encode_norms(cfg), cfg.n_encoder_layers
    want = dict(rmsnorm=n, rmsnorm_rows=n, flash_attention=layers,
                flash_attention_noncausal=layers)
    if not kernels:
        want = {k: 0 for k in want}
    if any(got[k] != v for k, v in want.items()) or any(
            v for k, v in got.items() if k not in want):
        raise AssertionError(f"{what}: the encoder pass launched {got}, not {want}")
    return encdec.cross_kv_cache(params, memory, cfg), got


def phase_parity_encdec(dev) -> dict:
    """``[parity-encdec]``: seamless at full width (d_model 1024, vocab
    256206, D 64), 2 encoder + 2 decoder layers in fp32: 8 requests of 512
    frames and 8-96-token prompts, 32 greedy tokens through the enc-dec
    fused driver (encode once, then ``fused_step`` at chunk 64): the kernels
    and their plain versions give identical tokens, with a dense and with a
    paged (P 64) self cache; every forward held to its launches.  Then
    ``prefill_chunked`` (chunk 64) against ``prefill`` on a [8, 96] prompt
    batch: the same argmax, logits within 1e-3 of the logit scale."""
    tag = "[parity-encdec]"
    cfg = full_cfg(SEAMLESS, n_layers=2, n_encoder_layers=2, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    frames, prompts = encdec_traffic(cfg, dev, seed=SEED + 1)
    tokens, launches = {}, {}
    for name, paged, plain in (("kernels", False, False), ("plain", False, True),
                               ("kernels paged P64", True, False)):
        with plain_kernels() if plain else contextlib.nullcontext():
            reset_counts()
            cross, enc = encode_checked(params, frames, cfg, f"{tag} {name}", kernels=not plain)
            drv = FusedDriver(model, params, prompts, 32, dev, max_len=ENCDEC_MAX_LEN,
                              page_tokens=64 if paged else None, cross=cross)
            tokens[name] = drv.run()
        check_forwards(drv.steps, cfg, f"{tag} {name}", kernels=not plain, paged=paged)
        launches[name] = counts()
        log(f"{tag} fp32 {cfg.n_encoder_layers}+{cfg.n_layers} layers {name}: encoder pass "
            f"{enc}; {len(drv.steps)} decoder forwards; launches {launches[name]}")
        del drv, cross
    for name, toks in tokens.items():
        if toks != tokens["plain"]:
            raise AssertionError(f"{tag} fp32 greedy tokens differ between {name} and plain")
    log(f"{tag} fp32: greedy tokens identical over 8 requests x 32 steps ("
        + ", ".join(tokens) + f"); prompts {[len(p) for p in prompts]} tokens, "
        f"{ENC_FRAMES} frames each")
    toks = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        1, cfg.vocab_size, size=(8, 96)).astype(np.int32)).to(dev)
    whole, _ = model.prefill(params, {"frames": frames, "tokens": toks}, 128)
    chunked, _ = model.prefill_chunked(params, {"frames": frames, "tokens": toks}, 128, chunk=64)
    torch.cuda.synchronize(dev)
    diff = (whole - chunked).abs().max().item()
    scale = whole.abs().max().item()
    if not (torch.equal(whole.argmax(-1), chunked.argmax(-1)) and diff <= 1e-3 * scale):
        raise AssertionError(f"{tag} prefill_chunked differs from prefill: {diff} at {scale}")
    log(f"{tag} fp32 prefill_chunked(64) vs prefill, [8, 96] tokens: last-token logits max abs "
        f"diff {diff:.3e} (logit scale {scale:.3f}), argmax equal in every row")
    del params
    free_card()
    return {"paged": launches["kernels paged P64"], "dense": launches["kernels"]}


def phase_serve_encdec(dev) -> dict:
    """``[serve-encdec]``: seamless at full width and depth (24 + 24 layers,
    bf16, random weights from a seed), the same traffic served three times:
    one encoder pass over the 8 x 512 frames, then the fused driver at
    chunk 64 to 32 new tokens each; generated tok/s (the encoder pass
    included) and the card's peak memory; every encoder pass and decoder
    forward held to its launches.  Then ``[trace-encdec]``."""
    tag = "[serve-encdec]"
    cfg = full_cfg(SEAMLESS)
    model = build_model(cfg)
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"{tag} {SEAMLESS}: {cfg.n_encoder_layers} + {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters; card memory allocated after init "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB; host: {host_line()}")
    frames, prompts = encdec_traffic(cfg, dev)
    tok_s, first, first_counts, per_fwd = [], None, None, None
    for rep in range(ENGINE_REPEATS):
        reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        cross, enc = encode_checked(params, frames, cfg, tag)
        torch.cuda.synchronize(dev)
        t_enc = time.perf_counter() - t0
        drv = FusedDriver(model, params, prompts, 32, dev, max_len=ENCDEC_MAX_LEN, cross=cross)
        out = drv.run()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        got = counts()
        check_forwards(drv.steps, cfg, f"{tag} run {rep + 1}")
        for o in out:
            if not (len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o)):
                raise AssertionError(f"{tag} a request was not served right: {o}")
        toks = sum(len(o) for o in out)
        tok_s.append(toks / wall)
        same = "" if first is None else f", tokens as run 1: {out == first}"
        first = first or out
        first_counts = first_counts or got
        per_fwd = per_fwd or drv.steps[0][1]
        n_big = sum(1 for s, _ in drv.steps if s > 1)
        log(f"{tag} run {rep + 1}/{ENGINE_REPEATS}: 8 requests, {8 * ENC_FRAMES} frames, "
            f"{sum(map(len, prompts))} prompt tokens, {toks} generated in {wall:.3f}s (encoder "
            f"pass {t_enc:.3f}s) = {toks / wall:.1f} generated tok/s; {len(drv.steps)} decoder "
            f"forwards ({n_big} at S=64); encoder launches {enc}; launches {got}{same}")
        del drv, cross
    log(f"{tag} gen tok/s over {ENGINE_REPEATS} runs: {[round(x, 1) for x in tok_s]}; peak card "
        f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    phase_trace_encdec(model, params, cfg, dev)
    del params
    free_card()
    return {"cli": first_counts, "per_forward": per_fwd, "encode": enc, "tok_s": tok_s}


def flash_rows_by_addr(rows) -> dict:
    """Device time (ms) and calls of the flash kernels in ``rows``
    (:func:`device_events`), by how they address K/V: ``DenseKV`` or
    ``PagedKV`` (the merge kernel, which reads only the workspace, apart)."""
    out = {}
    for dt, key, count in rows:
        if "flash_fwd" not in key:
            continue
        kind = "DenseKV" if "DenseKV" in key else "PagedKV" if "PagedKV" in key else "merge"
        ms, n = out.get(kind, (0.0, 0))
        out[kind] = (ms + dt / 1e3, n + count)
    return out


def phase_trace_encdec(model, params, cfg, dev) -> None:
    """``[trace-encdec]``: a profiler trace of 16 decoder steps of the fused
    driver, after one untraced step, with the self cache paged (P 64) so
    the flash rows split by kernel instance: the ``DenseKV`` rows are the
    cross-attention over the 512 encoder keys, the ``PagedKV`` rows the
    causal self-attention."""
    from torch.profiler import ProfilerActivity, profile

    frames, prompts = encdec_traffic(cfg, dev, seed=SEED + 2)
    cross, _ = encode_checked(params, frames, cfg, "[trace-encdec]")
    drv = FusedDriver(model, params, prompts, 64, dev, max_len=ENCDEC_MAX_LEN, page_tokens=64,
                      cross=cross)
    drv.step()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(16):
            drv.step()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    check_forwards(drv.steps, cfg, "[trace-encdec]", paged=True)
    n_big = sum(1 for s, _ in drv.steps[1:] if s > 1)
    rows = flash_rows_by_addr(report_trace(
        prof, wall, "[trace-encdec]", f"16 decoder steps ({n_big} at S=64), self cache paged P64"))
    log("[trace-encdec]   flash by instance: " + "; ".join(
        f"{'cross-attention (DenseKV)' if k == 'DenseKV' else 'self-attention (PagedKV)' if k == 'PagedKV' else 'decode merge'} "
        f"{ms:.3f} ms x{n}" for k, (ms, n) in sorted(rows.items())))
    del drv, cross


VLM_PROMPT = (16, 16, 16, 32)   # 16 text embeds, a 16 x 16 patch grid, 32 text embeds
VLM_MAX_LEN = 512


def vlm_batch(cfg, dev, *, n=8, seed=SEED) -> dict:
    """``n`` requests of the ``VLM_PROMPT`` shape: seeded N(0, 0.02) embeds
    (the scale of the token embeddings) and its image streams."""
    pos = image_streams(*VLM_PROMPT)
    s = pos.shape[1]
    emb = np.random.default_rng(seed).standard_normal((n, s, cfg.d_model)).astype(np.float32)
    return {"embeds": torch.from_numpy(emb * 0.02).to(device=dev, dtype=torch_dtype(cfg)),
            "positions": torch.from_numpy(np.ascontiguousarray(
                np.broadcast_to(pos[:, None], (3, n, s))).astype(np.int32)).to(dev)}


def vlm_generate(model, params, batch, max_new, dev, cfg, what, *, kernels=True):
    """Whole-prompt ``prefill`` of ``batch`` (its own streams), then greedy
    ``decode_step``s feeding ``params["embed"][token]`` as ``embeds``, to
    ``max_new`` tokens a row; every forward held to its launches.  Returns
    the tokens [n, max_new] and the forwards' (S, launches)."""
    steps = []

    def forward(fn, s):
        before = counts()
        out = fn()
        after = counts()
        steps.append((s, {k: after[k] - before[k] for k in after}))
        return out

    s = batch["embeds"].shape[1]
    logits, caches = forward(lambda: model.prefill(params, batch, VLM_MAX_LEN), s)
    toks = [logits.argmax(-1)]
    for i in range(max_new - 1):
        e = params["embed"][toks[-1]][:, None]
        logits, caches = forward(lambda: model.decode_step(
            params, {"embeds": e}, caches, torch.tensor(s + i)), 1)
        toks.append(logits.argmax(-1))
    check_forwards(steps, cfg, what, kernels=kernels)
    return torch.stack(toks, 1).cpu().tolist(), steps


def phase_parity_vlm(dev) -> dict:
    """``[parity-vlm]``: qwen2-vl at full width (d_model 3584, D 128, 28 /
    4), 2 layers in fp32.  8 requests of 16 text embeds, a 16 x 16 patch
    grid and 32 text embeds at Qwen2-VL-style streams (distinct t, h, w on
    the image, so a wrong section split would show): whole-prompt
    ``prefill``, then 31 ``decode_step``s (32 tokens) — the kernels and
    their plain versions give identical tokens.  Then the fused driver at
    the default streams (8 prompts of 100-600 token embeddings, chunk 64,
    32 new): kernels, plain, and kernels with paged KV (P 64), identical
    tokens."""
    tag = "[parity-vlm]"
    cfg = full_cfg(VLM, n_layers=2, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    batch = vlm_batch(cfg, dev, seed=SEED + 1)
    tokens = {}
    for name, plain in (("kernels", False), ("plain", True)):
        with plain_kernels() if plain else contextlib.nullcontext():
            reset_counts()
            tokens[name], steps = vlm_generate(model, params, batch, 32, dev, cfg,
                                               f"{tag} {name}", kernels=not plain)
        log(f"{tag} fp32 2 layers {name}: prefill [8, {batch['embeds'].shape[1]}] at image "
            f"streams + {len(steps) - 1} decode steps; launches {counts()}")
    if tokens["kernels"] != tokens["plain"]:
        raise AssertionError(f"{tag} fp32 greedy tokens differ between kernels and plain")
    log(f"{tag} fp32: greedy tokens identical, kernels vs plain, over 8 requests x 32 steps "
        f"(streams t/h/w of the image: t {VLM_PROMPT[0]}, h and w "
        f"{VLM_PROMPT[0]}..{VLM_PROMPT[0] + VLM_PROMPT[1] - 1})")
    prompts = ssm_prompts(cfg, seed=SEED + 1)
    fused, launches = {}, {}
    for name, paged, plain in (("kernels", False, False), ("plain", False, True),
                               ("kernels paged P64", True, False)):
        with plain_kernels() if plain else contextlib.nullcontext():
            reset_counts()
            drv = FusedDriver(model, params, prompts, 32, dev, page_tokens=64 if paged else None,
                              embeds=True)
            fused[name] = drv.run()
        check_forwards(drv.steps, cfg, f"{tag} fused {name}", kernels=not plain, paged=paged)
        launches[name] = counts()
        log(f"{tag} fp32 2 layers fused driver {name}: {len(drv.steps)} forwards, launches "
            f"{launches[name]}")
        del drv
    for name, toks in fused.items():
        if toks != fused["plain"]:
            raise AssertionError(f"{tag} fused driver tokens differ between {name} and plain")
    log(f"{tag} fp32 fused driver at the default streams: greedy tokens identical over 8 "
        "requests x 32 steps (" + ", ".join(fused) + ")")
    del params
    free_card()
    return {"paged": launches["kernels paged P64"], "dense": launches["kernels"]}


def phase_serve_vlm(dev) -> dict:
    """``[serve-vlm]``: qwen2-vl at full width and depth (28 layers, bf16,
    random weights from a seed): 8 requests of the ``VLM_PROMPT`` shape at
    its image streams, whole-prompt prefill and 31 decode steps (32 new
    tokens each), three runs: generated tok/s and peak card memory; every
    forward held to 28 flash and 57 RMSNorm launches.  Then
    ``[trace-vlm]``: a profiler trace of 16 decode steps."""
    from torch.profiler import ProfilerActivity, profile

    tag = "[serve-vlm]"
    cfg = full_cfg(VLM)
    model = build_model(cfg)
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"{tag} {VLM}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"parameters; card memory allocated after init "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB; host: {host_line()}")
    batch = vlm_batch(cfg, dev)
    s = batch["embeds"].shape[1]
    tok_s, first, first_counts, per_fwd = [], None, None, None
    for rep in range(ENGINE_REPEATS):
        reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out, steps = vlm_generate(model, params, batch, 32, dev, cfg, f"{tag} run {rep + 1}")
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        got = counts()
        if not all(len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o) for o in out):
            raise AssertionError(f"{tag} a request was not served right")
        tok_s.append(8 * 32 / wall)
        same = "" if first is None else f", tokens as run 1: {out == first}"
        first = first or out
        first_counts = first_counts or got
        per_fwd = per_fwd or steps[0][1]
        log(f"{tag} run {rep + 1}/{ENGINE_REPEATS}: 8 requests of {s} embeds, 256 generated in "
            f"{wall:.3f}s = {256 / wall:.1f} generated tok/s; {len(steps)} forwards; launches "
            f"{got}{same}")
    log(f"{tag} gen tok/s over {ENGINE_REPEATS} runs: {[round(x, 1) for x in tok_s]}; peak card "
        f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    # [trace-vlm]: 16 decode steps after the prefill
    logits, caches = model.prefill(params, batch, VLM_MAX_LEN)
    tok = logits.argmax(-1)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(16):
            logits, caches = model.decode_step(params, {"embeds": params["embed"][tok][:, None]},
                                               caches, torch.tensor(s + i))
            tok = logits.argmax(-1)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    report_trace(prof, wall, "[trace-vlm]", f"16 decode steps, 8 rows at depth {s}")
    del params, caches, logits
    free_card()
    return {"cli": first_counts, "per_forward": per_fwd, "tok_s": tok_s}


# ------------------------------------------------ training and planner tools
# one checkpoint a run (steps 20 and 30, for the script's time): the
# resume from step 20 is what the phase holds
TRAIN_ARGS = ["--arch", LLAMA, "--global-batch", "8", "--seq-len", "128",
              "--checkpoint-every", "20"]
PARITY_TRAIN_LR = 1e-3
# [parity-train]'s bound on an updated param, card vs CPU: half a step's
# largest move.  Adam's first step divides g by |g| + 1e-8, so where a
# gradient entry sits near 1e-8 the two sides' summation orders move it by
# a visible share of lr; the first moments (0.1·g) pin the gradients
PARITY_TRAIN_PARAM_TOL = 0.5 * PARITY_TRAIN_LR
PARITY_TRAIN_MOMENT_TOL = 1e-6


def phase_train(dev) -> dict:
    """[train]: ``python -m repro_torch.launch.train`` at llama3.2-1b's full
    width (bf16 params, fp32 moments, remat), 20 steps into a fresh
    checkpoint directory, then run again to 30 (a preemption: it resumes
    from step 20 and runs 10).  Every loss finite, ``steps_run`` 20 then
    10, the latest committed step 20 then 30."""
    from repro_torch.launch import train as train_cli
    from repro_torch.train.checkpoint import latest_step

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    runs = []
    try:
        for steps, want in ((20, 20), (30, 10)):
            free_card()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out = train_cli.main(TRAIN_ARGS + ["--steps", str(steps), "--checkpoint-dir", ckpt])
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            losses, step_s = out["losses"], out["step_s"]
            if out["steps_run"] != want or latest_step(ckpt) != steps:
                raise AssertionError(f"[train] to {steps}: ran {out['steps_run']} steps "
                                     f"(want {want}), latest step {latest_step(ckpt)}")
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"[train] non-finite loss: {losses}")
            med = float(np.median(step_s[1:]))      # the first step warms up
            ck = out["checkpoint"]
            log(f"[train] to step {steps}: {out['steps_run']} steps, losses "
                + " ".join(f"{x:.4f}" for x in losses))
            log(f"[train] to step {steps}: step s median {med:.4f} (first {step_s[0]:.3f}, "
                f"all {' '.join(f'{x:.4f}' for x in step_s)}), "
                f"tokens/s {8 * 128 / med:.1f}, peak {peak / 1e9:.2f} GB, wall {wall:.1f}s, "
                f"checkpoint saves {ck['saves']} (last: snapshot {ck['snapshot_s']:.2f}s, "
                f"write {ck['write_s']:.2f}s)")
            runs.append({"steps": steps, "steps_run": out["steps_run"], "losses": losses,
                         "step_s_median": med, "tokens_per_s": 8 * 128 / med,
                         "peak_bytes": peak, "wall_s": wall, "checkpoint": ck})
            del out
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        free_card()
    return {"runs": runs}


def _tree_to(tree, dev):
    from repro_torch.train.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def _train_batch(cfg, *, b, s, seed=SEED):
    """A numpy-seeded batch of the family's inputs: tokens, frames and
    tokens (enc-dec), or embeds with image-prompt M-RoPE streams (VLM)."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "patch_stub":
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        pos = image_streams(4, 2, 3, s - 10)
        batch["positions"] = np.broadcast_to(pos[:, None, :], (3, b, s)).astype(np.int32).copy()
    elif cfg.frontend == "frame_stub":
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch["labels"][0, :2] = -1
    return batch


def _step_on(cfg, params, batch, dev, *, quant8, accum):
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import make_train_step

    p = _tree_to(params, dev)
    step = make_train_step(build_model(cfg), AdamWConfig(lr=PARITY_TRAIN_LR, warmup_steps=1),
                           accum_steps=accum)
    new_p, new_s, m = step(p, init_opt_state(p, quant8=quant8), batch)
    return _tree_to(new_p, "cpu"), _tree_to(new_s, "cpu"), {k: float(v) for k, v in m.items()}


def _train_parity(cfg, params, batch, dev, what, *, quant8=False, accum=1) -> dict:
    """One train step on the card and one on the CPU, through the same port
    code, from the same params and batch: loss within 1e-4 relative,
    grad norm 1e-3, fp32 moments and updated params within the stated
    bounds (int8 moments within one quantization step)."""
    from repro_torch.train.tree import is_quant_leaf, leaves_with_paths

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    gp, gs, gm = _step_on(cfg, params, batch, dev, quant8=quant8, accum=accum)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cp, cs, cm = _step_on(cfg, params, batch, torch.device("cpu"), quant8=quant8, accum=accum)
    t_cpu = time.perf_counter() - t0
    loss_err = abs(gm["loss"] - cm["loss"]) / abs(cm["loss"])
    gn_err = abs(gm["grad_norm"] - cm["grad_norm"]) / abs(cm["grad_norm"])
    p_err = max(float((a.float() - b.float()).abs().max())
                for (_, a), (_, b) in zip(leaves_with_paths(gp), leaves_with_paths(cp)))
    m_err, q_ok = 0.0, True
    for key in ("m", "v"):
        for (_, a), (_, b) in zip(leaves_with_paths(gs[key], is_quant_leaf),
                                  leaves_with_paths(cs[key], is_quant_leaf)):
            if is_quant_leaf(a):
                da, db = a["q"].float() * a["s"], b["q"].float() * b["s"]
                q_ok &= float((da - db).abs().max()) <= float(torch.maximum(a["s"], b["s"]).max()) * 1.001
            else:
                m_err = max(m_err, float((a - b).abs().max()))
    log(f"[parity-train] {what}: loss {gm['loss']:.6f} vs CPU {cm['loss']:.6f} (rel {loss_err:.2e}), "
        f"grad_norm {gm['grad_norm']:.6f} vs {cm['grad_norm']:.6f} (rel {gn_err:.2e}), "
        f"max param diff {p_err:.3e} (bound {PARITY_TRAIN_PARAM_TOL:.1e}), "
        f"max fp32 moment diff {m_err:.3e}; card {t_card:.2f}s, CPU {t_cpu:.2f}s")
    bad = []
    if not loss_err <= 1e-4:
        bad.append("loss")
    if not gn_err <= 1e-3:
        bad.append("grad_norm")
    if not p_err <= PARITY_TRAIN_PARAM_TOL:
        bad.append("params")
    if not (m_err <= PARITY_TRAIN_MOMENT_TOL and q_ok):
        bad.append("moments")
    if bad:
        raise AssertionError(f"[parity-train] {what}: card and CPU steps differ in {bad}")
    return {"loss": gm["loss"], "loss_rel_err": loss_err, "grad_norm_rel_err": gn_err,
            "max_param_diff": p_err, "max_moment_diff": m_err}


def phase_parity_train(dev) -> dict:
    """[parity-train]: one train step on the card against the same step on
    the CPU: llama3.2-1b at full width cut to 2 layers in fp32 (params
    from a seeded generator), with fp32 moments at accum 1 and with quant8
    moments at accum 2 (the CPU's full-width optimizer step takes ~10 s
    each); then every family's smoke config (MoE's aux, the VLM's [3, B,
    S] positions, enc-dec's frames); and a pallas config refused."""
    from repro_torch.convert import init_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import make_train_step

    out = {}
    cfg = dataclasses.replace(get_config(LLAMA), n_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    batch = _train_batch(cfg, b=2, s=64)
    for quant8, accum in ((False, 1), (True, 2)):
        what = f"{LLAMA} 2 layers fp32 {'quant8' if quant8 else 'fp32'} moments accum {accum}"
        out[what] = _train_parity(cfg, params, batch, dev, what, quant8=quant8, accum=accum)
    del params
    for arch in (LLAMA, GEMMA2, MOE, MAMBA, ZAMBA, SEAMLESS, VLM):
        scfg = get_config(arch).smoke()
        sparams = init_params(scfg, torch.Generator().manual_seed(SEED), "cpu")
        out[arch] = _train_parity(scfg, sparams, _train_batch(scfg, b=4, s=16), dev,
                                  f"{arch} smoke")
    for arch in (LLAMA, SEAMLESS):
        pcfg = dataclasses.replace(get_config(arch), attention_impl="pallas")
        try:
            make_train_step(build_model(pcfg), AdamWConfig())
        except ValueError as e:
            log(f"[parity-train] {arch} pallas refused: {e}")
        else:
            raise AssertionError(f"[parity-train] {arch}: a pallas config was not refused")
    free_card()
    return out


def phase_placeto(dev) -> dict:
    """[placeto]: ``plan(method="placeto")`` for llama3.2-1b's block graph
    on ``h100_cluster(2)``, the policy on the card, beside ``moirai`` on the
    same graph and cluster (latency objective, both)."""
    from repro_torch.core.modelgraph import transformer_graph
    from repro_torch.core.placement import plan

    cfg = get_config(LLAMA)
    graph = transformer_graph(cfg, seq_len=2048, granularity="block")
    cluster = h100_cluster(2)
    res = {}
    for method in ("placeto", "moirai"):
        r = plan(graph, cluster, PlanConfig(method=method, time_limit=20.0))
        if set(r.placement) != set(graph.nodes) or not math.isfinite(r.objective):
            raise AssertionError(f"[placeto] {method}: no complete placement")
        res[method] = {"objective": r.objective, "solve_s": r.solve_time, "method": r.method,
                       "status": r.status, "devices_used": len(set(r.placement.values()))}
        log(f"[placeto] {method}: objective {r.objective:.6e} s ({r.method}, {r.status}), "
            f"solve {r.solve_time:.2f}s, devices used {res[method]['devices_used']}")
    log(f"[placeto] placeto / moirai objective {res['placeto']['objective'] / res['moirai']['objective']:.4f}")
    return res


def phase_calibrate(dev) -> dict:
    """[calibrate]: the calibration CLI on the card; its byte counts must
    equal the CPU's exactly."""
    from repro_torch.launch import calibrate_invariant as cal

    batches = (1, 2, 4, 8)
    t0 = time.perf_counter()
    on_card = cal.collect(batches, dev)
    t_card = time.perf_counter() - t0
    on_cpu = cal.collect(batches, torch.device("cpu"))
    if on_card != on_cpu:
        raise AssertionError(f"[calibrate] card bytes {on_card} != CPU bytes {on_cpu}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "calib.json")
        if cal.main(["--batches", ",".join(map(str, batches)), "--out", path]) != 0:
            raise AssertionError("[calibrate] the CLI failed")
        with open(path) as f:
            payload = json.load(f)
    fr = payload["fractions"]
    log(f"[calibrate] bytes equal on the card and the CPU ({t_card:.2f}s on the card); fractions "
        + ", ".join(f"{c} {fr[c]:.4f}" for c in cal.OPS)
        + f"; shipped conv {payload['shipped_defaults']['conv']}")
    return {"fractions": fr, "bytes_by_batch": payload["bytes_by_batch"]}


# ------------------------------------------------------ the sharded trainer
# [mesh-train], [mesh-moe] and [mesh-elastic]: ranks that share the one card
# (NCCL refuses two ranks on one GPU), joined by gloo; gloo takes CUDA
# tensors in its eager collectives, and DTensor's functional ones are routed
# through those (parallel/collectives.py)
MESH_WORLD = 4
MESH_BATCH, MESH_SEQ, MESH_STEPS = 8, 128, 2
# of qwen2-moe's 24: four ranks share 80 GB, and the functional update
# holds the old and the new params and ZeRO-1 moments at once (4 layers
# ran out of memory on the card: ~20 GB a rank)
MESH_MOE_LAYERS = 2
# of llama3.2-1b's 16, at full width: the script's time limit (at 16 the
# two llama phases took 255 s of the card's time, 4 save ~5 GB of state)
MESH_LLAMA_LAYERS = 4
MESH_LR = 1e-3
MESH_TIMEOUT = 420.0             # seconds one group of ranks may take
MESH_BF16_LOSS_TOL = 1e-2        # relative, sharded vs one process, bf16
MESH_FP32_LOSS_TOL = 1e-5        # relative, fp32
MESH_FP32_PARAM_TOL = 5e-4       # absolute: [parity-train]'s bound
MESH_BF16_NORM_TOL = 1e-2        # relative, the grad norm, bf16
MESH_FP32_NORM_TOL = 1e-4        # relative, fp32
ELASTIC_STEP = 42                # [mesh-elastic]'s checkpoint (the reference test's step)
ELASTIC_LOSS_TOL = 1e-5          # relative, the resumed step vs the 4-rank continuation


def _mesh_rank(rank, world, tmp, fn_name, args, spawned):
    """One rank: joins the group (gloo, on the shared card), runs
    ``fn_name(rank, world, dev, *args)`` and pickles what it returns.
    ``spawned``: the parent's clock when it started the ranks."""
    from repro_torch.launch.mesh import init_ranks

    # four processes share the card: return freed segments to it
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_ranks(rank, world, f"file://{tmp}/store", backend="gloo", device_type="cuda")
    if rank == 0:
        log(f"[mesh] {fn_name}: {world} ranks up {time.time() - spawned:.1f}s after the spawn")
    out = globals()[fn_name](rank, world, dev, *args)
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def spawn_ranks(world, fn, *args, timeout=MESH_TIMEOUT) -> list:
    """``fn(rank, world, dev, *args)`` in ``world`` fresh processes that
    share the card over gloo (a file store); what each returned, in rank
    order.  They start after the kernel build and only load its library.
    A rank that fails, or a group that outlives ``timeout``, fails the
    phase; every process is stopped before this returns."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    spawn = torch.multiprocessing.get_context("spawn")
    procs = [spawn.Process(target=_mesh_rank, args=(r, world, tmp, fn.__name__, args, time.time()))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
        bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if bad:
            raise AssertionError(f"{fn.__name__}: ranks failed or ran past {timeout}s "
                                 f"(exit codes, None = still running): {bad}")
        outs = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_cfg(arch, **kw):
    """The trainer's config at full width (``chunked`` attention)."""
    return dataclasses.replace(get_config(arch), scan_layers=False, remat=False, **kw)


def mesh_batch(cfg, step: int) -> dict:
    """Batch ``step`` of the seeded pipeline: 8 x 128 tokens."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus

    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=MESH_SEQ,
                                        global_batch=MESH_BATCH, seed=SEED))
    return corpus.batch(step)


def _mesh_params(cfg, mesh, ctx, dev):
    """The seeded init (the same on every rank), distributed by the rules."""
    from repro_torch.convert import init_params
    from repro_torch.parallel.sharding import param_shardings

    full = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    params = param_shardings(cfg, mesh, full, pure_dp=ctx.tp_axis is None)
    del full
    free_card()
    return params


def _mesh_steps(cfg, mesh, dev, steps, *, ref=None, save=None) -> dict:
    """``steps`` sharded steps from the seeded init on the pipeline's
    batches: losses, grad norms, step seconds, this rank's peak memory and
    the last step's collectives; with ``ref`` (a saved single-process step,
    rank 0 reads it) the largest difference of the new params from it;
    with ``save`` (a directory) the state after the first step written
    there as step ``ELASTIC_STEP`` (the next step is its continuation),
    and the save's seconds.  The peak leaves out the save's gathers."""
    from repro_torch.launch.dryrun import make_context
    from repro_torch.parallel.collectives import log_collectives
    from repro_torch.parallel.context import parallel_context
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import leaves_with_paths

    ctx = make_context(mesh, cfg, MESH_BATCH)
    p = _mesh_params(cfg, mesh, ctx, dev)
    o = init_opt_state(p, mesh=mesh)
    step = make_train_step(build_model(cfg), AdamWConfig(lr=MESH_LR, warmup_steps=1))
    torch.cuda.reset_peak_memory_stats(dev)
    losses, norms, secs, peak, save_s = [], [], [], 0, None
    for i in range(steps):
        if i == 1 and save is not None:
            peak = torch.cuda.max_memory_allocated(dev)
            torch.distributed.barrier()
            t0 = time.perf_counter()
            save_checkpoint(save, ELASTIC_STEP, {"params": p, "opt": o})
            save_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats(dev)
        batch = mesh_batch(cfg, i)
        torch.cuda.synchronize(dev)
        torch.distributed.barrier()
        t0 = time.perf_counter()
        with parallel_context(ctx), log_collectives() as coll:    # the last step's is kept
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
    out = {"layout": (ctx.dp_axes, ctx.tp_axis), "losses": losses, "grad_norms": norms,
           "step_s": secs, "peak_bytes": max(peak, torch.cuda.max_memory_allocated(dev)),
           "save_s": save_s,
           "collectives": {k: {"calls": int(v[0]), "bytes": int(v[1]), "s": float(v[2])}
                           for k, v in coll.items()},
           "moment_layout": str((o["m"]["layers"][0]["attn"]["wq"] if "layers" in o["m"] else
                                 o["m"]["mamba_layers"][0]["mamba"]["w_x"]).placements)}
    if ref is not None:
        want = torch.load(ref, map_location=dev) if torch.distributed.get_rank() == 0 else None
        diff = 0.0
        for path, leaf in leaves_with_paths(p):
            whole = leaf.full_tensor()
            if want is not None:
                diff = max(diff, float((whole.float() - want["/".join(map(str, path))].float())
                                       .abs().max()))
        out["max_param_diff"] = diff
    del p, o
    free_card()
    return out


def mesh_rank(rank, world, dev, fp32_ref, ckpt, ep_inputs):
    """One rank of the sharded phases: [mesh-train] on the (2 data x 2
    model) mesh, whose bf16 llama run writes [mesh-elastic]'s checkpoint
    into ``ckpt``, then [mesh-moe]'s cases (rank 0 saves the timed case's
    grouped-GEMM inputs to ``ep_inputs``), then [mesh-ssm]'s runs; one
    group of four ranks for them all, since each group costs its
    start-up."""
    from repro_torch.launch.mesh import make_debug_mesh

    from repro_torch.parallel.collectives import functional_collectives_routed

    mesh = make_debug_mesh(world, device_type=dev.type)
    out = {"mesh": dict(mesh.shape), "routed": functional_collectives_routed()}
    for key, cfg, steps, ref, save in (
        ("llama_bf16", mesh_cfg(LLAMA, n_layers=MESH_LLAMA_LAYERS), MESH_STEPS, None, ckpt),
        ("llama_fp32", mesh_cfg(LLAMA, n_layers=2, dtype="float32"), 1, fp32_ref, None),
        ("moe_bf16", mesh_cfg(MOE, n_layers=MESH_MOE_LAYERS), MESH_STEPS, None, None),
    ):
        t0 = time.perf_counter()
        out[key] = _mesh_steps(cfg, mesh, dev, steps, ref=ref, save=save)
        if rank == 0:
            log(f"[mesh-train] rank 0: {key} done in {time.perf_counter() - t0:.1f}s, step s "
                + " ".join(f"{x:.3f}" for x in out[key]["step_s"]))
    t0 = time.perf_counter()
    out["moe"] = mesh_moe_cases(rank, dev, ep_inputs)
    if rank == 0:
        log(f"[mesh-moe] rank 0: {len(out['moe']['cases'])} cases in "
            f"{time.perf_counter() - t0:.1f}s")
    out["ssm"] = mesh_ssm_rank(rank, world, dev)
    return out


def _single_process(cfg, dev, steps, *, aux_shards=1, save=None) -> dict:
    """The same steps in this process on the card: losses and grad norms
    (``aux_shards``: the sharded MoE step's objective, the mean of each DP
    rank's load-balancing loss); ``save``: the new params to that file."""
    from _torch_mesh_ranks import single_step
    from repro_torch.convert import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import leaves_with_paths

    opt_cfg = AdamWConfig(lr=MESH_LR, warmup_steps=1)
    model = build_model(cfg)
    p = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    losses, norms = [], []
    if aux_shards > 1:
        o = None
        for i in range(steps):
            p, o, m = single_step(model, p, mesh_batch(cfg, i), opt_cfg, aux_shards=aux_shards,
                                  opt=o)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    else:
        step, o = make_train_step(model, opt_cfg), init_opt_state(p)
        for i in range(steps):
            p, o, m = step(p, o, mesh_batch(cfg, i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    if save is not None:
        torch.save({"/".join(map(str, path)): t.cpu() for path, t in leaves_with_paths(p)}, save)
    del p, o
    free_card()
    return {"losses": losses, "grad_norms": norms}


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def _collectives_line(c: dict) -> str:
    return ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 1e6:.1f} MB {v['s']:.3f}s"
                     for k, v in sorted(c.items()))


def phase_mesh_train(dev, ckpt, ep_inputs) -> dict:
    """[mesh-train]: four ranks on the card over gloo, a (2 data x 2 model)
    mesh.  llama3.2-1b at full width (vocab 128256) and
    ``MESH_LLAMA_LAYERS`` of its 16 layers, bf16
    params, fp32 ZeRO-1 moments, 8 x 128 tokens a step from the seeded
    pipeline, 2 steps: every loss finite, and each step's loss and grad
    norm within 1e-2 relative of the same steps in one process on the
    card; the state after the first step is [mesh-elastic]'s checkpoint
    (written into ``ckpt``).  2 layers in fp32: loss within 1e-5 relative,
    grad norm within 1e-4 and every param within 5e-4 of one process.
    qwen2-moe pure DP x EP (``make_context``: no TP; experts over
    ``data``, the all-to-all MoE) at full width and 2 of 24 layers, 2 bf16
    steps, against one process taking the sharded objective: losses and
    grad norms as llama's (a gradient summed twice doubles the norm; the
    second loss follows the ZeRO-1 update).  Step times, peak memory per
    rank and each collective's bytes and time.  The same ranks then run
    [mesh-moe]'s cases (returned under ``moe``; the timed case's inputs
    saved to ``ep_inputs``)."""
    free_card()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_ref_")
    try:
        fp32_ref = os.path.join(tmp, "llama_fp32_step.pt")
        t0 = time.perf_counter()
        refs = {
            "llama_bf16": _single_process(mesh_cfg(LLAMA, n_layers=MESH_LLAMA_LAYERS), dev,
                                          MESH_STEPS),
            "llama_fp32": _single_process(mesh_cfg(LLAMA, n_layers=2, dtype="float32"), dev, 1,
                                          save=fp32_ref),
            "moe_bf16": _single_process(mesh_cfg(MOE, n_layers=MESH_MOE_LAYERS), dev, MESH_STEPS,
                                        aux_shards=MESH_WORLD),
        }
        t_ref = time.perf_counter() - t0
        log(f"[mesh-train] single-process references {t_ref:.1f}s; this process holds "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
            f"({torch.cuda.memory_reserved(dev) / 1e9:.2f} reserved) as the ranks start")
        t0 = time.perf_counter()
        outs = spawn_ranks(MESH_WORLD, mesh_rank, fp32_ref, ckpt, ep_inputs)
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[mesh-train] {MESH_WORLD} ranks on cuda:0 over gloo, mesh {outs[0]['mesh']}; "
        f"single-process references {t_ref:.1f}s, ranks {t_ranks:.1f}s (start-up included); "
        "gloo's eager calls take CUDA tensors, DTensor's functional all-reduce, all-gather, "
        "reduce-scatter and all-to-all run through them: "
        f"{all(o['routed'] for o in outs)}")
    if not all(o["routed"] for o in outs):
        raise AssertionError("[mesh-train] DTensor's functional collectives were not routed")
    result = {"ranks_s": t_ranks, "references_s": t_ref, "moe": [o["moe"] for o in outs],
              "ssm": [o["ssm"] for o in outs]}
    for key, what in (("llama_bf16", f"{LLAMA} bf16 {MESH_LLAMA_LAYERS} layers"),
                      ("llama_fp32", f"{LLAMA} fp32 2 layers"),
                      ("moe_bf16", f"{MOE} bf16 {MESH_MOE_LAYERS} layers")):
        r0, ref = outs[0][key], refs[key]
        errs = [_rel(a, b) for a, b in zip(r0["losses"], ref["losses"])]
        norm_errs = [_rel(a, b) for a, b in zip(r0["grad_norms"], ref["grad_norms"])]
        tol = MESH_FP32_LOSS_TOL if "fp32" in key else MESH_BF16_LOSS_TOL
        norm_tol = MESH_FP32_NORM_TOL if "fp32" in key else MESH_BF16_NORM_TOL
        med = float(np.median(r0["step_s"][1:] or r0["step_s"]))
        peaks = [o[key]["peak_bytes"] / 1e9 for o in outs]
        log(f"[mesh-train] {what}: layout dp {r0['layout'][0]} tp {r0['layout'][1]}, moments "
            f"{r0['moment_layout']}; losses {' '.join(f'{x:.5f}' for x in r0['losses'])} vs one "
            f"process {' '.join(f'{x:.5f}' for x in ref['losses'])} (rel {max(errs):.2e}, bound "
            f"{tol:.0e}); grad norms {' '.join(f'{x:.5f}' for x in r0['grad_norms'])} vs "
            f"{' '.join(f'{x:.5f}' for x in ref['grad_norms'])} (rel {max(norm_errs):.2e}, bound "
            f"{norm_tol:.0e}); "
            f"step s {' '.join(f'{x:.3f}' for x in r0['step_s'])} (median {med:.3f}); "
            f"peak GB per rank {' '.join(f'{x:.2f}' for x in peaks)}")
        log(f"[mesh-train] {what}: collectives of one step, rank 0: "
            f"{_collectives_line(r0['collectives'])}")
        if (len(r0["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, r0["losses"]))
                or not max(errs) <= tol):
            raise AssertionError(f"[mesh-train] {what}: sharded losses {r0['losses']} vs "
                                 f"{ref['losses']}")
        if not max(norm_errs) <= norm_tol:
            raise AssertionError(f"[mesh-train] {what}: sharded grad norms {r0['grad_norms']} vs "
                                 f"{ref['grad_norms']}")
        if key == "llama_fp32":
            log(f"[mesh-train] {what}: max param diff {r0['max_param_diff']:.3e} "
                f"(bound {MESH_FP32_PARAM_TOL:.0e})")
            if not r0["max_param_diff"] <= MESH_FP32_PARAM_TOL:
                raise AssertionError(f"[mesh-train] {what}: params differ from one process")
        result[key] = {"losses": r0["losses"], "single_losses": ref["losses"],
                       "loss_rel_err": max(errs), "grad_norm_rel_err": max(norm_errs),
                       "step_s": r0["step_s"], "step_s_median": med, "save_s": r0["save_s"],
                       "peak_gb": peaks, "collectives": r0["collectives"],
                       "layout": r0["layout"]}
    if outs[0]["moe_bf16"]["layout"][1] is not None:
        raise AssertionError("[mesh-train] qwen2-moe did not take the pure DP x EP layout")
    return result


def moe_layer_params(cfg, dev, dtype, seed=SEED) -> dict:
    """One MoE layer's router and experts at the init's distributions,
    drawn on the card from a seed (the same on every rank)."""
    g = torch.Generator(dev).manual_seed(seed)
    e, d, f = cfg.n_experts_padded or cfg.n_experts, cfg.d_model, cfg.moe_d_ff

    def normal(shape, std, dt):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dt)

    return {"router": normal((d, e), d ** -0.5, torch.float32),
            "w_gate": normal((e, d, f), d ** -0.5, dtype),
            "w_up": normal((e, d, f), d ** -0.5, dtype),
            "w_down": normal((e, f, d), f ** -0.5, dtype)}


def mesh_moe_cases(rank, dev, ep_inputs):
    """[mesh-moe] on one rank: ``moe_ep`` forward at qwen2-moe's widths.
    Rank 0 saves the grouped GEMM's gate and down inputs of the pure DP x
    EP bf16 call at qwen2-moe's capacity factor to ``ep_inputs``, to be
    timed once no rank is left (:func:`time_gg_ep`)."""
    from repro_torch.launch.mesh import PartitionSpec as P, make_mesh
    from repro_torch.models.moe import moe_reference
    from repro_torch.parallel.context import ParallelContext, default_rules
    from repro_torch.parallel.moe_parallel import moe_ep
    from repro_torch.parallel.sharding import distribute, param_pspec_tree

    base = get_config(MOE)
    cases = []
    layouts = (("pure DP x EP, 4 EP ranks", (4, 1), True), ("TP in experts, 2 x 2", (2, 2), False))
    meshes = {shape: make_mesh(shape, ("data", "model"), dev.type) for _, shape, _ in layouts}
    for what, shape, pure in layouts:
        mesh = meshes[shape]
        ctx = ParallelContext(mesh, default_rules(False), ep_axes=("data",),
                              dp_axes=("data", "model") if pure else ("data",),
                              tp_axis=None if pure else "model")
        for dtype in (torch.bfloat16, torch.float32):
            cfg = dataclasses.replace(base, dtype=str(dtype).split(".")[1])
            p = moe_layer_params(cfg, dev, dtype)
            x = torch.randn(MESH_BATCH, MESH_SEQ, cfg.d_model, dtype=torch.float32, device=dev,
                            generator=torch.Generator(dev).manual_seed(SEED + 1)).to(dtype)
            specs = param_pspec_tree(cfg, mesh, {"moe": p}, pure_dp=pure)["moe"]
            pd = {k: distribute(v, mesh, specs[k]) for k, v in p.items()}
            xd = distribute(x, mesh, P(ctx.dp_axes, None, None))
            for cf in (cfg.capacity_factor, 8.0):
                c = dataclasses.replace(cfg, capacity_factor=cf)
                calls, kernel = [], gg.grouped_gemm

                def recorded(a, w, sizes):
                    out = kernel(a, w, sizes)
                    calls.append((a, w, sizes, out))
                    return out

                stats_k, stats_p = {}, {}
                with torch.no_grad():
                    gg.grouped_gemm = recorded
                    try:
                        reset_counts()
                        yk, aux_k = moe_ep(pd, xd, c, ctx, kernel=True, stats=stats_k)
                        torch.cuda.synchronize(dev)
                        launches = counts()["grouped_gemm"]
                    finally:
                        gg.grouped_gemm = kernel
                    # B4 against its plain version on this rank's inputs
                    gg_err = max(within(out, gg.grouped_gemm_plain(a, w, sizes))
                                 for a, w, sizes, out in calls)
                    yp, aux_p = moe_ep(pd, xd, c, ctx, kernel=False, stats=stats_p)
                    route_err = within(yk.to_local(), yp.to_local())
                    whole = yk.full_tensor()
                    oracle_err = None
                    if cf >= 8.0 and rank == 0:
                        oracle_err = within(whole, moe_reference(p, x, c))
                case = {"what": what, "dtype": str(dtype), "capacity_factor": cf,
                        "launches": launches, "gg_max_abs_err": gg_err,
                        "route_max_abs_err": route_err, "oracle_max_abs_err": oracle_err,
                        "dropped_kernel": stats_k["dropped"], "dropped_plain": stats_p["dropped"],
                        "rows": [int(a.shape[0]) for a, _, _, _ in calls],
                        "aux": float(aux_k.full_tensor()), "aux_plain": float(aux_p.full_tensor())}
                if pure and dtype == torch.bfloat16 and cf < 8.0:
                    case["timed"] = True
                    if rank == 0:
                        torch.save({proj: {"x": a.cpu(), "w": w.cpu(), "group_sizes": sizes.cpu()}
                                    for proj, (a, w, sizes, _) in (("gate_up", calls[0]),
                                                                   ("down", calls[2]))},
                                   ep_inputs)
                torch.distributed.barrier()
                cases.append(case)
            del p, x, pd, xd
            free_card()
    return {"cases": cases, "library": _build.load()._name}


def phase_mesh_moe(outs, dev, ep_inputs) -> dict:
    """[mesh-moe]: ``moe_ep``'s forward at qwen2-moe's widths (d 2048,
    moe_d_ff 1408, 60 routed experts padded to 64, top-4, 8 x 128 tokens)
    on four ranks sharing the card: pure DP x EP on four EP ranks (4 x 1),
    and (2 x 2) with TP inside the experts; bf16 and fp32; at qwen2-moe's
    capacity factor 1.25 and at 8.0.  Each call launches the grouped GEMM
    3 times a rank (counted by its wrapper); each launch is held to
    ``grouped_gemm_plain`` on the same inputs within ``[check]``'s
    tolerances, the layer's output to the plain route's, and at 8.0 (no
    drops) to the dense oracle ``moe_reference``; both routes drop the
    same slots.  ``outs``: each rank's cases, run by [mesh-train]'s
    ranks.  Then B4 timed at the EP shapes in this process, no rank left
    (``ep_inputs``: rank 0's saved inputs)."""
    log(f"[mesh-moe] {MESH_WORLD} ranks on cuda:0 over gloo; the ranks loaded "
        f"{os.path.basename(outs[0]['library'])} (built by [build])")
    result = {"cases": []}
    for i, case in enumerate(outs[0]["cases"]):
        per_rank = [o["cases"][i] for o in outs]
        launches = [c["launches"] for c in per_rank]
        drops = [(c["dropped_kernel"], c["dropped_plain"]) for c in per_rank]
        gg_err = max(c["gg_max_abs_err"] for c in per_rank)
        route_err = max(c["route_max_abs_err"] for c in per_rank)
        log(f"[mesh-moe] {case['what']} {case['dtype']} cf {case['capacity_factor']}: grouped GEMM "
            f"launches per rank {launches}, rows per rank {[c['rows'][0] for c in per_rank]}, "
            f"kernel vs plain max abs err {gg_err:.3e}, layer kernel route vs plain "
            f"{route_err:.3e}, vs moe_reference {case['oracle_max_abs_err']}, dropped slots "
            f"(kernel, plain) {drops}, aux {case['aux']:.6f} / {case['aux_plain']:.6f}")
        if any(n != 3 for n in launches):
            raise AssertionError(f"[mesh-moe] {case['what']}: grouped GEMM launches {launches}, "
                                 "want 3 a rank")
        if any(a != b for a, b in drops):
            raise AssertionError(f"[mesh-moe] {case['what']}: the routes dropped {drops}")
        if case["capacity_factor"] >= 8.0 and any(a for a, _ in drops):
            raise AssertionError(f"[mesh-moe] {case['what']}: drops at capacity factor 8")
        result["cases"].append({**case, "launches_per_rank": launches, "gg_max_abs_err": gg_err,
                                "route_max_abs_err": route_err, "dropped": drops})
    result["ep"] = time_gg_ep(dev, ep_inputs)
    return result


def time_gg_ep(dev, path) -> dict:
    """B4 at ``moe_ep``'s EP shapes (rank 0's gate and down inputs of the
    pure DP x EP bf16 call at capacity 1.25), timed in this process with
    no rank alive: the kernel, its plain version and ``torch._grouped_mm``,
    the L2 flushed before each call as in the timing phase, beside the
    bound of these inputs."""
    inputs = torch.load(path)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    out = {}
    for proj, host in inputs.items():
        inp = {k: v.to(dev) for k, v in host.items()}
        byts, flops = gg_work(inp)
        b_ms, b_by = bound(byts, flops, torch.bfloat16)
        label, lib = gg_library(inp)
        ref = run_gg(gg.grouped_gemm_plain, inp)
        lib_out = lib()
        lib_out = torch.cat(lib_out) if isinstance(lib_out, list) else lib_out
        r = out[proj] = dict(
            shape=[list(inp["x"].shape), list(inp["w"].shape)],
            max_abs_err=within(run_gg(gg.grouped_gemm, inp), ref),
            ms=time_ms(dev, lambda: run_gg(gg.grouped_gemm, inp), flush=flush),
            plain_ms=time_ms(dev, lambda: run_gg(gg.grouped_gemm_plain, inp), iters=10,
                             flush=flush),
            library_ms=time_ms(dev, lib, iters=20, flush=flush), library=label,
            library_max_abs_diff=(lib_out.float() - ref.float()).abs().max().item(),
            bound_ms=b_ms, bound_by=b_by, bytes=byts, flops=flops,
        )
        log(f"[mesh-moe] grouped GEMM {proj} at the EP shape x {r['shape'][0]} w {r['shape'][1]} "
            f"({int((inp['group_sizes'] > 0).sum())} experts with rows), this process alone: "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, {label} "
            f"{r['library_ms']:.4f} ms (max abs diff to plain {r['library_max_abs_diff']:.3e}), "
            f"bound {b_ms:.5f} ms ({b_by}: {byts / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
            f"kernel/bound {r['ms'] / b_ms:.2f}x")
        del inp, ref, lib_out
    del flush
    return out


def mesh_moe_entry(mesh_moe) -> dict:
    """The grouped GEMM's ``kernels`` entry for ``moe_ep``: launches per
    rank per call, the largest error against its plain version over every
    case, and the times at the EP shapes (:func:`time_gg_ep`)."""
    timed_case = next(c for c in mesh_moe["cases"] if c.get("timed"))
    return {
        "launches_per_rank_per_call": sorted({n for c in mesh_moe["cases"]
                                              for n in c["launches_per_rank"]}),
        "calls": len(mesh_moe["cases"]),
        "max_abs_err": {dt: max(c["gg_max_abs_err"] for c in mesh_moe["cases"]
                                if c["dtype"] == dt)
                        for dt in ("torch.bfloat16", "torch.float32")},
        "layout": timed_case["what"],
        **{proj: {k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library")}
           for proj, r in mesh_moe["ep"].items()},
    }


def mesh_elastic_resume_rank(rank, world, dev, ckpt):
    """[mesh-elastic], two ranks: ``elastic_resume`` of [mesh-train]'s
    full-width bf16 llama3.2-1b state on (1 x 2) (restored to the host,
    each rank's slices moved to the card); every restored tensor gathered
    whole against the checkpoint's array (the ranks share the leaves);
    then the next step."""
    from repro_torch.launch.dryrun import make_context
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel.context import parallel_context
    from repro_torch.train.elastic import elastic_resume
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import leaves_with_paths

    cfg = mesh_cfg(LLAMA, n_layers=MESH_LLAMA_LAYERS)
    mesh = make_debug_mesh(world, device_type=dev.type)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    at, p, o = elastic_resume(cfg, mesh, ckpt, global_batch=MESH_BATCH)
    torch.cuda.synchronize(dev)
    resume_s = time.perf_counter() - t0
    resume_peak = torch.cuda.max_memory_allocated(dev)
    # each rank holds every other leaf, gathered whole, to its stored array
    # (read one at a time), bit for bit on the card
    stored = np.load(os.path.join(ckpt, f"step_{at:08d}", "arrays.npz"))
    signed = {2: np.int16, 4: np.int32, 8: np.int64}
    unequal, checked = [], 0
    for i, (path, leaf) in enumerate(leaves_with_paths({"params": p, "opt": o})):
        whole = (leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf).detach()
        if i % world != rank:
            continue
        key = "/".join(map(str, path))
        want = stored[key]
        want = torch.from_numpy(want.view(signed[want.itemsize])).to(dev)
        got = whole.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[whole.element_size()])
        checked += 1
        if not torch.equal(got, want):
            unequal.append(key)
        del whole, got, want
    step = make_train_step(build_model(cfg), AdamWConfig(lr=MESH_LR, warmup_steps=1))
    torch.distributed.barrier()
    t0 = time.perf_counter()
    with parallel_context(make_context(mesh, cfg, MESH_BATCH)):
        _, _, m = step(p, o, mesh_batch(cfg, 1))
        loss = float(m["loss"])
    return {"mesh": dict(mesh.shape), "step": at, "unequal": unequal, "checked": checked,
            "loss": loss, "resume_s": resume_s, "resume_peak_gb": resume_peak / 1e9,
            "step_s": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "wq": str(p["layers"][0]["attn"]["wq"].placements)}


def phase_mesh_elastic(four, ckpt) -> dict:
    """[mesh-elastic]: [mesh-train]'s bf16 llama3.2-1b state (full width,
    ``MESH_LLAMA_LAYERS`` layers)
    after its first step, saved by the four ranks on (2 x 2) as step 42
    (``four``: that run's results; the checkpoint in ``ckpt``), resumed by
    two ranks on (1 x 2): the step matches, every restored tensor gathered
    whole is bit-equal to the checkpoint's, and the next step's loss is
    within 1e-5 relative of the four ranks' second step, the
    continuation (the same bf16 params and batch on another layout)."""
    t0 = time.perf_counter()
    outs = spawn_ranks(2, mesh_elastic_resume_rank, ckpt)
    wall = time.perf_counter() - t0
    two = dict(outs[0], unequal=[k for o in outs for k in o["unequal"]],
               leaves=sum(o["checked"] for o in outs))
    cont = four["losses"][1]
    err = _rel(two["loss"], cont)
    log(f"[mesh-elastic] {LLAMA} bf16 {MESH_LLAMA_LAYERS} layers saved at step {ELASTIC_STEP} on "
        f"(2 x 2) ({four['save_s']:.2f}s, rank 0 gathering and writing), resumed on "
        f"{two['mesh']} at step {two['step']} ({two['resume_s']:.2f}s, peak "
        f"{two['resume_peak_gb']:.2f} GB a rank; "
        f"wq {two['wq']}); {two['leaves'] - len(two['unequal'])} of {two['leaves']} tensors "
        f"bit-equal; next loss {two['loss']:.7f} vs the 4-rank continuation {cont:.7f} (rel "
        f"{err:.2e}, bound {ELASTIC_LOSS_TOL:.0e}), step {two['step_s']:.2f}s, peak "
        f"{two['peak_gb']:.2f} GB a rank; {wall:.1f}s")
    if (two["step"] != ELASTIC_STEP or two["unequal"] or not math.isfinite(two["loss"])
            or not err <= ELASTIC_LOSS_TOL):
        raise AssertionError(f"[mesh-elastic] resume failed: {two} vs {cont}")
    return {"loss_rel_err": err, "wall_s": wall, "resume_s": two["resume_s"],
            "save_s": four["save_s"]}


# ------------------------------------------------------ the Mamba trunk on a mesh
# [mesh-ssm]: zamba2-2.7b at full width on [mesh-train]'s four ranks (2 x 2):
# its 80 heads cut over "model" (40 a rank) as the reference's rules cut them
MESH_SSM_LAYERS = 12             # of zamba2's 54: two segments, two shared-block occurrences
MESH_SSM_FP32_LAYERS = 6         # one segment (a shared block every 6): the fp32 greedy parity
MESH_SSM_TRAIN_LAYERS = 6        # one segment: the train step (plain config)
MESH_SSM_ROWS, MESH_SSM_PROMPT, MESH_SSM_STEPS = 8, 256, 16
MESH_SSM_FP32_TOL = 1e-4         # fp32 logits vs one process, times the logit scale


def mesh_ssm_prompts(cfg, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    return torch.randint(1, cfg.vocab_size, (MESH_SSM_ROWS, MESH_SSM_PROMPT), device=dev,
                         generator=g, dtype=torch.int32)


def mesh_ssm_params(cfg, dev, mesh=None):
    """The seeded init on the card; on ``mesh``, distributed by the rules."""
    from repro_torch.convert import init_params
    from repro_torch.parallel.sharding import param_shardings

    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    if mesh is not None:
        params = param_shardings(cfg, mesh, params)
        free_card()
    return params


def mesh_ssm_serve(cfg, params, dev, *, mesh=None, feed=None) -> dict:
    """``MESH_SSM_ROWS`` prompts of ``MESH_SSM_PROMPT`` tokens prefilled,
    then ``MESH_SSM_STEPS`` greedy decode steps of ``cfg`` (a kernel
    config): on ``mesh``'s ranks (``params`` distributed by the rules,
    under the mesh's parallel context) or in this process.  ``feed``:
    decode these tokens (another run's greedy tokens) instead of this
    run's own.  Returns each forward's last-position logits (whole, fp32,
    on the host), the greedy tokens, each forward's launches and the head
    counts its SSD scans ran on, the decode steps' seconds, the last decode
    step's collectives, and (on a mesh) the Mamba weights a forward
    gathered (``_torch_mesh_ranks.weight_gathers``)."""
    from _torch_mesh_ranks import weight_gathers
    from repro_torch.parallel.collectives import log_collectives
    from repro_torch.parallel.sharding import distribute
    from repro_torch.parallel.vocab import greedy_tokens
    from repro_torch.train.tree import leaves_with_paths

    model = build_model(cfg)
    prompts = mesh_ssm_prompts(cfg, dev)
    b, s = prompts.shape
    if mesh is not None:
        put = lambda t: distribute(t, mesh, ("data", None))        # noqa: E731
        whole = lambda t: t.full_tensor()                           # noqa: E731
        argmax = lambda lg: greedy_tokens(lg).full_tensor()         # noqa: E731
        mamba = {"/".join(map(str, p)): w for p, w in leaves_with_paths(params["mamba_layers"])
                 if "mamba" in p}
        watch = lambda: weight_gathers(mamba)                       # noqa: E731
    else:
        put = whole = lambda t: t                                   # noqa: E731
        argmax = lambda lg: lg.argmax(-1).to(torch.int32)           # noqa: E731
        watch = lambda: contextlib.nullcontext([])                  # noqa: E731
    out = {"logits": [], "tokens": [], "launches": [], "heads": [], "step_s": [], "gathers": []}
    heads, inner = [], ssd.ssd_scan

    def scan(x, *args, **kwargs):
        heads.append(x.shape[2])
        return inner(x, *args, **kwargs)

    def run(fn):
        heads.clear()
        reset_counts()
        with watch() as seen:
            logits, caches = fn()
        torch.cuda.synchronize(dev)
        out["launches"].append(counts())
        out["heads"].append(sorted(set(heads)))
        out["gathers"] += seen
        return logits, caches

    ssd.ssd_scan = scan
    try:
        with torch.no_grad():
            logits, caches = run(lambda: model.prefill(params, {"tokens": put(prompts)},
                                                       s + MESH_SSM_STEPS))
            for t in range(MESH_SSM_STEPS):
                out["logits"].append(whole(logits).float().cpu())
                tok = argmax(logits)
                out["tokens"].append(tok.cpu().tolist())
                if feed is not None:
                    tok = torch.tensor(feed[t], dtype=torch.int32, device=dev)
                nxt = {"tokens": put(tok.reshape(b, 1))}
                pos = torch.tensor(s + t, dtype=torch.int32)
                torch.cuda.synchronize(dev)
                if mesh is not None:
                    torch.distributed.barrier()
                t0 = time.perf_counter()
                with log_collectives() as coll:
                    logits, caches = run(lambda: model.decode_step(params, nxt, caches, pos))
                out["step_s"].append(time.perf_counter() - t0)
            out["logits"].append(whole(logits).float().cpu())
    finally:
        ssd.ssd_scan = inner
    out["collectives"] = {k: {"calls": int(v[0]), "bytes": int(v[1]), "s": float(v[2])}
                          for k, v in coll.items()}
    return out


def mesh_ssm_rank(rank, world, dev) -> dict:
    """[mesh-ssm]'s ranks (run by [mesh-train]'s group): zamba2 served on
    (2 x 2) in fp32 at ``MESH_SSM_FP32_LAYERS`` layers and in bf16 at
    ``MESH_SSM_LAYERS`` (:func:`mesh_ssm_serve`), then one train step at
    ``MESH_SSM_TRAIN_LAYERS`` (:func:`_mesh_steps`).  Every rank returns
    its launches, heads and gathers; rank 0 also the logits and tokens."""
    from repro_torch.launch.dryrun import make_context
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel.context import parallel_context

    mesh = make_debug_mesh(world, device_type=dev.type)
    out = {}
    for key, cfg in (("fp32", full_cfg(ZAMBA, dtype="float32", n_layers=MESH_SSM_FP32_LAYERS)),
                     ("bf16", full_cfg(ZAMBA, n_layers=MESH_SSM_LAYERS))):
        t0 = time.perf_counter()
        params = mesh_ssm_params(cfg, dev, mesh)
        with parallel_context(make_context(mesh, cfg, MESH_SSM_ROWS)):
            run = mesh_ssm_serve(cfg, params, dev, mesh=mesh)
        run["w_x"] = str(params["mamba_layers"][0]["mamba"]["w_x"].placements)
        run["s"] = time.perf_counter() - t0
        if rank != 0:
            del run["logits"], run["tokens"]
        out[key] = run
        del params
        free_card()
    t0 = time.perf_counter()
    out["train"] = _mesh_steps(mesh_cfg(ZAMBA, n_layers=MESH_SSM_TRAIN_LAYERS), mesh, dev, 1)
    out["train"]["s"] = time.perf_counter() - t0
    return out


def phase_mesh_ssm(outs, dev) -> dict:
    """[mesh-ssm]: zamba2-2.7b at full width (d_model 2560, 80 heads of 64,
    N 64, a shared D 80 attention block every 6 layers) on four ranks
    sharing the card over gloo, (2 x 2): the Mamba trunk cut by heads over
    "model" as the reference's rules cut it (40 heads a rank), kernel
    config.  Held to this process on the card with the same kernels: fp32
    at one segment (``MESH_SSM_FP32_LAYERS``), 8 prompts of 256 tokens and
    16 greedy decode steps, identical tokens and every forward's
    last-position logits within ``MESH_SSM_FP32_TOL`` of the logit scale;
    bf16 at
    ``MESH_SSM_LAYERS``, the one-process run fed the sharded run's tokens,
    each forward's last-position logits within 0.1 of the logit scale with
    an argmax flip only at a bf16 tie (``bf16_tie_bound``).  Every forward
    on every rank: the SSD scan once a Mamba layer at S > 1, on 40 heads
    (80 in one process), never at S = 1; the RMSNorm kernel
    ``norms_per_forward(cfg, heads_cut=True)`` times, all on the rows
    kernel; flash once a shared-block occurrence; no Mamba weight gathered
    (:func:`~_torch_mesh_ranks.weight_gathers`).  A decode step's
    collectives by kind and its time.  One train step at
    ``MESH_SSM_TRAIN_LAYERS`` layers (bf16, the plain config): loss and
    grad norm within [mesh-train]'s bf16 bounds of one process.
    ``outs``: each rank's :func:`mesh_ssm_rank`."""
    tag = "[mesh-ssm]"
    t_start = time.perf_counter()
    r0 = outs[0]
    result = {"ranks_s": {k: r0[k]["s"] for k in ("fp32", "bf16", "train")}}
    for key, cfg in (("fp32", full_cfg(ZAMBA, dtype="float32", n_layers=MESH_SSM_FP32_LAYERS)),
                     ("bf16", full_cfg(ZAMBA, n_layers=MESH_SSM_LAYERS))):
        got = r0[key]
        params = mesh_ssm_params(cfg, dev)
        one = mesh_ssm_serve(cfg, params, dev, feed=None if key == "fp32" else got["tokens"])
        del params
        free_card()
        n_shared = cfg.n_layers // cfg.shared_attn_every
        norms = norms_per_forward(cfg, heads_cut=True)
        heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim // 2    # over 2 model ranks
        for r, o in enumerate(outs):
            per = o[key]
            for i, (c, h) in enumerate(zip(per["launches"], per["heads"])):
                scans = cfg.n_layers if i == 0 else 0
                if (c["ssd_scan"] != scans or h != ([heads] if scans else [])
                        or c["rmsnorm"] != norms or c["rmsnorm_rows"] != norms
                        or c["flash_attention"] != n_shared):
                    raise AssertionError(f"{tag} {key} rank {r} forward {i}: launches {c}, SSD "
                                         f"heads {h}; want {scans} scans on {heads} heads, {norms} "
                                         f"RMSNorms on the rows kernel, {n_shared} flash")
            if per["gathers"]:
                raise AssertionError(f"{tag} {key} rank {r}: Mamba weights gathered: "
                                     f"{per['gathers']}")
        c0, c1 = got["launches"][0], got["launches"][1]
        o0, o1 = one["launches"][0], one["launches"][1]
        log(f"{tag} {ZAMBA} {key} {cfg.n_layers} layers, w_x {got['w_x']}: a forward per rank "
            f"(ranks alike): prefill SSD scans {c0['ssd_scan']} on {got['heads'][0]} heads "
            f"({c0['ssd_scan_mma']} tensor-core, {c0['ssd_scan_core']} CUDA-core), RMSNorm "
            f"{c0['rmsnorm']}, flash {c0['flash_attention']}; decode step SSD {c1['ssd_scan']}, "
            f"RMSNorm {c1['rmsnorm']}, flash {c1['flash_attention']} (decode kernel "
            f"{c1['flash_attention_decode']}); one process: prefill SSD {o0['ssd_scan']} on "
            f"{one['heads'][0]} heads, RMSNorm {o0['rmsnorm']} a forward, flash "
            f"{o0['flash_attention']}; decode RMSNorm {o1['rmsnorm']}; no Mamba weight gathered "
            f"on any rank")
        coll = got["collectives"]
        med = float(np.median(got["step_s"]))
        log(f"{tag} {key}: a decode step's collectives, rank 0: {_collectives_line(coll)}; "
            f"decode step s median {med:.4f} (one process {float(np.median(one['step_s'])):.4f})")
        entry = {"launches_prefill": c0, "launches_decode": c1, "heads": got["heads"][0],
                 "single_launches_prefill": o0, "decode_step_s": med,
                 "single_decode_step_s": float(np.median(one["step_s"])),
                 "collectives": coll}
        if key == "fp32":
            same = got["tokens"] == one["tokens"]
            diff = max((g - w).abs().max().item() for g, w in zip(got["logits"], one["logits"]))
            scale = max(w.abs().max().item() for w in one["logits"])
            log(f"{tag} fp32: greedy tokens over {MESH_SSM_ROWS} rows x {MESH_SSM_STEPS} steps "
                f"identical to one process: {same}; logits of {len(got['logits'])} forwards: max "
                f"abs diff {diff:.3e} (logit scale {scale:.3f}, bound "
                f"{MESH_SSM_FP32_TOL * scale:.3e})")
            if not same:
                raise AssertionError(f"{tag} fp32 greedy tokens differ from one process")
            if not diff <= MESH_SSM_FP32_TOL * scale:
                raise AssertionError(f"{tag} fp32 logits differ from one process")
            entry.update(max_abs_diff=diff, logit_scale=scale)
        else:
            diffs, flips, scale = [], [], 0.0
            for t, (g, w) in enumerate(zip(got["logits"], one["logits"])):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"{tag} bf16 logits not finite at forward {t}")
                diffs.append((g - w).abs().max().item())
                scale = max(scale, w.abs().max().item())
                flips += [(t, row, gap) for row, gap in argmax_ties(g, w)]
            tie = bf16_tie_bound(scale)
            log(f"{tag} bf16: logits of {len(diffs)} forwards vs one process fed the same tokens: "
                f"max abs diff {max(diffs):.4f} (logit scale {scale:.3f}, bound "
                f"{0.1 * scale:.4f}); argmax flips (forward, row, gap) {flips}, a flip passes "
                f"only at a gap <= {tie:.6f}")
            if not (max(diffs) <= 0.1 * scale and all(gap <= tie for _, _, gap in flips)):
                raise AssertionError(f"{tag} bf16 logits differ from one process")
            entry.update(max_abs_diff=max(diffs), logit_scale=scale, flips=flips)
        result[key] = entry
    cfg = mesh_cfg(ZAMBA, n_layers=MESH_SSM_TRAIN_LAYERS)
    ref = _single_process(cfg, dev, 1)
    got = r0["train"]
    err = _rel(got["losses"][0], ref["losses"][0])
    norm_err = _rel(got["grad_norms"][0], ref["grad_norms"][0])
    log(f"{tag} train {cfg.n_layers} layers bf16: loss {got['losses'][0]:.5f} vs one process "
        f"{ref['losses'][0]:.5f} (rel {err:.2e}, bound {MESH_BF16_LOSS_TOL:.0e}); grad norm "
        f"{got['grad_norms'][0]:.5f} vs {ref['grad_norms'][0]:.5f} (rel {norm_err:.2e}, bound "
        f"{MESH_BF16_NORM_TOL:.0e}); step {got['step_s'][0]:.3f}s, peak "
        f"{got['peak_bytes'] / 1e9:.2f} GB a rank; collectives of the step, rank 0: "
        f"{_collectives_line(got['collectives'])}")
    if not (math.isfinite(got["losses"][0]) and err <= MESH_BF16_LOSS_TOL
            and norm_err <= MESH_BF16_NORM_TOL):
        raise AssertionError(f"{tag} train step differs from one process")
    result["train"] = {"loss_rel_err": err, "grad_norm_rel_err": norm_err,
                       "step_s": got["step_s"][0], "collectives": got["collectives"]}
    result["parent_s"] = time.perf_counter() - t_start
    log(f"{tag} ranks {sum(result['ranks_s'].values()):.1f}s (fp32 "
        f"{result['ranks_s']['fp32']:.1f}, bf16 {result['ranks_s']['bf16']:.1f}, train "
        f"{result['ranks_s']['train']:.1f}), this process {result['parent_s']:.1f}s")
    return result


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
    mask = fa.visible_mask(inp["q_offsets"], inp["q_lens"], sq, sk,
                           causal=extra.get("causal", True), window=extra.get("window"))
    n_vis = mask.sum().item()                       # (row, query, key) triples
    keys_read = mask.any(dim=1).sum().item()        # (row, key) pairs read
    es = q.element_size()
    byts = 2 * q.numel() * es + 2 * keys_read * kv * d * es + 2 * b * 4
    flops = 4 * d * h * n_vis
    return byts, flops


def rms_work(x, w) -> tuple:
    """Bytes and flops of one RMSNorm: x read and the output written once,
    w read once; four flops an element of x."""
    return 2 * x.numel() * x.element_size() + w.numel() * w.element_size(), 4 * x.numel()


@contextlib.contextmanager
def kernel_work():
    """The (kernel, bytes, flops) of each flash attention and RMSNorm
    launch the models make while a dispatch mode is on (a step under the
    dry-run's counter, which cannot see into a kernel), by
    :func:`flash_work` and :func:`rms_work` on the launch's inputs; the
    sums run with the mode off, unseen by the counter."""
    from torch.utils._python_dispatch import _disable_current_modes

    work = []
    flash0, rms0 = fa.flash_attention, rn.rmsnorm

    def counting():
        return torch._C._len_torch_dispatch_stack() > 0

    def flash(q, k, v, q_offsets, q_lens=None, **kw):
        if counting():
            with _disable_current_modes():
                lens = q_lens if q_lens is not None else torch.full_like(q_offsets, q.shape[1])
                inp = {"q": q, "k": k, "q_offsets": q_offsets, "q_lens": lens}
                work.append(("flash_attention", *flash_work(inp, kw)))
        return flash0(q, k, v, q_offsets, q_lens, **kw)

    def rms(x, w, eps=1e-6):
        if counting():
            work.append(("rmsnorm", *rms_work(x, w)))
        return rms0(x, w, eps)

    fa.flash_attention, rn.rmsnorm = flash, rms
    try:
        yield work
    finally:
        fa.flash_attention, rn.rmsnorm = flash0, rms0


def bound(byts, flops, dtype):
    t_b, t_f = byts / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def sdpa_call(inp, extra):
    """One library call for the same function (yardstick only): with the
    visible-key mask, or, for a non-causal call whose every row is valid
    (nothing to mask), none, so that every backend may take it."""
    q, k, v = (t.transpose(1, 2) for t in (inp["q"], inp["k"], inp["v"]))
    b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
    causal = extra.get("causal", True)
    mask = None
    if causal or extra.get("window") is not None or not bool((inp["q_lens"] == sq).all()):
        mask = fa.visible_mask(inp["q_offsets"], inp["q_lens"], sq, sk, causal=causal,
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


def time_verify(dev, flush, rows, dtype) -> None:
    """A speculative round's verify rows at llama's heads (D 64, GQA 4): 8
    rows at random decode depths, [8, 4] (k = 3: the decode kernel) and
    [8, 5] (k = 4: the chunk tile) at the same depths, dense and paged
    (P 64), L2 flushed, beside the bytes bound and the fastest SDPA backend
    (paged: the dense kernel at the same depths and the gather + SDPA
    yardstick)."""
    hk = HEADS[LLAMA]
    # one set of depths for both widths, so the two routes read the same keys
    depths = np.random.default_rng(SEED + 8).integers(0, 2048 - max(SPEC_K), size=8).tolist()
    for k in SPEC_K:
        sq = k + 1
        inp = flash_inputs(dev, dtype, sq=sq, depths=depths, q_lens=[sq] * 8, **hk)
        b_ms, b_by = bound(*flash_work(inp, {}), dtype)
        lib_ms, lib, sweep = time_sdpa(dev, inp, {}, iters=20, flush=flush)
        rows[("flash_attention", f"verify_k{k}")] = dict(
            ms=time_ms(dev, lambda: run_flash(fa.flash_attention, inp, {}), flush=flush),
            plain_ms=time_ms(dev, lambda: run_flash(fa.flash_attention_plain, inp, {}), iters=10,
                             flush=flush),
            library_ms=lib_ms, library=f"SDPA ({lib})" if lib else None, sdpa_sweep=sweep,
            bound_ms=b_ms, bound_by=b_by, depths=depths,
        )
        pin = paged_inputs(dev, dtype, P=64, depths=depths, q_lens=[sq] * 8, sq=sq, shared=0, **hk)
        dense_inp = gathered(pin)
        byts, flops = flash_work(dense_inp, {})
        k_end = pin["q_offsets"] + pin["q_lens"]
        byts += int(((k_end + 63) // 64).sum().item()) * 4
        pb_ms, pb_by = bound(byts, flops, dtype)
        gather = lambda: (fa.paged_view(pin["pool_k"], pin["table"]),  # noqa: E731
                          fa.paged_view(pin["pool_v"], pin["table"]))
        r = rows[("flash_attention_paged", f"verify_k{k}")] = dict(
            ms=time_ms(dev, lambda: run_paged(fa.flash_attention_paged, pin, {}), flush=flush),
            plain_ms=time_ms(dev, lambda: run_paged(fa.flash_attention_paged_plain, pin, {}),
                             iters=10, flush=flush),
            dense_ms=time_ms(dev, lambda: run_flash(fa.flash_attention, dense_inp, {}),
                             flush=flush),
            gather_ms=time_ms(dev, gather, iters=20, flush=flush),
            library_ms=None, bound_ms=pb_ms, bound_by=pb_by,
        )
        r["sdpa_ms"], plib, _ = time_sdpa(dev, dense_inp, {}, iters=20, flush=flush)
        sd = "n/a" if r["sdpa_ms"] is None else f"{r['sdpa_ms']:.4f} ms ({plib})"
        log(f"[time] flash_attention_paged verify_k{k} [8, {sq}] P=64 bf16 at depths {depths}: "
            f"kernel {r['ms']:.4f} ms, dense kernel at the same depths {r['dense_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, yardstick gather {r['gather_ms']:.4f} ms + SDPA {sd}, "
            f"bound {pb_ms:.5f} ms ({pb_by}), kernel/bound {r['ms'] / pb_ms:.1f}x")


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
                op_host_us=host_us(dev, lambda: torch.ops.repro_torch.grouped_gemm(
                    inp["x"], inp["w"], inp["group_sizes"], True)),
                library_host_us=host_us(dev, lib),
            )
            log(f"[time] grouped_gemm {proj} {routing} bf16 x {tuple(inp['x'].shape)} w "
                f"{tuple(inp['w'].shape)}, {int((inp['group_sizes'] > 0).sum())} experts with "
                f"rows, {splits} K split(s): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
                f"ms, {label} {r['library_ms']:.4f} ms (max abs diff to plain {lib_err:.3e}), "
                f"bound {b_ms:.5f} ms ({b_by}: {byts / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
                f"kernel/bound {r['ms'] / b_ms:.2f}x; host time a call: kernel "
                f"{r['host_us']:.1f} us (through the custom op {r['op_host_us']:.1f} us), "
                f"{label} {r['library_host_us']:.1f} us")
            del inp, ref, lib_out


def time_encdec_vlm(dev, flush, rows, dtype) -> None:
    """This slice's new flash instances, L2 flushed before each call,
    beside the bound and the fastest SDPA backend: seamless's non-causal
    calls (D 64, 16 / 16) — the encoder's [1, 512] over 512 keys, the
    cross-attention's decode rows [8, 1] and a chunk [8, 64] over 512
    encoder keys — and qwen2-vl's GQA 28 / 4 (D 128, causal) at [8, 1] and
    [8, 64] at random depths, dense; paged (P 64) through ``time_paged``."""
    rng = np.random.default_rng(SEED + 13)
    hk, hv = HEADS[SEAMLESS], HEADS[VLM]
    cases = {
        "noncausal_encoder_512": (
            flash_inputs(dev, dtype, sq=512, depths=[0], q_lens=[512], sk=512, **hk),
            {"causal": False}),
        "noncausal_cross_decode_512": (
            flash_inputs(dev, dtype, sq=1, depths=rng.integers(8, 128, size=8).tolist(),
                         q_lens=[1] * 8, sk=512, **hk), {"causal": False}),
        "noncausal_cross_chunk_512": (
            flash_inputs(dev, dtype, sq=64, depths=[0] * 8, q_lens=[64] * 8, sk=512, **hk),
            {"causal": False}),
        "d128g7_decode": (
            flash_inputs(dev, dtype, sq=1, depths=rng.integers(0, 2048, size=8).tolist(),
                         q_lens=[1] * 8, **hv), {}),
        "d128g7_chunk": (
            flash_inputs(dev, dtype, sq=64, depths=rng.integers(0, 2048 - 64, size=8).tolist(),
                         q_lens=[64] * 8, **hv), {}),
    }
    for case, (inp, extra) in cases.items():
        b_ms, b_by = bound(*flash_work(inp, extra), dtype)
        lib_ms, lib, sweep = time_sdpa(dev, inp, extra, iters=20, flush=flush)
        rows[("flash_attention", case)] = dict(
            ms=time_ms(dev, lambda: run_flash(fa.flash_attention, inp, extra), flush=flush),
            plain_ms=time_ms(dev, lambda: run_flash(fa.flash_attention_plain, inp, extra),
                             iters=10, flush=flush),
            library_ms=lib_ms, library=f"SDPA ({lib})" if lib else None, sdpa_sweep=sweep,
            bound_ms=b_ms, bound_by=b_by, shape=[list(inp["q"].shape), inp["k"].shape[1]],
        )
    time_paged(dev, flush, rows, VLM, "d128g7_", dtype)


# ---------------------------------------------------------------------------
# the launch tools: the dry-run sweep, its finite difference, and the card
# ---------------------------------------------------------------------------

# the sweep: every arch at decode_32k, long_500k and train_4k, and
# arctic-480b's prefill_32k (the other prefill cells and the (2 x 16 x 16)
# mesh are left to the CLI).  Fake tensors need no card, only CPU: its
# queues start with the script, at the lowest priority, and run beside the
# build, the trainer, the sharded trainer, the kernel checks and the parity
# runs; then they are stopped (SIGSTOP) until [dryrun], so that no
# host-timed phase (serving tok/s, the ratios, [time]'s host times,
# [dryrun-card]'s steps) shares the host with them.  Each queue runs its
# CLI calls one after another; the train cells, the long ones, are spread
# over the queues.
_DRY = ["repro_torch.launch.dryrun"]
_FD = ["repro_torch.launch.roofline_fd", "--check"]
DRYRUN_JOBS = {
    "serve": [_DRY + ["--arch", "all", "--shape", "decode_32k,long_500k"],
              _DRY + ["--arch", "arctic-480b", "--shape", "prefill_32k"],
              _FD + ["--arch", "llama3.2-1b", "--shape", "decode_32k"],
              _DRY + ["--arch", "mamba2-130m", "--shape", "train_4k"]],
    "train-a": [_DRY + ["--arch", "arctic-480b,llama3.2-1b,qwen2-moe-a2.7b",
                        "--shape", "train_4k"],
                _FD + ["--arch", "qwen2-moe-a2.7b", "--shape", "train_4k"]],
    "train-b": [_DRY + ["--arch", "zamba2-2.7b,gemma2-27b", "--shape", "train_4k"]],
    "train-c": [_DRY + ["--arch", "qwen3-14b,seamless-m4t-large-v2,gemma-7b,qwen2-vl-7b",
                        "--shape", "train_4k"]],
}
# a queue: its calls in turn, niced, stopping at the first that fails
_QUEUE = """
import json, os, subprocess, sys
os.nice(19)
for argv in json.loads(sys.argv[1]):
    subprocess.run([sys.executable, "-m", *argv], check=True)
"""
# [dryrun-card]: llama3.2-1b at full width on one card, seq_len kept, the
# batch cut from SHAPES (decode_32k: 16 rows of 32k tokens, ~17 GB of KV)
# and, for the script's time limit, the depth of the two long steps (at 16
# layers the prefill step took 13.7 s, the train step 3.8 s, each run 7
# times): (shape, global batch, layers)
CARD_CELLS = (("decode_32k", 16, 16), ("prefill_32k", 1, 4), ("train_4k", 4, 4))
DRYRUN_DEVICE = "cuda"           # the fake tensors' device
CARD_PEAK_TOL = 0.15
CARD_ITERS = 5


def start_dryrun(out: Path) -> dict:
    """Every queue of ``DRYRUN_JOBS`` as a process of its own, in a session
    of its own (its CLI calls in its process group), its JSONs under
    ``out/<queue>`` and its output in ``out/<queue>.log``."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    jobs = {}
    for name, calls in DRYRUN_JOBS.items():
        (out / name).mkdir(parents=True, exist_ok=True)
        argvs = [argv + ["--device", DRYRUN_DEVICE, "--out", str(out / name)] for argv in calls]
        with open(out / f"{name}.log", "w") as f:
            jobs[name] = subprocess.Popen([sys.executable, "-c", _QUEUE, json.dumps(argvs)],
                                          cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                                          start_new_session=True)
    log(f"[dryrun] {len(jobs)} queues started: {', '.join(jobs)}")
    return jobs


def signal_dryrun(jobs: dict, sig) -> list:
    """Send ``sig`` to the process group of every queue still running:
    the names of those queues."""
    live = [name for name, p in jobs.items() if p.poll() is None]
    for name in live:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(jobs[name].pid, sig)
    return live


def pause_dryrun(jobs: dict) -> None:
    live = signal_dryrun(jobs, signal.SIGSTOP)
    log(f"[dryrun] {len(live)} queue(s) still running ({', '.join(live) or 'none'}): stopped "
        f"until [dryrun]")


def stop_dryrun(jobs: dict) -> None:
    """Kill every queue and the CLI calls it started (its process group)."""
    signal_dryrun(jobs, signal.SIGKILL)
    for p in jobs.values():
        p.wait()


def phase_dryrun(jobs: dict, out: Path) -> dict:
    """``[dryrun]`` and ``[roofline-fd]``: wait for the jobs, then a line
    per cell.  Fails on a job that failed, a cell in error, or a finite
    difference that does not rebuild its direct count."""
    t0 = time.perf_counter()
    signal_dryrun(jobs, signal.SIGCONT)
    for name, p in jobs.items():
        if p.wait() != 0:
            tail = (out / f"{name}.log").read_text()[-3000:]
            raise AssertionError(f"[dryrun] job {name} exited {p.returncode}:\n{tail}")
    log(f"[dryrun] jobs joined after {time.perf_counter() - t0:.1f}s of waiting")
    cells = {}
    for fp in sorted(out.glob("*/*.json")):
        cells[(fp.parent.name, fp.stem)] = json.loads(fp.read_text())
    sweep = {k: r for k, r in cells.items() if "per_layer_unit" not in r}
    errors = [k for k, r in sweep.items() if r["status"] == "error"]
    if errors:
        raise AssertionError(f"[dryrun] cells in error: {errors}")
    shown = sorted(sweep.values(), key=lambda r: (r["multi_pod"], r["arch"], r["shape"]))
    for r in shown:
        pod = "2pod" if r["multi_pod"] else "1pod"
        if r["status"] == "skipped":
            log(f"[dryrun] {r['arch']} {r['shape']} {pod}: skipped ({r['reason']})")
            continue
        log(f"[dryrun] {r['arch']} {r['shape']} {pod}: dominant={r['dominant']} "
            f"t_compute/t_memory/t_collective={r['t_compute_s']:.4g}/{r['t_memory_s']:.4g}/"
            f"{r['t_collective_s']:.4g} s fit_estimate_gb={r['fit_estimate_gb']} "
            f"fits_80gb={r['fits_80gb']} accum={r['accum_steps']} flops/dev="
            f"{r['flops_per_device']:.4g} bytes/dev={r['bytes_per_device']:.4g} "
            f"coll/dev={r['collective_bytes_per_device']:.4g} ({r['elapsed_s']}s)")
    ok = [r for r in shown if r["status"] == "ok"]
    want = {(a, s) for a in ARCHS for s in ("decode_32k", "train_4k")}
    want.add(("arctic-480b", "prefill_32k"))
    got = {(r["arch"], r["shape"]) for r in ok if not r["multi_pod"]}
    if not want <= got:
        raise AssertionError(f"[dryrun] single-pod cells missing: {sorted(want - got)}")
    if len(shown) != len(want) + len(ARCHS):      # long_500k: ok or skipped, each arch
        raise AssertionError(f"[dryrun] {len(shown)} cells, {len(want) + len(ARCHS)} expected")
    arctic = next(r for r in ok if (r["arch"], r["shape"], r["multi_pod"])
                  == ("arctic-480b", "train_4k", False))
    log(f"[dryrun] arctic-480b x train_4k (item 6's proxy: one rank of 256, (16 x 16)): "
        f"{arctic['params']:.4g} params, quant8 moments={arctic['quant8_opt']}, accum "
        f"{arctic['accum_steps']}, arguments {arctic['memory']['argument_size_in_bytes'] / 1e9:.2f}"
        f" GB a rank, fit_estimate_gb={arctic['fit_estimate_gb']}, fits_80gb="
        f"{arctic['fits_80gb']}, step_time_lb_s={arctic['step_time_lb_s']:.4g} "
        f"({arctic['dominant']})")
    log(f"[dryrun] {len(ok)} cells ok, {len(shown) - len(ok)} skipped, 0 in error")
    fd = {k: r for k, r in cells.items() if "per_layer_unit" in r}
    for (_, tag), r in sorted(fd.items()):
        if r["status"] != "ok" or not r.get("reconstruction_equal"):
            raise AssertionError(f"[roofline-fd] {tag}: {r}")
        log(f"[roofline-fd] {r['arch']} {r['shape']}: per layer unit flops="
            f"{r['per_layer_unit']['flops']:.6g} bytes={r['per_layer_unit']['bytes']:.6g} "
            f"coll={r['per_layer_unit']['coll']:.6g}; rebuilt = direct (flops "
            f"{r['direct']['flops']:.6g}, bytes {r['direct']['bytes']:.6g}, coll "
            f"{r['direct']['coll']:.6g})")
    if len(fd) != 2:
        raise AssertionError(f"[roofline-fd] {len(fd)} cells, 2 expected")
    return {"cells": len(ok), "arctic": arctic}


def phase_dryrun_card(dev) -> dict:
    """``[dryrun-card]``: the dry-run's prediction held to the card.  Each
    cell of ``CARD_CELLS`` runs through ``run_cell`` twice on a one-rank
    mesh: on fake tensors, then on real ones (seeded init) with the step
    timed.  The counts must be identical, the predicted peak within
    ``CARD_PEAK_TOL`` of ``max_memory_allocated``, and the median of
    ``CARD_ITERS`` synchronized steps at or above ``step_time_lb_s``.  The
    serving cells run once more, real only, at ``attention_impl="pallas"``:
    the flash (B1) and RMSNorm (B3) kernels carry the step (a fake tensor
    cannot enter them), held to its own bound: the counter's count of the
    rest of the step plus each launch's work by :func:`kernel_work`."""
    from repro_torch.configs.base import SHAPES as T_SHAPES
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.roofline import roofline_terms

    base = get_config(LLAMA)
    out = {}
    for name, batch, layers in CARD_CELLS:
        shape = dataclasses.replace(T_SHAPES[name], global_batch=batch)
        cfg = dataclasses.replace(base, n_layers=layers)
        free_card()
        fake = run_cell(LLAMA, name, device=dev.type, fake=True, mesh_shape=(1, 1), cfg=cfg,
                        shape=shape, verbose=False)
        free_card()
        real = run_cell(LLAMA, name, device=dev.type, fake=False, mesh_shape=(1, 1), cfg=cfg,
                        shape=shape, verbose=False, time_iters=CARD_ITERS)
        for key in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device"):
            if fake[key] != real[key]:
                raise AssertionError(f"[dryrun-card] {name}: {key} fake {fake[key]} real {real[key]}")
        pred = fake["memory"]["argument_size_in_bytes"] + fake["memory"]["temp_size_in_bytes"]
        peak = real["device_peak_bytes"]
        lb, ms = real["step_time_lb_s"], real["measured_step_s"]
        log(f"[dryrun-card] {LLAMA} {name} batch {batch}, {layers} layers: flops "
            f"{real['flops_per_device']:.6g} bytes {real['bytes_per_device']:.6g} collective "
            f"bytes {real['collective_bytes_per_device']:.6g} (fake = real); predicted peak "
            f"{pred / 1e9:.3f} GB, card {peak / 1e9:.3f} GB ({(pred - peak) / peak:+.2%}); "
            f"lb {lb * 1e3:.3f} ms ({real['dominant']}), measured {ms * 1e3:.3f} ms, "
            f"lb / measured {lb / ms:.4f}")
        if abs(pred - peak) > CARD_PEAK_TOL * peak:
            raise AssertionError(f"[dryrun-card] {name}: predicted peak {pred} vs {peak}")
        if ms < lb:
            raise AssertionError(f"[dryrun-card] {name}: measured {ms} s under the bound {lb} s")
        out[name] = {"layers": layers, "lb_s": lb, "measured_s": ms, "pred_bytes": pred,
                     "peak_bytes": peak, "dominant": real["dominant"]}
        if shape.kind == "train":
            log(f"[dryrun-card] {LLAMA} {name}: no pallas run (the kernels are forward-only)")
            continue
        free_card()
        reset_counts()
        kcfg = dataclasses.replace(cfg, attention_impl="pallas")
        with kernel_work() as work:
            kern = run_cell(LLAMA, name, device=dev.type, fake=False, mesh_shape=(1, 1),
                            cfg=kcfg, shape=shape, verbose=False, time_iters=CARD_ITERS)
        got = counts()
        require(got, ("rmsnorm", "flash_attention"), f"[dryrun-card] {name} pallas")
        # the counted step's launches, once each; the timed steps launch as many
        for k in ("flash_attention", "rmsnorm"):
            seen = sum(1 for w in work if w[0] == k)
            if seen * (1 + CARD_ITERS) != got[k]:
                raise AssertionError(f"[dryrun-card] {name} pallas: {seen} {k} launches "
                                     f"counted of {got[k]} in {1 + CARD_ITERS} steps")
        kbytes, kflops = sum(w[1] for w in work), sum(w[2] for w in work)
        step = dict(kern, flops_per_device=kern["flops_per_device"] + kflops,
                    bytes_per_device=kern["bytes_per_device"] + kbytes)
        terms = roofline_terms(step, kcfg, shape)
        km, klb = kern["measured_step_s"], terms["step_time_lb_s"]
        log(f"[dryrun-card] {LLAMA} {name} batch {batch}, {layers} layers pallas: flops "
            f"{step['flops_per_device']:.6g} bytes {step['bytes_per_device']:.6g} (of which the "
            f"kernels' launches {kflops:.6g} / {kbytes:.6g}); lb {klb * 1e3:.3f} ms "
            f"({terms['dominant']}), measured {km * 1e3:.3f} ms, lb / measured {klb / km:.4f}; "
            f"the plain step's lb / this step {lb / km:.4f} (launches a step: flash "
            f"{got['flash_attention'] // (1 + CARD_ITERS)}, rmsnorm "
            f"{got['rmsnorm'] // (1 + CARD_ITERS)})")
        if km < klb:
            raise AssertionError(f"[dryrun-card] {name} pallas: measured {km} s under {klb} s")
        out[name].update(pallas_s=km, pallas_lb_s=klb)
    free_card()
    return out



# ------------------------------------------------------------ the examples
# repro_torch.examples, as a user runs them (``python -m``): each module's
# main() in a child process of its own, in a session of its own, its output
# in ``<out>/<name>.log`` and, last, one ``[example-result]`` JSON line.
# The two planning examples need no kernel and spend ~150 s of host time in
# the MILP: like the dry-run's queues they start with the script, niced,
# are stopped before the first host-timed phase and collected at the end;
# their MILP runs to a wall-clock limit on a shared host, so moirai's
# figures are printed, not held.  [example-train] launches no kernel
# either: it runs beside [train], in the kernels' build window
_EXAMPLE = """
import importlib, json, os, sys, time
if sys.argv[3] == "nice":
    os.nice(19)
import torch
name, argv = sys.argv[1], json.loads(sys.argv[2])
t0 = time.perf_counter()
out = importlib.import_module(name).main(argv)
res = {"run_s": time.perf_counter() - t0, "cuda": torch.cuda.is_initialized()}
res["peak_bytes"] = torch.cuda.max_memory_allocated() if res["cuda"] else 0
if name.endswith(".quickstart"):
    res.update(graph=[len(out["graph"]), out["graph"].num_edges()], coarse=len(out["coarse"]),
               results={m: {"ms": mk * 1e3, "via": r.method, "status": r.status,
                            "gen_s": r.solve_time} for m, (r, mk) in out["results"].items()})
elif name.endswith(".heterogeneous_placement"):
    res["rows"] = [[c, g, {m: {"ms": mk * 1e3, "via": r.method, "gen_s": r.solve_time}
                           for m, (r, mk) in row.items()}] for (c, g), row in out.items()]
else:
    from repro_torch.train.tree import leaves
    res.update({k: out[k] for k in ("first_loss", "final_loss", "steps_run", "wall_s", "losses",
                                    "step_s")})
    res["params"] = sum(t.numel() for t in leaves(out["params"]))
print("[example-result] " + json.dumps(res), flush=True)
"""
_EX = "repro_torch.examples."
PLANNING_EXAMPLES = {"example-quickstart": (_EX + "quickstart", []),
                     "example-placement": (_EX + "heterogeneous_placement", [])}
# the reference docstring's "≈100M params" run (fp32, the smoke config's
# dtype, at the demo's widths)
EXAMPLE_TRAIN = ["--steps", "300", "--d-model", "512", "--layers", "12"]
# the heuristics' makespans (ms) as the CPU prints them: the reference's
# examples/quickstart.py and examples/heterogeneous_placement.py, which
# tests/test_torch_examples.py holds the port to exactly
QUICKSTART_MS = {"msct": "818.006", "getf": "570.399", "round_robin": "2773.116"}
PLACEMENT_MS = {
    ("inter-server", "gpt3-330m"): ("355.06", "267.43"),
    ("inter-server", "swin-1.8b"): ("2084.34", "1646.79"),
    ("inter-server", "af2-87m"): ("6.91", "6.86"),
    ("intra-server", "gpt3-330m"): ("164.95", "164.91"),
    ("intra-server", "swin-1.8b"): ("2080.36", "1361.49"),
    ("intra-server", "af2-87m"): ("3.52", "4.30"),
}


def start_example(name, module, argv, out: Path, *, nice: bool) -> subprocess.Popen:
    """``module``'s main(argv) in a child process (see ``_EXAMPLE``)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    with open(out / f"{name}.log", "w") as f:
        p = subprocess.Popen([sys.executable, "-c", _EXAMPLE, module, json.dumps(argv),
                              "nice" if nice else "-"], cwd=ROOT, env=env, stdout=f,
                             stderr=subprocess.STDOUT, start_new_session=True)
    log(f"[{name}] started: python -m {module} {' '.join(argv)}".rstrip())
    return p


def example_result(name, p: subprocess.Popen, out: Path) -> dict:
    """Wait for the example, fail unless it exited 0, echo what it printed
    and return its ``[example-result]``."""
    t0 = time.perf_counter()
    rc = p.wait()
    text = (out / f"{name}.log").read_text()
    if rc != 0:
        raise AssertionError(f"[{name}] exited {rc}:\n{text[-3000:]}")
    lines = text.splitlines()
    res = json.loads(next(x for x in reversed(lines) if x.startswith("[example-result] "))
                     .split(" ", 1)[1])
    for line in lines:
        if line.strip() and not line.startswith("[example-result] "):
            log(f"[{name}] | {line}")
    log(f"[{name}] exit 0 after {res['run_s']:.1f}s in main() ({time.perf_counter() - t0:.1f}s "
        "of waiting)")
    return res


def phase_example_quickstart(p, out: Path) -> dict:
    """[example-quickstart]: the graph and GCOF counts, and msct, getf and
    round_robin at the CPU's figures; no card touched (host code only)."""
    res = example_result("example-quickstart", p, out)
    if (res["graph"], res["coarse"]) != ([307, 386], 258):
        raise AssertionError(f"[example-quickstart] graph {res['graph']}, {res['coarse']} after "
                             "GCOF; the reference's is 307 operators, 386 flows, 258")
    got = {m: f"{r['ms']:.3f}" for m, r in res["results"].items()}
    if any(got[m] != want for m, want in QUICKSTART_MS.items()):
        raise AssertionError(f"[example-quickstart] heuristic makespans {got}, the CPU's "
                             f"{QUICKSTART_MS}")
    if res["cuda"]:
        raise AssertionError("[example-quickstart] touched the card")
    mo = res["results"]["moirai"]
    best = min(res["results"][m]["ms"] for m in ("msct", "getf"))
    log(f"[example-quickstart] msct/getf/round_robin {got['msct']}/{got['getf']}/"
        f"{got['round_robin']} ms = the CPU's; moirai {mo['ms']:.3f} ms via {mo['via']} "
        f"({mo['status']}, gen {mo['gen_s']:.2f}s), <= min(msct, getf) {mo['ms'] <= best}")
    return res


def phase_example_placement(p, out: Path) -> dict:
    """[example-placement]: six rows (two clusters x three paper graphs),
    every makespan finite, msct and getf at the CPU's figures, placeto's
    policy on the card."""
    res = example_result("example-placement", p, out)
    rows = {(c, g): row for c, g, row in res["rows"]}
    if sorted(rows) != sorted(PLACEMENT_MS):
        raise AssertionError(f"[example-placement] rows {sorted(rows)}")
    for key, row in rows.items():
        if not all(math.isfinite(r["ms"]) for r in row.values()):
            raise AssertionError(f"[example-placement] {key}: a makespan is not finite: {row}")
        got = (f"{row['msct']['ms']:.2f}", f"{row['getf']['ms']:.2f}")
        if got != PLACEMENT_MS[key]:
            raise AssertionError(f"[example-placement] {key}: msct, getf {got}, the CPU's "
                                 f"{PLACEMENT_MS[key]}")
        best = min(row["msct"]["ms"], row["getf"]["ms"])
        log(f"[example-placement] {key[0]} {key[1]}: msct, getf {got[0]}, {got[1]} ms = the "
            f"CPU's; placeto {row['placeto']['ms']:.2f} ms (gen {row['placeto']['gen_s']:.2f}s); "
            f"moirai {row['moirai']['ms']:.2f} ms via {row['moirai']['via']} (gen "
            f"{row['moirai']['gen_s']:.2f}s), <= min(msct, getf) {row['moirai']['ms'] <= best}")
    if not (res["cuda"] and res["peak_bytes"] > 0):
        raise AssertionError("[example-placement] placeto's policy never reached the card")
    log(f"[example-placement] placeto's policy on the card: peak {res['peak_bytes']} bytes")
    return res


def phase_example_train(p, out: Path) -> dict:
    """[example-train]: the train demo at the "≈100M params" size on the
    card; every loss finite, the last below the first."""
    res = example_result("example-train", p, out)
    losses = res["losses"]
    if res["steps_run"] != 300 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[example-train] {res['steps_run']} steps, losses {losses}")
    if not res["final_loss"] < res["first_loss"]:
        raise AssertionError(f"[example-train] loss {res['first_loss']} -> {res['final_loss']}")
    toks = 8 * 128
    med = float(np.median(res["step_s"][1:]))
    log(f"[example-train] {res['params']} parameters; loss {res['first_loss']:.4f} -> "
        f"{res['final_loss']:.4f} over {res['steps_run']} steps; train() wall {res['wall_s']:.1f}s = "
        f"{res['steps_run'] * toks / res['wall_s']:.1f} tokens/s, step s median {med:.4f} "
        f"({toks / med:.1f} tokens/s), peak {res['peak_bytes'] / 1e9:.2f} GB on the card")
    return res


def demo_served(reqs, what) -> list:
    if not all(r.done and len(r.out_tokens) == 8 for r in reqs):
        raise AssertionError(f"{what}: a request was not served: "
                             f"{[(r.rid, r.out_tokens) for r in reqs]}")
    return [r.out_tokens for r in reqs]


def phase_example_serve(dev) -> dict:
    """[example-serve]: ``serve_demo.main()`` at its defaults (smoke llama,
    fp32, one modeled H100), every forward on the flash and RMSNorm
    kernels; the same demo under ``plain_kernels()`` gives identical
    tokens; ``demo()`` on ``h100_cluster(2, heterogeneous=True)`` mapped
    onto the card, where request 99 after device 0 fails gets a fresh
    engine's tokens; then ``demo()`` at full width (16 layers, bf16)."""
    from repro_torch.examples import serve_demo

    cfg = serve.serving_config(LLAMA, smoke=True)
    reset_counts()
    with EngineForwards() as fl:
        out = serve_demo.main([])
    torch.cuda.synchronize(dev)
    main_counts = counts()
    check_forwards(fl.of(), cfg, "[example-serve] main()")
    require(main_counts, DENSE_PATH, "[example-serve] main()")
    want = demo_served(out["requests"], "[example-serve] main()")
    log(f"[example-serve] main(): {len(fl.steps)} forwards, each on the kernels; launches "
        f"{main_counts}")
    del out
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    with plain_kernels():
        reqs = serve_demo.demo_requests()
        serve_demo.demo(cfg, params, h100_cluster(1, heterogeneous=True), [dev], reqs)
    if demo_served(reqs, "[example-serve] plain") != want:
        raise AssertionError("[example-serve] fp32 tokens differ between the kernels and the "
                             "plain versions")
    log("[example-serve] fp32 tokens of the 8 requests identical, kernels vs plain_kernels()")

    reset_counts()
    with EngineForwards() as fl:
        reqs = serve_demo.demo_requests()
        res = serve_demo.demo(cfg, params, h100_cluster(2, heterogeneous=True), [dev], reqs)
    check_forwards(fl.of(), cfg, "[example-serve] two modeled devices")
    r99 = res["after_failure"]
    fresh = ServingEngine(cfg, params, h100_cluster(1, heterogeneous=True), devices=[dev],
                          slots=4, max_len=128, eos_id=-1)
    alone = Request(rid=99, prompt=list(r99.prompt), max_new_tokens=8)
    fresh.submit(alone)
    fresh.run_until_drained()
    if demo_served(reqs, "[example-serve] h100-x2") != want or res["engine"].failed_devices != [0]:
        raise AssertionError("[example-serve] h100-x2: tokens differ from main()'s or device 0 "
                             "did not fail")
    if demo_served([r99], "[example-serve] request 99") != [alone.out_tokens]:
        raise AssertionError(f"[example-serve] request 99 after the replan {r99.out_tokens}, a "
                             f"fresh engine's {alone.out_tokens}")
    log(f"[example-serve] h100-x2 (odd device at half speed) on one card: device 0 failed, "
        f"replanned; request 99 -> {r99.out_tokens}, a fresh engine's; {len(fl.steps)} forwards "
        "on the kernels")
    del res, fresh, params
    free_card()

    full = serve.serving_config(LLAMA, smoke=False)
    params = build_model(full).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    reset_counts()
    t0 = time.perf_counter()
    with EngineForwards() as fl:
        reqs = serve_demo.demo_requests()
        serve_demo.demo(full, params, h100_cluster(1, heterogeneous=True), [dev], reqs)
    torch.cuda.synchronize(dev)
    full_counts = counts()
    check_forwards(fl.of(), full, "[example-serve] full width")
    require(full_counts, DENSE_PATH, "[example-serve] full width")
    demo_served(reqs, "[example-serve] full width")
    log(f"[example-serve] full width ({full.n_layers} layers, {full.dtype}): 8 requests served "
        f"in {time.perf_counter() - t0:.1f}s incl. the plan, {len(fl.steps)} forwards, launches "
        f"{full_counts}")
    del params
    free_card()
    return {"main": main_counts, "full": full_counts}


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
    time_verify(dev, flush, rows, dtype)
    time_encdec_vlm(dev, flush, rows, dtype)
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
    # the serve demo's D 32, in its dtype (fp32, the smoke configs')
    d32 = {}
    time_flash(dev, flush, d32, SMOKE, "d32_", torch.float32)
    for (name, case), r in d32.items():
        log(f"[time] {name} {case} fp32: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']} ms {r['library']}, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}), kernel/bound {r['ms'] / r['bound_ms']:.1f}x")
    rows.update(d32)
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


def encdec_vlm_entries(name, times, errs, served_encdec, parity_encdec, served_vlm,
                       parity_vlm) -> dict:
    """The flash row's numbers on this slice's paths: launches in
    [serve-encdec] (bf16, dense self cache) and [serve-vlm], or for the
    paged kernel in the fp32 paged runs of [parity-encdec] and
    [parity-vlm]; the timed non-causal and GQA 28 / 4 instances with their
    [check] errors (bf16)."""
    paged = name.endswith("paged")
    enc = parity_encdec["paged"] if paged else served_encdec["cli"]
    vlm = parity_vlm["paged"] if paged else served_vlm["cli"]
    out = {
        "encdec": {"launches": enc[name], "launches_from": "[parity-encdec] fp32 paged P64"
                   if paged else "[serve-encdec] run 1",
                   **({} if paged else {
                       "noncausal_launches": enc["flash_attention_noncausal"],
                       "launches_per_forward": served_encdec["per_forward"][name],
                       "encode_launches": served_encdec["encode"][name]})},
        "vlm": {"launches": vlm[name], "launches_from": "[parity-vlm] fp32 fused paged P64"
                if paged else "[serve-vlm] run 1",
                **({} if paged else {
                    "launches_per_forward": served_vlm["per_forward"][name]})},
    }
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    if paged:
        out["d128g7"] = {
            case: dict({k: times[(name, "d128g7_" + case)][k] for k in keys},
                       dense_ms=times[(name, "d128g7_" + case)]["dense_ms"],
                       yardstick_sdpa_ms=times[(name, "d128g7_" + case)]["sdpa_ms"],
                       max_abs_err=errs[(name, "d128g7_" + err, torch.bfloat16)])
            for case, err in (("decode", "sq1"), ("fused_chunk", "sq64"))}
        return out
    out["noncausal"] = {
        case: dict({k: times[(name, "noncausal_" + case)][k] for k in keys},
                   shape=times[(name, "noncausal_" + case)]["shape"],
                   max_abs_err=errs[(name, "noncausal_" + err, torch.bfloat16)])
        for case, err in (("encoder_512", "encoder_S500"),
                          ("cross_decode_512", "cross_decode_S500"),
                          ("cross_chunk_512", "cross_chunk_S500"))}
    out["d128g7"] = {
        case: dict({k: times[(name, "d128g7_" + case)][k] for k in keys},
                   shape=times[(name, "d128g7_" + case)]["shape"],
                   max_abs_err=errs[(name, "d128g7_" + err, torch.bfloat16)])
        for case, err in (("decode", "sq1"), ("chunk", "sq64"))}
    return out


def timed(fn, *args, **kw):
    """``fn(*args, **kw)``, and a line with its wall time (the script's
    budget is spent phase by phase)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    what = ", ".join([str(a) for a in args[1:]] + [f"{k}={v}" for k, v in kw.items()])
    log(f"[phase] {fn.__name__}({what}): {time.perf_counter() - t0:.1f}s")
    return out


def start_build():
    """:func:`phase_build` on a thread; returns a ``join`` that waits for
    it and raises what it raised."""
    box = {}

    def run():
        try:
            phase_build()
        except BaseException as e:  # noqa: BLE001 - re-raised by join
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]

    return join


def main() -> int:
    t_start = time.perf_counter()
    card = phase_card()
    dev = card["dev"]
    # the dry-run sweep needs no card: its queues start now (see DRYRUN_JOBS)
    dry_out = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    atexit.register(shutil.rmtree, dry_out, True)
    jobs = start_dryrun(dry_out)
    atexit.register(stop_dryrun, jobs)
    # so do the two planning examples (placeto's policy on the card)
    ex_out = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    atexit.register(shutil.rmtree, ex_out, True)
    examples = {name: start_example(name, module, argv, ex_out, nice=True)
                for name, (module, argv) in PLANNING_EXAMPLES.items()}
    atexit.register(stop_dryrun, examples)
    # the kernels build while the phases that launch none run: the trainer
    # (it refuses the forward-only kernels) with the train demo beside it,
    # placeto and the calibration
    join_build = start_build()
    train_demo = start_example("example-train", _EX + "train_demo",
                               EXAMPLE_TRAIN + ["--out", str(ex_out / "train_demo")], ex_out,
                               nice=False)
    atexit.register(stop_dryrun, {"example-train": train_demo})
    timed(phase_train, dev)
    timed(phase_placeto, dev)
    timed(phase_calibrate, dev)
    timed(phase_example_train, train_demo, ex_out)
    join_build()
    # the sharded trainer's ranks start now: the kernels are built
    free_card()
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_work_")
    ckpt, ep_inputs = os.path.join(work, "ckpt"), os.path.join(work, "gg_ep.pt")
    try:
        mesh_train = timed(phase_mesh_train, dev, ckpt, ep_inputs)
        mesh_moe = timed(phase_mesh_moe, mesh_train["moe"], dev, ep_inputs)
        mesh_ssm = timed(phase_mesh_ssm, mesh_train["ssm"], dev)
        timed(phase_mesh_elastic, mesh_train["llama_bf16"], ckpt)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the kernel checks and the parity runs time nothing: the sweep's
    # queues go on beside them, then stop before the first timed phase
    errs = timed(phase_check, dev)
    errs.update(timed(phase_check_gg_split, dev))
    errs.update(timed(phase_check_decode, dev))
    errs.update(timed(phase_check_verify, dev))
    errs.update(timed(phase_check_noncausal, dev))
    errs.update(timed(phase_check_gqa7, dev))
    errs.update(timed(phase_check_ssd, dev))
    errs.update(timed(phase_check_rmsnorm, dev))
    timed(phase_parity, dev)
    timed(phase_parity_paged, dev)
    parity_spec = timed(phase_parity_spec, dev)
    parity_router = timed(phase_parity_router, dev)
    parity_router_moe = timed(phase_parity_router_moe, dev)
    timed(phase_parity, dev, MOE)
    timed(phase_parity, dev, QWEN3)
    timed(phase_parity, dev, GEMMA, paged=True)
    timed(phase_parity_gemma2, dev)
    free_card()
    parity_ssm = timed(phase_parity_ssm, dev)
    parity_encdec = timed(phase_parity_encdec, dev)
    parity_vlm = timed(phase_parity_vlm, dev)
    free_card()
    timed(phase_parity_train, dev)
    free_card()
    example_serve = timed(phase_example_serve, dev)
    pause_dryrun(jobs)
    live = signal_dryrun(examples, signal.SIGSTOP)
    log(f"[examples] {len(live)} planning example(s) still running ({', '.join(live) or 'none'})"
        ": stopped until the end")
    served = timed(phase_serve, dev)
    served_paged = timed(phase_serve_paged, dev)
    served_spec = timed(phase_serve_spec, dev)
    served_router = timed(phase_serve_router, dev)
    served_moe = timed(phase_serve, dev, MOE)
    served_moe_paged = timed(phase_serve_paged, dev, MOE)
    served_qwen3 = timed(phase_serve, dev, QWEN3)
    served_gemma = timed(phase_serve, dev, GEMMA)
    served_gemma_paged = timed(phase_serve_paged, dev, GEMMA)
    free_card()
    served_gemma2 = timed(phase_serve, dev, GEMMA2)
    served_mamba = timed(phase_serve_ssm, dev, MAMBA)
    served_zamba = timed(phase_serve_ssm, dev, ZAMBA)
    timed(phase_trace_ssm, dev)
    timed(phase_parity_spec_ssm, dev)
    served_encdec = timed(phase_serve_encdec, dev)
    served_vlm = timed(phase_serve_vlm, dev)
    free_card()
    times = timed(phase_time, dev)
    timed(phase_dryrun_card, dev)
    signal_dryrun(examples, signal.SIGCONT)
    timed(phase_dryrun, jobs, dry_out)
    timed(phase_example_quickstart, examples["example-quickstart"], ex_out)
    timed(phase_example_placement, examples["example-placement"], ex_out)

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
            if not name.endswith("paged"):
                # the head-dim-32 instance, on the serve demo's path (fp32)
                t32 = times[(name, "d32_fused_chunk")]
                row["d32"] = {
                    "launches": example_serve["main"][name],
                    "launches_from": "[example-serve] serve_demo.main()",
                    "decode_launches": example_serve["main"][name + "_decode"],
                    "ms": t32["ms"], "plain_ms": t32["plain_ms"], "bound_ms": t32["bound_ms"],
                    "bound_by": t32["bound_by"], "library_ms": t32["library_ms"],
                    "dtype": "float32",
                    "max_abs_err": errs[(name, "d32_fused_chunk", torch.float32)],
                }
            row["decode"] = decode[name]
            # this slice's paths: seamless (the encoder's and the
            # cross-attention's non-causal calls on the dense kernel; the
            # self-attention paged in [parity-encdec]) and qwen2-vl (GQA 28 /
            # 4 at D 128)
            row.update(encdec_vlm_entries(name, times, errs, served_encdec, parity_encdec,
                                          served_vlm, parity_vlm))
            # a speculative round's verify rows, D 64 (llama): [8, 4] on the
            # decode kernel, [8, 5] on the chunk tile; launches: the verify
            # forwards of [parity-spec] (fp32) and [serve-spec] (k = 4, dense)
            paged = name.endswith("paged")
            row["verify"] = {}
            for k in SPEC_K:
                t = times[(name, f"verify_k{k}")]
                dense_k4 = not paged and k == SPEC_SERVE_K
                row["verify"][f"{'decode' if k == 3 else 'chunk'}_k{k}"] = {
                    "shape": [8, k + 1],
                    "launches": (served_spec["verify_launches"] if dense_k4
                                 else parity_spec[(paged, k)]),
                    "launches_from": "[serve-spec]" if dense_k4 else "[parity-spec]",
                    "max_abs_err": errs[(name, f"d64_verify_sq{k + 1}" + ("_P64" if paged else ""),
                                         torch.bfloat16)],
                    "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"],
                    "library_ms": t["library_ms"] if not paged else None,
                    **({"dense_ms": t["dense_ms"], "yardstick_gather_ms": t["gather_ms"],
                        "yardstick_sdpa_ms": t["sdpa_ms"]} if paged else
                       {"library": t["library"]}),
                }
        if name == "grouped_gemm":
            # this slice's path: moe_ep's local experts on each of four ranks
            row["moe_ep"] = mesh_moe_entry(mesh_moe)
            # the four main-path shapes: gate/up and down at decode and chunk
            row.update(library=t["library"], paged_launches=served_moe_paged["cli"][name],
                       shapes={c: {key: times[(name, c)][key] for key in (
                           "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "splits",
                           "host_us", "op_host_us", "library_host_us")}
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
                                  (MAMBA, served_mamba), (ZAMBA, served_zamba),
                                  (SEAMLESS, served_encdec), (VLM, served_vlm))}
            row["launches_by_config"][SEAMLESS]["encode_launches"] = served_encdec["encode"][name]
            row["launches_by_config"][SMOKE + " (serve demo, fp32)"] = {
                "launches": example_serve["main"][name],
                "rows_kernel": example_serve["main"]["rmsnorm_rows"]}
            row["launches_by_config"][LLAMA + " (serve demo, full width)"] = {
                "launches": example_serve["full"][name],
                "rows_kernel": example_serve["full"]["rmsnorm_rows"]}
            # [mesh-ssm]: rank 0's bf16 zamba2 forwards, the gated norms off the kernel
            ssm0 = mesh_train["ssm"][0]["bf16"]["launches"]
            row["launches_by_config"][ZAMBA + " (2 x 2, heads cut)"] = {
                "launches": sum(c[name] for c in ssm0), "launches_per_forward": ssm0[0][name],
                "rows_kernel": sum(c["rmsnorm_rows"] for c in ssm0)}
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
        # this slice's path: zamba2's trunk cut by heads on (2 x 2), rank 0's
        # bf16 forwards, 40 of the 80 heads a launch
        "mesh_ssm": {
            "launches": sum(c["ssd_scan"] for c in mesh_train["ssm"][0]["bf16"]["launches"]),
            "heads": mesh_ssm["bf16"]["heads"],
            "launches_prefill": mesh_ssm["bf16"]["launches_prefill"]["ssd_scan"],
        },
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
    # this slice's path: the launches of the --replicas 2 CLI run (bf16,
    # dense), of [parity-router]'s paged two-replica run (fp32) and of
    # [parity-router-moe]'s two MoE replicas (fp32)
    paged_router = parity_router[("2 replicas", "least_loaded", True)]
    router_runs = dict(served_router["cli"], grouped_gemm=parity_router_moe["grouped_gemm"],
                       flash_attention_paged=paged_router["flash_attention_paged"],
                       flash_attention_paged_decode=paged_router["flash_attention_paged_decode"])
    for row in kernels:
        if row["name"] in router_runs:
            row["router_launches"] = router_runs[row["name"]]
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    log(card["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
