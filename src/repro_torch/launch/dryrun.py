"""Dry-run: one rank's step of every (arch × shape × mesh) cell, counted.

The reference lowers and compiles each cell for its production mesh on
512 placeholder host devices and reads the compiled program's memory and
cost analyses.  The port has no compiler to ask; it runs the step.  For
each cell, :func:`run_cell`:

* starts a ``"fake"`` process group of ``mesh.size`` ranks as rank 0 (no
  peer exists; every collective returns at once) and builds the
  ``DeviceMesh`` over it;
* under ``FakeTensorMode`` (no storage is allocated) makes the params, the
  optimizer state (8-bit moments above 100e9 params), the batch
  (:func:`input_specs`) and, for decode, the cache, each already cut into
  this rank's shard by the reference's rules (``param_pspec_tree``,
  ``zero1_shardings``, ``batch_pspecs``, ``cache_pspec_tree``);
* runs ``make_train_step`` (with :func:`_accum_steps`; micro-batches
  from the third on are counted as the second, which runs the same ops
  on the same shapes: :func:`run_step`), ``make_prefill_step`` or
  ``make_decode_step`` under
  :class:`~repro_torch.launch.roofline.StepCounter`, which counts the
  rank's own FLOPs, bytes and collective bytes, and the peak of the
  storage the step holds.

Every config default holds, as in the reference's cells: attention is
``chunked``, and the MoE, RMSNorm and SSD paths are the plain ones.  No
CUDA kernel is reached (a wrapper given a fake CUDA tensor raises); the
grouped GEMM is a custom op whose fake implementation gives its shape.

``memory`` keeps the reference's keys, for this rank: the arguments
(params, optimizer state, batch, cache), the outputs, and ``temp``, the
peak of storage made during the step.  ``fit_estimate_gb`` is arguments
plus temp, and ``fits_80gb`` holds it to one H100's 80 GB.  Eager PyTorch
materialises every intermediate, so the reference's discount for what a
TPU's fusion streams does not carry over: the estimate is the eager
program's peak.

With ``fake=False`` the same code path runs on real tensors on the card
(seeded init), on a mesh the machine holds (``mesh_shape``): the check
that the counts do not depend on fakes, and that the predicted peak and
the bound hold against the card.

Usage::

    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
    python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod both
    python -m repro_torch.launch.dryrun --arch llama3.2-1b,arctic-480b --shape train_4k
    python -m repro_torch.launch.dryrun ... --device cpu --out /tmp/dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.devices import GB, H100_HBM_BYTES
from repro_torch.launch.mesh import Mesh, PartitionSpec as P, make_mesh, make_production_mesh
from repro_torch.launch.roofline import StepCounter, roofline_terms
from repro_torch.models.model import active_param_count, build_model, param_count_shape
from repro_torch.parallel.context import ParallelContext, parallel_context
from repro_torch.parallel.sharding import (
    _spec_at,
    batch_pspecs,
    distribute,
    dp_axes,
    logical_rules,
    param_pspec_tree,
)
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import (make_decode_step, make_prefill_step, make_train_pieces,
                                    make_train_step)
from repro_torch.train.tree import leaves, tree_map_with_path

ARTIFACTS = Path(__file__).resolve().parents[3] / "bench-results" / "dryrun"

# --------------------------------------------------------------------------
# input specs
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class InputSpec:
    """One batch input: its global shape, dtype and PartitionSpec (the
    reference's ``ShapeDtypeStruct`` with a ``NamedSharding``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: P


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> Dict[str, InputSpec]:
    """The batch inputs of one cell, with their shardings."""
    b, s = shape.global_batch, shape.seq_len
    specs = batch_pspecs(cfg, shape, mesh)
    bf16, i32 = torch.bfloat16, torch.int32
    if shape.kind == "decode":
        # one new token against a cache of length s
        if cfg.frontend == "patch_stub":
            return {"embeds": InputSpec((b, 1, cfg.d_model), bf16, specs["embeds"]),
                    "positions": InputSpec((3, b, 1), i32, specs["positions"])}
        return {"tokens": InputSpec((b, 1), i32, specs["tokens"])}
    out: Dict[str, InputSpec] = {}
    if cfg.frontend == "patch_stub":
        out["embeds"] = InputSpec((b, s, cfg.d_model), bf16, specs["embeds"])
        out["positions"] = InputSpec((3, b, s), i32, specs["positions"])
    elif cfg.frontend == "frame_stub":
        out["frames"] = InputSpec((b, s, cfg.d_model), bf16, specs["frames"])
        out["tokens"] = InputSpec((b, s), i32, specs["tokens"])
    else:
        out["tokens"] = InputSpec((b, s), i32, specs["tokens"])
    if shape.kind == "train":
        out["labels"] = InputSpec((b, s), i32, specs["labels"])
    return out


def _accum_steps(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> int:
    """Pick gradient-accumulation steps from an activation-memory budget.

    §Perf iteration (qwen2-moe train_4k): per-microbatch collectives (TP
    psums, MoE all-to-alls, per-micro grad psum) scale linearly with accum;
    the old fixed micro=2 policy left a 13.5× t_coll/t_comp ratio.  Choose
    the LARGEST microbatch whose rematted layer-boundary activations
    (L · B_micro · S · D · 2B) fit ~4 GB instead."""
    from repro_torch.parallel.sharding import dp_axes_for

    dp = int(np.prod([mesh.shape[a] for a in dp_axes_for(cfg, mesh, shape.global_batch)]))
    b_loc = max(shape.global_batch // max(dp, 1), 1)
    budget = 4e9
    layers = cfg.n_layers + cfg.n_encoder_layers
    per_seq = max(layers * shape.seq_len * cfg.d_model * 2.0, 1.0)
    micro_target = max(int(budget // per_seq), 1)
    # largest power-of-two divisor of b_loc that fits the budget
    micro = 1
    while micro * 2 <= micro_target and b_loc % (micro * 2) == 0:
        micro *= 2
    return max(1, b_loc // micro)


def make_context(mesh: Mesh, cfg: ModelConfig = None, global_batch: int = 0) -> ParallelContext:
    from repro_torch.parallel.sharding import dp_axes_for, pure_dp_active

    pure_dp = cfg is not None and pure_dp_active(cfg, mesh, global_batch)
    rules = logical_rules(mesh)
    if pure_dp:
        dp = dp_axes_for(cfg, mesh, global_batch)
        rules = dict(rules)
        rules.update({"batch": dp, "heads": None, "kv_heads": None,
                      "ff": None, "vocab": None, "experts": "data",
                      "expert_ff": None})
        return ParallelContext(mesh, rules, ep_axes=("data",), dp_axes=dp,
                               tp_axis=None)
    return ParallelContext(
        mesh,
        rules,
        ep_axes=("data",),
        dp_axes=dp_axes(mesh),
        tp_axis="model",
    )


# --------------------------------------------------------------------------
# the rank
# --------------------------------------------------------------------------


@contextlib.contextmanager
def fake_ranks(world: int):
    """This process as rank 0 of a ``"fake"`` process group of ``world``
    ranks, torn down on exit.  Refuses to start over a running group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running: the dry-run starts its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _shard(mesh: Mesh, spec: Sequence, shape: Tuple[int, ...], dtype, device, full=None):
    """A DTensor of global ``shape`` laid out by ``spec``: ``full`` (the
    whole tensor, real) cut to this rank's shard, or an empty local shard
    (fake)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import contiguous_strides, local_shape_and_offset, placements

    if full is not None:
        return distribute(full, mesh, spec)
    pl = placements(spec, mesh)
    local_shape, _ = local_shape_and_offset(shape, mesh.device_mesh, pl)
    local = torch.empty(local_shape, dtype=dtype, device=device)
    stride = contiguous_strides(shape)
    return DTensor.from_local(local, mesh.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _params(cfg: ModelConfig, mesh: Mesh, pure_dp: bool, device, fake: bool, seed: int):
    model = build_model(cfg)
    if fake:
        tree = model.init(torch.Generator(), "meta")
        specs = param_pspec_tree(cfg, mesh, tree, pure_dp=pure_dp)
        return tree_map_with_path(
            lambda path, x: _shard(mesh, _spec_at(specs, path), tuple(x.shape), x.dtype, device),
            tree)
    from repro_torch.parallel.sharding import param_shardings

    gen = torch.Generator(device).manual_seed(seed)
    return param_shardings(cfg, mesh, model.init(gen, device), pure_dp=pure_dp)


def _batch(cfg: ModelConfig, specs: Dict[str, InputSpec], mesh: Mesh, device, fake: bool,
           seed: int) -> Dict[str, Any]:
    gen = None if fake else torch.Generator(device).manual_seed(seed + 1)
    out = {}
    for name, sp in specs.items():
        full = None
        if not fake:
            if name == "positions":
                s = sp.shape[-1]
                full = torch.arange(s, dtype=torch.int32, device=device).expand(sp.shape)
                full = full.contiguous()
            elif sp.dtype == torch.int32:
                full = torch.randint(0, cfg.vocab_size, sp.shape, generator=gen, device=device,
                                     dtype=torch.int32)
            else:
                full = torch.randn(sp.shape, generator=gen, device=device).to(sp.dtype)
        out[name] = _shard(mesh, sp.spec, sp.shape, sp.dtype, device, full)
    return out


def _storage_bytes(tree) -> int:
    """Bytes of the distinct local storages under ``tree`` (DTensors count
    their shard)."""
    seen, total = set(), 0
    for x in leaves(tree):
        if not isinstance(x, torch.Tensor):
            continue
        if hasattr(x, "to_local"):
            x = x.to_local()
        s = x.untyped_storage()
        if s._cdata in seen:
            continue
        seen.add(s._cdata)
        total += s.nbytes()
    return total


@dataclass
class StepRun:
    """What one counted step gave: the counter, the step's own arguments
    and a callable that runs the step again (for timing)."""

    counter: StepCounter
    output_bytes: int
    accum: int
    quant8: bool
    again: Callable[[], Any]
    argument_parts: Dict[str, int]            # params, opt, batch, cache (with its position)
    device_peak_bytes: Optional[int] = None   # real CUDA tensors: the card's peak

    @property
    def argument_bytes(self) -> int:
        return sum(self.argument_parts.values())


def time_step(run: StepRun, device, iters: int) -> float:
    """The median seconds of ``iters`` more runs of the step, each
    synchronized with the device (the counted run was the warm-up)."""
    sync = (lambda: torch.cuda.synchronize(device)) if torch.device(device).type == "cuda" \
        else (lambda: None)
    times = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        out = run.again()
        sync()
        del out
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def run_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *, device, fake: bool = True,
             seed: int = 0, kind: Optional[str] = None, accum: Optional[int] = None,
             every_micro: bool = False) -> StepRun:
    """Build one rank's state for (``cfg``, ``shape``) on ``mesh`` (whose
    ranks are up) and run ``kind`` once under the counter.  ``kind``:
    ``"train"`` (the whole train step), ``"prefill"``, ``"decode"``, or
    :mod:`~repro_torch.launch.roofline_fd`'s pieces of a train step:
    ``"train_micros"`` (every micro-batch's forward and backward, its
    gradients added into the accumulator) and ``"opt"`` (the rest: the
    accumulator's zeros, the mean, the optimizer update).

    The counted ``"train"`` step runs the first two micro-batches and
    counts the second ``accum - 2`` more times: from the second on, each
    micro-batch runs the same ops on tensors of the same shapes (its rows
    of the batch, added into an accumulator that exists), so its FLOPs,
    bytes and collectives are the second's, and the storage it holds at
    its peak is too.  ``every_micro`` runs every one instead (the test of
    that equality).  The step that ``again`` times runs them all."""
    from repro_torch.parallel.sharding import pure_dp_active

    kind = kind or shape.kind
    ctx = make_context(mesh, cfg, shape.global_batch)
    model = build_model(cfg)
    quant8 = param_count_shape(cfg) > 100e9
    pure = pure_dp_active(cfg, mesh, shape.global_batch)
    if accum is None:
        accum = _accum_steps(cfg, shape, mesh) if shape.kind == "train" else 1
    faking = _fake_mode(fake)
    with faking, parallel_context(ctx):
        params = _params(cfg, mesh, pure, device, fake, seed)
        batch = _batch(cfg, input_specs(cfg, shape, mesh), mesh, device, fake, seed)
        counter = StepCounter()
        grad_ctx = torch.no_grad if kind in ("prefill", "decode") else contextlib.nullcontext
        counted = None
        if kind in ("train", "train_micros", "opt"):
            opt = init_opt_state(params, quant8=quant8, mesh=mesh)
            args, parts = (params, opt, batch), {"params": params, "opt": opt, "batch": batch}
            start, micro, finish = make_train_pieces(model, AdamWConfig(), accum_steps=accum)
            if kind == "train":
                fn = make_train_step(model, AdamWConfig(), accum_steps=accum)
                if not every_micro and accum > 2:
                    def counted(params, opt, batch):
                        acc = micro(params, start(params, batch), 0)
                        before = counter.snapshot()
                        acc = micro(params, acc, 1)
                        counter.repeat(before, accum - 2)
                        return finish(params, opt, acc)
            if kind == "train_micros":
                def fn(params, opt, batch):
                    acc = _uncounted(counter, start, params, batch)
                    return _micros(micro, params, acc, accum)["grads"]
            elif kind == "opt":
                def fn(params, opt, batch):
                    # the update takes real gradients: their layout (partial
                    # sums included) decides what it moves
                    acc = start(params, batch)
                    acc = _uncounted(counter, _micros, micro, params, acc, accum)
                    return finish(params, opt, acc)
        elif kind == "prefill":
            args, parts = (params, batch), {"params": params, "batch": batch}
            fn = make_prefill_step(model)
        else:
            cache = model.init_cache(shape.global_batch, shape.seq_len, device)
            pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32, device=device)
            args = (params, batch, cache, pos)
            parts = {"params": params, "batch": batch, "cache": (cache, pos)}
            fn = make_decode_step(model)
        arg_parts = {k: _storage_bytes(v) for k, v in parts.items()}

        def again():
            with parallel_context(ctx), grad_ctx():
                return fn(*args)

        real_cuda = not fake and torch.device(device).type == "cuda"
        if real_cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        with grad_ctx(), counter:
            out = (counted or fn)(*args)
        device_peak = None
        if real_cuda:
            torch.cuda.synchronize(device)
            device_peak = torch.cuda.max_memory_allocated(device)
        out_bytes = _storage_bytes(out)
        del out
    return StepRun(counter, out_bytes, accum, quant8, again, arg_parts, device_peak)


def _micros(micro, params, acc, accum: int):
    for i in range(accum):
        acc = micro(params, acc, i)
    return acc


def _uncounted(counter: StepCounter, fn, *args):
    """``fn(*args)`` with ``counter`` off (inside the counted block)."""
    counter.__exit__(None, None, None)
    try:
        return fn(*args)
    finally:
        counter.__enter__()


def _fake_mode(fake: bool):
    if not fake:
        return contextlib.nullcontext()
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


# --------------------------------------------------------------------------
# one cell
# --------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *, device: str = "cuda",
             verbose: bool = True, fake: bool = True, mesh_shape: Optional[Tuple[int, ...]] = None,
             cfg: Optional[ModelConfig] = None, shape: Optional[ShapeConfig] = None,
             time_iters: int = 0) -> Dict[str, Any]:
    """The dry-run of one cell (the reference's keys; ``elapsed_s`` for its
    ``compile_s``).  ``mesh_shape`` overrides the production mesh (axes
    ``data, model``, or ``pod, data, model`` for three sizes); ``cfg`` and
    ``shape`` override the arch's config and the named shape.  With
    ``time_iters`` the step runs that many more times (the counted run
    warmed it up) and ``measured_step_s`` is their median; with real CUDA tensors
    ``device_peak_bytes`` is the card's peak during the counted step."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}

    t0 = time.time()
    layout = make_production_mesh(multi_pod=multi_pod)
    if mesh_shape is not None:
        names = ("pod", "data", "model") if len(mesh_shape) == 3 else ("data", "model")
        layout = Mesh(mesh_shape, names)
    dev = torch.device(device)
    with fake_ranks(int(np.prod(list(layout.shape.values())))):
        mesh = make_mesh(tuple(layout.shape.values()), layout.axis_names, dev.type)
        run = run_step(cfg, shape, mesh, device=dev, fake=fake)
        measured = time_step(run, dev, time_iters) if time_iters else None
        del run.again
    c = run.counter
    n_dev = mesh.device_mesh.size()
    result = {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "status": "ok",
        "n_devices": n_dev,
        "elapsed_s": round(time.time() - t0, 1),
        "flops_per_device": float(c.flops),
        "bytes_per_device": float(c.bytes),
        "collective_bytes_per_device": c.collectives["total"],
        "collectives": c.collectives["by_kind"],
        "collective_counts": c.collectives["counts"],
        "params": param_count_shape(cfg),
        "active_params": active_param_count(cfg),
        "quant8_opt": run.quant8,
        "accum_steps": run.accum,
        "memory": {
            "argument_size_in_bytes": run.argument_bytes,
            "output_size_in_bytes": run.output_bytes,
            "temp_size_in_bytes": c.peak_bytes,
        },
    }
    if measured is not None:
        result["measured_step_s"] = measured
    if run.device_peak_bytes is not None:
        result["device_peak_bytes"] = run.device_peak_bytes
    fit = (run.argument_bytes + c.peak_bytes) / GB
    result["fit_estimate_gb"] = round(fit, 2)
    result["fits_80gb"] = bool(fit * GB <= H100_HBM_BYTES)
    result.update(roofline_terms(result, cfg, shape))
    if verbose:
        print(
            f"[dryrun] {arch} × {shape_name} × {'2pod' if multi_pod else '1pod'}: OK "
            f"{result['elapsed_s']}s flops/dev={c.flops:.3e} bytes/dev={c.bytes:.3e} "
            f"coll/dev={c.collectives['total']:.3e} mem≈{fit:.2f}GB "
            f"dominant={result['dominant']}"
        )
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all", help="an arch, several (a,b), or all")
    ap.add_argument("--shape", default="all", help="a shape, several (a,b), or all")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the fake tensors' device (nothing is allocated on it)")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                tag = f"{arch}__{shape}__{'2pod' if mp else '1pod'}"
                fp = outdir / f"{tag}.json"
                try:
                    res = run_cell(arch, shape, mp, device=args.device)
                except Exception as e:  # noqa: BLE001 — record and continue
                    traceback.print_exc()
                    res = {
                        "arch": arch, "shape": shape, "multi_pod": mp,
                        "status": "error", "error": f"{type(e).__name__}: {e}",
                    }
                    failures += 1
                fp.write_text(json.dumps(res, indent=2, default=str))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
