"""Per-layer roofline by finite differences over counted steps.

The reference needs this to repair XLA's counts: ``cost_analysis()``
counts a ``lax.scan`` body once whatever its trip count, so it compiles
each cell at two depths and rebuilds the full-depth cost from the
difference:

  train:   c(A, L) = c_opt + A · (c_micro + L · c_layer)
  serve:   c(L)    = c_base + L · c_layer

(the port's train form is ``c_opt + c_micros(L)``: see below)

The port counts every layer it runs (:mod:`repro_torch.launch.dryrun`
runs the step eagerly, layer by layer, micro-batch by micro-batch), so
nothing needs repairing here: the same decomposition is a check.  Its
reconstruction must equal the direct count of the same config at full
depth, FLOPs, bytes and collective bytes alike, and ``--check`` runs that
direct count beside it.  What it still gives is the split: a layer unit's
cost, the rest of a micro-batch (embedding, head, loss), and the
optimizer's.

Pieces of a train step, as :func:`repro_torch.train.step.make_train_pieces`
cuts it: ``opt`` (the accumulator's zeros, the mean over micro-batches,
the AdamW update) and the accumulation loop (every micro-batch's forward
and backward, its gradients added into the accumulator), measured at two
depths with the cell's accumulation steps.  ``per_layer_unit`` and
``base`` are the loop's, all ``accum_steps`` micro-batches together: the
first micro-batch adds into zeros laid out like the params, the others
into partial sums, so A times one micro-batch would not be exact.  Each
variant runs the reference's FD config (:func:`_with_layers`: ``naive``
attention, one attention chunk, unstacked layers), and so does the direct
count it is held to.

Output: ``bench-results/roofline/<arch>__<shape>.json`` (``--out``).

Usage::

    python -m repro_torch.launch.roofline_fd --arch llama3.2-1b --shape decode_32k --check
    python -m repro_torch.launch.roofline_fd --device cpu --out /tmp/roofline ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from dataclasses import replace
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.dryrun import _accum_steps, fake_ranks, run_step
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh
from repro_torch.launch.roofline import roofline_terms
from repro_torch.models.model import active_param_count, param_count_shape

ARTIFACTS = Path(__file__).resolve().parents[3] / "bench-results" / "roofline"

_KEYS = ("flops", "bytes", "coll")


def _measure(run) -> Dict:
    c = run.counter
    coll = c.collectives
    return {"flops": float(c.flops), "bytes": float(c.bytes), "coll": float(coll["total"]),
            "coll_by_kind": coll["by_kind"]}


def _sub(a, b):
    return {k: a[k] - b[k] for k in _KEYS}


def _layer_counts(cfg):
    """(L1, L2, unit) — unit respects layer-pattern periodicity."""
    if cfg.family == "hybrid":
        u = cfg.shared_attn_every
        return u, 2 * u, u
    if cfg.local_global_pattern:
        u = len(cfg.local_global_pattern)
        return u, 2 * u, u
    return 1, 2, 1


def _with_layers(cfg, n):
    # the reference's FD config: unrolled layers and naive (non-scanned)
    # attention, kept here so that both packages count the same program
    kw = {
        "n_layers": n,
        "scan_layers": False,
        "attention_impl": "naive",
        "attn_chunk": 1 << 30,
    }
    if cfg.family == "encdec":
        kw["n_encoder_layers"] = n
    return replace(cfg, **kw)


def _lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, kind: str, *, device,
                accum: Optional[int] = None) -> Dict:
    """Count one program variant on ``mesh``'s ranks: ``kind`` is
    ``"train_micros"``, ``"opt"``, ``"train"``, ``"prefill"`` or
    ``"decode"`` (:func:`~repro_torch.launch.dryrun.run_step`)."""
    return _measure(run_step(cfg, shape, mesh, device=device, kind=kind, accum=accum))


def run_cell(arch: str, shape_name: str, *, device: str = "cuda", check: bool = False,
             mesh_shape: Optional[Tuple[int, ...]] = None, cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None) -> Dict:
    """The finite difference of one cell on the production mesh (or
    ``mesh_shape``, axes ``data, model``); ``cfg`` and ``shape`` override
    the arch's config and the named shape.  ``check``: also the direct
    full-depth count, and whether the reconstruction equals it."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": reason}
    t0 = time.time()
    layout = make_production_mesh(multi_pod=False)
    if mesh_shape is not None:
        layout = Mesh(mesh_shape, ("data", "model"))
    L1, L2, unit = _layer_counts(cfg)
    L_full = cfg.n_layers
    dev = torch.device(device)
    accum = _accum_steps(cfg, shape, layout) if shape.kind == "train" else 1
    kind = {"train": "train_micros", "prefill": "prefill", "decode": "decode"}[shape.kind]

    with fake_ranks(int(np.prod(list(layout.shape.values())))):
        mesh = make_mesh(tuple(layout.shape.values()), layout.axis_names, dev.type)
        c1 = _lower_cell(_with_layers(cfg, L1), shape, mesh, kind, device=dev, accum=accum)
        c2 = _lower_cell(_with_layers(cfg, L2), shape, mesh, kind, device=dev, accum=accum)
        per_unit = _sub(c2, c1)                                  # one unit of layers
        n_units = L_full // unit
        base = {k: c1[k] - per_unit[k] * (L1 // unit) for k in per_unit}
        loop = {k: base[k] + per_unit[k] * n_units for k in per_unit}
        result = {
            "arch": arch,
            "shape": shape_name,
            "status": "ok",
            "n_devices": mesh.device_mesh.size(),
            "params": param_count_shape(cfg),
            "active_params": active_param_count(cfg),
            "per_layer_unit": per_unit,
            "base": base,
        }
        full = _with_layers(cfg, L_full)
        if shape.kind == "train":
            copt = _lower_cell(full, shape, mesh, "opt", device=dev, accum=accum)
            total = {k: copt[k] + loop[k] for k in _KEYS}
            result["accum_steps"] = accum
            result["opt"] = {k: copt[k] for k in _KEYS}
        else:
            total = loop
        if check:
            direct = _lower_cell(full, shape, mesh, shape.kind, device=dev, accum=accum)
            result["direct"] = {k: direct[k] for k in _KEYS}
            result["reconstruction_equal"] = all(total[k] == direct[k] for k in _KEYS)

    result["elapsed_s"] = round(time.time() - t0, 1)
    result["flops_per_device"] = total["flops"]
    result["bytes_per_device"] = total["bytes"]
    result["collective_bytes_per_device"] = total["coll"]
    result.update(roofline_terms(result, cfg, shape))
    print(
        f"[roofline] {arch} × {shape_name}: compute={result['t_compute_s']:.4f}s "
        f"memory={result['t_memory_s']:.4f}s coll={result['t_collective_s']:.4f}s "
        f"dominant={result['dominant']} useful={result['useful_flops_ratio']:.2f} "
        f"({result['elapsed_s']}s)"
        + (f" direct-equal={result['reconstruction_equal']}" if check else "")
    )
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all", help="an arch, several (a,b), or all")
    ap.add_argument("--shape", default="all", help="a shape, several (a,b), or all")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the fake tensors' device (nothing is allocated on it)")
    ap.add_argument("--check", action="store_true",
                    help="also count the full-depth step directly; a reconstruction "
                         "that differs is an error")
    args = ap.parse_args(argv)
    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            fp = outdir / f"{arch}__{shape}.json"
            try:
                res = run_cell(arch, shape, device=args.device, check=args.check)
                if res.get("reconstruction_equal") is False:
                    res["status"] = "error"
                    res["error"] = "reconstruction differs from the direct count"
                    failures += 1
            except Exception as e:  # noqa: BLE001 — record and continue
                traceback.print_exc()
                res = {"arch": arch, "shape": shape, "status": "error",
                       "error": f"{type(e).__name__}: {e}"}
                failures += 1
            fp.write_text(json.dumps(res, indent=2, default=str))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
