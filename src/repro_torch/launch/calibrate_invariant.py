"""Profile-calibrate the batch-aware cost model's invariant fractions.

The batched decode roofline (:meth:`CostModel._roofline`) splits an op's
HBM traffic into a batch-invariant share (weights — streamed once per
batched step) and a per-request share (activations / KV), using the
per-op-class fractions in :data:`DEFAULT_BATCH_INVARIANT_FRAC`.  Those
fractions are a *traffic model*; this script measures them, per op class,
from the bytes each computation moves:

1. for each op class, run a representative decode-shaped computation at
   several batch widths under a ``TorchDispatchMode`` that sums the bytes
   of every ATen op's tensor inputs and outputs (each input read once, each
   output written once; views move nothing and are not counted) — the
   counterpart of XLA's ``cost_analysis()["bytes accessed"]``;
2. least-squares fit ``bytes(B) = invariant + B * per_request`` per class
   (:func:`repro_torch.core.costmodel.calibrate_invariant_frac`);
3. report ``invariant / bytes(1)`` — the exact quantity the roofline
   consumes — next to the shipped default.

The fractions are printed and written, not fed into ``CostModel``.  The
computations run on the card unless ``--device cpu``; the counts depend on
the ops and shapes only, so both give the same bytes.  Run::

    PYTHONPATH=src python -m repro_torch.launch.calibrate_invariant \\
        --batches 1,2,4,8 --out calib_invariant.json

The representative computations mirror where each class shows up in the
serving decode step: ``matmul`` is a weight-resident GEMV, ``conv`` the
mamba short causal conv (weights small, state per-request), ``einsum`` the
attention score/value contractions against a per-request KV stream,
``ssd`` the mamba2 chunked state update (shared A/dt vectors, per-request
state), ``scan`` an associative state scan, ``softmax`` pure activation
traffic.  Classes with no invariant operand calibrate to ~0 by
construction — measuring that (instead of guessing 0.3–0.6) is the point.
An unfused op sequence moves its intermediates through memory where a
fusing compiler does not, so eager byte counts run above a fused program's
for classes of several elementwise steps; ``scan`` and ``softmax`` are one
ATen op each here (``cumsum``, ``softmax``), below XLA's unfused lowering
of the same functions.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.costmodel import (
    DEFAULT_BATCH_INVARIANT_FRAC,
    calibrate_invariant_frac,
)
from repro_torch.device import resolve_device
from repro_torch.launch.roofline import ByteCounter

# decode-step working sizes: big enough that byte counts dominate
# bookkeeping noise, small enough to run instantly on CPU
D_MODEL = 512
D_HEAD = 64
N_HEADS = 8
SEQ = 256          # resident KV / state length a decode step streams
CONV_K = 4
SSD_CHUNK = 64

def _zeros(device, *shape):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _op_matmul(B: int, device) -> Tuple[Callable, tuple]:
    # decode GEMV: per-request activation row against resident weights
    w = _zeros(device, D_MODEL, 4 * D_MODEL)
    x = _zeros(device, B, D_MODEL)
    return (lambda x, w: x @ w), (x, w)


def _op_conv(B: int, device) -> Tuple[Callable, tuple]:
    # mamba-style depthwise causal conv over the short conv window
    w = _zeros(device, D_MODEL, 1, CONV_K)
    x = _zeros(device, B, D_MODEL, CONV_K)
    return (lambda x, w: F.conv1d(x, w, groups=D_MODEL)), (x, w)


def _op_einsum(B: int, device) -> Tuple[Callable, tuple]:
    # decode attention: q row against the per-request KV stream (scores +
    # weighted values) — no resident-weight operand at all
    q = _zeros(device, B, N_HEADS, 1, D_HEAD)
    k = _zeros(device, B, N_HEADS, SEQ, D_HEAD)
    v = _zeros(device, B, N_HEADS, SEQ, D_HEAD)

    def fn(q, k, v):
        s = torch.einsum("bhqd,bhkd->bhqk", q, k)
        return torch.einsum("bhqk,bhkd->bhqd", s, v)

    return fn, (q, k, v)


def _op_ssd(B: int, device) -> Tuple[Callable, tuple]:
    # mamba2 chunked state update: per-request hidden state vs shared
    # per-head decay/step vectors (the only invariant operands)
    a = _zeros(device, N_HEADS)
    dt = _zeros(device, N_HEADS)
    state = _zeros(device, B, N_HEADS, D_HEAD, D_HEAD)
    xbc = _zeros(device, B, SSD_CHUNK, N_HEADS, D_HEAD)

    def fn(state, xbc, a, dt):
        decay = torch.exp(a * dt)[None, :, None, None]
        # einsum("blhd,blhe->bhde") as one batched product over the
        # operands laid out [b, h, d, l] and [b, h, l, e]
        upd = xbc.permute(0, 2, 3, 1).contiguous() @ xbc.permute(0, 2, 1, 3).contiguous()
        return torch.addcmul(upd, state, decay)

    return fn, (state, xbc, a, dt)


def _op_scan(B: int, device) -> Tuple[Callable, tuple]:
    # associative state scan over per-request sequences
    x = _zeros(device, B, SEQ, D_MODEL)
    return (lambda x: torch.cumsum(x, dim=1)), (x,)


def _op_softmax(B: int, device) -> Tuple[Callable, tuple]:
    x = _zeros(device, B, N_HEADS, SEQ)
    return (lambda x: torch.softmax(x, dim=-1)), (x,)


OPS: Dict[str, Callable[[int, torch.device], Tuple[Callable, tuple]]] = {
    "matmul": _op_matmul,
    "conv": _op_conv,
    "einsum": _op_einsum,
    "ssd": _op_ssd,
    "scan": _op_scan,
    "softmax": _op_softmax,
}


def measured_bytes(cls: str, batch: int, device=None) -> float:
    """Bytes class ``cls``'s computation moves at batch ``batch`` on
    ``device`` (default: the first card)."""
    fn, args = OPS[cls](batch, resolve_device(device))
    with torch.no_grad(), ByteCounter() as counter:
        fn(*args)
    return float(counter.bytes)


def collect(batches, device=None) -> Dict[str, Dict[int, float]]:
    out: Dict[str, Dict[int, float]] = {}
    for cls in OPS:
        out[cls] = {b: measured_bytes(cls, b, device) for b in batches}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="1,2,4,8",
                    help="comma-separated batch widths (need >= 2)")
    ap.add_argument("--out", default=None,
                    help="write raw bytes + fitted fractions to this JSON")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the computations run (cuda: the first card)")
    args = ap.parse_args(argv)
    batches = sorted({int(b) for b in args.batches.split(",")})
    if len(batches) < 2:
        ap.error("need at least two batch widths to fit the traffic model")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (use --device cpu)")

    bytes_by_batch = collect(batches, torch.device(args.device, 0) if args.device == "cuda"
                             else torch.device("cpu"))
    fracs = calibrate_invariant_frac(bytes_by_batch)

    print(f"{'class':<10} {'bytes(B=1)':>12} {'bytes(B=max)':>13} "
          f"{'fitted':>8} {'shipped':>8}")
    for cls in OPS:
        pts = bytes_by_batch[cls]
        print(f"{cls:<10} {pts[batches[0]]:>12.0f} {pts[batches[-1]]:>13.0f} "
              f"{fracs[cls]:>8.3f} {DEFAULT_BATCH_INVARIANT_FRAC[cls]:>8.2f}")

    if args.out:
        payload = {
            "batches": batches,
            "bytes_by_batch": {c: {str(b): v for b, v in p.items()}
                               for c, p in bytes_by_batch.items()},
            "fractions": fracs,
            "shipped_defaults": dict(DEFAULT_BATCH_INVARIANT_FRAC),
        }
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
