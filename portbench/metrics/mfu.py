"""The whole step's share, in %, of the chip's bf16 peak (layers:
``models/transformer.py``, ``models/moe.py``): the FLOPs the device
trace's useful tokens need (``roofline/model.py``: every token that entered a
forward, at its depth, and the head for every token emitted) over
(traced window × peak)."""

from portbench.roofline import model


def read(run):
    if run.peak is None or run.trace is None or not run.traced_forwards:
        return None
    flops = 0.0
    for _, _, b, s, ql, cp in run.traced_forwards:
        for i in range(b):
            q = s if ql is None else int(ql[i])
            c = 0 if cp is None else int(cp[i] if getattr(cp, "ndim", 0) else cp)
            flops += model.forward_flops(run.cfg, q, c)
    flops += model.head_flops(run.cfg, run.emitted_in_trace)
    return 100.0 * flops / (run.trace.window_s * run.peak["bf16_flops"])
