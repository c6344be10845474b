"""Flash attention's share, in %, of its roofline (``kernels/flash_attention.py``
+ ``csrc/flash_attention.cu``): Σ over the device trace's forwards and layers of
each call's bound (``roofline/flash.py``) over the device time of the flash
kernels in the trace."""

from portbench.roofline import flash, model, peaks

KERNELS = ("flash_fwd",)


def read(run):
    if run.peak is None or run.trace is None or not run.traced_forwards:
        return None
    dev_s = run.trace.seconds_of(KERNELS)
    if not dev_s:
        return None
    cfg = run.cfg
    bound = 0.0
    for _, _, b, s, ql, cp in run.traced_forwards:
        qs = [s] * b if ql is None else ql.tolist()
        cs = [0] * b if cp is None else (cp.tolist() if getattr(cp, "ndim", 0) else [int(cp)] * b)
        ops, nbytes = flash.call(qs, cs, cfg["num_attention_heads"],
                                 cfg["num_key_value_heads"], model.head_dim(cfg))
        bound += cfg["num_hidden_layers"] * peaks.bound_s(ops, nbytes, run.peak)
    return 100.0 * bound / dev_s
