"""The grouped GEMM's share, in %, of its roofline (``kernels/grouped_gemm.py`` +
``csrc/grouped_gemm.cu``): Σ over the device trace's calls of each call's bound
(``roofline/grouped_gemm.py``, from its group sizes) over the device time
of the grouped GEMM kernels in the trace."""

from portbench.roofline import grouped_gemm, peaks

KERNELS = ("grouped_gemm",)


def read(run):
    if run.peak is None or run.trace is None or not run.traced_gg_calls:
        return None
    dev_s = run.trace.seconds_of(KERNELS)
    if not dev_s:
        return None
    bound = sum(peaks.bound_s(*grouped_gemm.call(g, k, n), run.peak) for g, k, n in run.traced_gg_calls)
    return 100.0 * bound / dev_s
