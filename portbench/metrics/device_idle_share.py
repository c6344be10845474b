"""Share, in %, of the device trace's window (the measured window's
last seconds, ``harness/trace.py``) in which no operation ran on the card:
1 − (union of the device events' intervals ÷ window)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
