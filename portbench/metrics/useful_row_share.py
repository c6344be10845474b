"""Share, in %, of the fused step's rows that carry a token: Σ ``q_lens`` over
Σ ``slots · S`` of the window's forwards (layer: ``serving/engine.py``,
the fused step)."""


def read(run):
    rows = sum(b * s for _, _, b, s, _, _ in run.forwards)
    if not rows:
        return None
    used = sum(b * s if ql is None else int(ql.sum()) for _, _, b, s, ql, _ in run.forwards)
    return 100.0 * used / rows
