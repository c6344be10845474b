"""Host time of an engine step outside its forward, in ms: the mean over
the window's steps of (step wall − forward wall): admission, the page
table, the argmax read, retirement (layer: ``serving/engine.py``)."""


def read(run):
    vals = []
    for t0, t1, f0, f1 in run.steps:
        fwd = sum(b - a for a, b, *_ in run.forwards[f0:f1])
        vals.append(t1 - t0 - fwd)
    return 1e3 * sum(vals) / len(vals) if vals else None
