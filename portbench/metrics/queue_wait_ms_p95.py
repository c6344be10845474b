"""95th percentile of due → admission to a slot, in ms, over every request
due in the window; one not admitted by the window's end counts with
(end − due) (layer: ``serving/engine.py``, admission)."""

from portbench.harness import stats


def read(run):
    v = stats.percentile(stats.queue_wait(run.recs, run.window), 95)
    return None if v is None else 1e3 * v
