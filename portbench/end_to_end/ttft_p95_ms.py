"""95th percentile, in ms, over every request due in the window, of first
token time − due time; a request still without a token at the window's
end counts with (end − due)."""

from portbench.harness import stats


def read(run):
    v = stats.percentile(stats.ttft(run.recs, run.window), 95)
    return None if v is None else 1e3 * v
