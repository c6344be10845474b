"""95th percentile, in ms, of every gap between consecutive output tokens
of every request whose later token was emitted in the window."""

from portbench.harness import stats


def read(run):
    v = stats.percentile(stats.itl_gaps(run.recs, run.window), 95)
    return None if v is None else 1e3 * v
