"""Generated tokens emitted in the window ÷ the window's seconds."""

from portbench.harness import stats


def read(run):
    return stats.output_tokens(run.recs, run.window) / (run.window.end - run.window.start)
