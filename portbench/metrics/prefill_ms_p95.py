"""95th percentile, in ms, of a prompt's time in the engine from its slot
to its first token (layer: ``serving/engine.py``, the fused step's chunked
prefill): ``t_first − t_admit``, the program's stamps on each ``Request``,
over the first tokens appended in the window.  None where the program does
not stamp its requests."""

from portbench.harness import stats


def read(run):
    win, vals = run.window, []
    for r in run.recs:
        tf = getattr(r.req, "t_first", None)
        if tf is not None and win.start <= tf <= win.end:
            vals.append(tf - r.req.t_admit)
    v = stats.percentile(vals, 95)
    return None if v is None else 1e3 * v
