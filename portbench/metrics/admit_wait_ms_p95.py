"""95th percentile, in ms, of the engine's own wait for a slot (layer:
``serving/engine.py``, admission): ``t_admit − t_submit``, the program's
stamps on each ``Request``, over the requests due in the window, as
``queue_wait_ms_p95`` takes them.  One not admitted by the window's end
counts (end − ``t_submit``), and one refused without a slot counts 0.
Each request's reading is then at most its ``queue_wait_ms_p95`` one,
which also holds the generator's lateness (due → ``t_submit``) and the
rest of the admitting step.  None where the program does not stamp its
requests."""

from portbench.harness import stats


def read(run):
    win, waits = run.window, []
    for r in stats.due_in_window(run.recs, win):
        ts = getattr(r.req, "t_submit", None)
        if ts is None:
            continue
        ta = r.req.t_admit
        if ta is None and r.req.done:
            waits.append(0.0)
        else:
            waits.append(max(0.0, (ta if ta is not None and ta <= win.end else win.end) - ts))
    v = stats.percentile(waits, 95)
    return None if v is None else 1e3 * v
