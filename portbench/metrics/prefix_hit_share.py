"""Share, in %, of the prompt tokens admitted in the window that were served from
shared KV pages (layer: ``serving/kv_pool.py``): the pool's reused pages
over the window times the page size, over the admitted prompts' tokens."""


def read(run):
    a, b = run.pool_at_start, run.pool_at_end
    if not a or not b or not b["page_tokens"]:
        return None
    admitted = sum(len(r.planned.prompt) for r in run.recs
                   if r.admitted is not None and run.window.start <= r.admitted <= run.window.last)
    if not admitted:
        return None
    return 100.0 * (b["reused_pages"] - a["reused_pages"]) * b["page_tokens"] / admitted
