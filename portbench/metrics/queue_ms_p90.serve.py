"""p90 over the window's requests of the latency less the request's own
render span: time spent queued for the render lock and in HTTP."""

from portbench.readers import p90


def read(run):
    q = run.work.get("queue_s", [])
    if run.trace is None or not q:
        return None
    return 1e3 * p90(q)
