"""The device's idle share inside the render spans only: idle time
between requests is load, not waste."""

from portbench.readers import span_seconds


def read(run):
    spans = run.work.get("render_spans", [])
    total = span_seconds(run)
    if run.trace is None or total <= 0:
        return None
    busy = run.trace.busy_within(spans)
    return 100.0 * (1.0 - busy / total) if busy > 0 else None
