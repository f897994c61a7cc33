"""The render spans' total (the benchmark's wrapper around the service's
``renderer.render_img``, inside the lock) a million rays rendered."""

from portbench.readers import span_seconds


def read(run):
    rays = run.work.get("rays")
    if run.trace is None or not rays:
        return None
    return 1e3 * span_seconds(run) / (rays / 1e6)
