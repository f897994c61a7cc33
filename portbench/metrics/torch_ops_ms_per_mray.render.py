"""Device ms a million rays of every operation but K3: the renderer's
plain-PyTorch passes (models, rendering, sampling, the renderer)."""

from portbench.readers import other


def read(run):
    rays = run.work.get("rays")
    if run.trace is None or not rays:
        return None
    t = run.trace.device_s(other)
    return 1e3 * t / (rays / 1e6) if t > 0 else None
