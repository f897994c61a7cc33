"""Device ms a step of every operation that is neither K1/K2 nor K3: the
plain-PyTorch passes of the model, rendering, loss and optimiser."""

from portbench.readers import other


def read(run):
    steps = run.work.get("steps")
    if run.trace is None or not steps:
        return None
    t = run.trace.device_s(other)
    return 1e3 * t / steps if t > 0 else None
