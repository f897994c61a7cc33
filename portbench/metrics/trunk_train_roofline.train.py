"""K1 twice and K2 once a step: the bound of the window's launches
(``counts/k1k2.py``) over the device time of the ``tt::`` kernels."""

from portbench.counts import k1k2
from portbench.readers import K12_MARKS, named


def read(run):
    steps = run.work.get("steps")
    if run.trace is None or not steps:
        return None
    t = run.trace.device_s(named(K12_MARKS))
    if t <= 0:
        return None
    return 100.0 * steps * k1k2.step_bound_s(run.config) / t
