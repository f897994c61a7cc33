"""The sine kernel's share of its roofline over the window's steps: the
bound of each launch of a step (``counts/sine.py``) times the steps, over
the device time of the ``fast_sine_fwd``/``fast_sine_bwd`` kernels;
nothing where the window's ``fast_sine.launches`` differ from the
launches reckoned."""

from portbench.counts import sine
from portbench.readers import sine_roofline


def read(run):
    steps = run.work.get("steps") or 0
    return sine_roofline(run, sine.step_launches(run.config) * steps)
