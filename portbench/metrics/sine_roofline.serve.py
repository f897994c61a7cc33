"""The sine kernel's share of its roofline over the frames served in the
window: the bound of each launch of their render chunks
(``counts/sine.py``) over the device time of the ``fast_sine_fwd``
kernels; nothing where the window's ``fast_sine.launches`` differ from
the launches reckoned."""

from portbench.counts import sine
from portbench.readers import sine_roofline


def read(run):
    return sine_roofline(run, [launch for rays in run.work.get("frames", [])
                               for launch in sine.frame_launches(
                                   run.config, rays)])
