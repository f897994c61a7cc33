"""K2's share of its roofline: the bound of one launch over the batch's
samples (``counts/k1k2.py``) times the window's K2 launches
(``k2.launches``, one a step) over the device time under the
``k2.launch`` spans."""

from portbench.readers import launch_roofline

SPANS = True       # reads the program's spans: on in this cell's traced runs


def read(run):
    return launch_roofline(run, "k2")
