"""K3's share of its roofline over the window's frames
(``counts/k3.py``, one launch a render chunk)."""

from portbench.readers import k3_roofline


def read(run):
    return k3_roofline(run)
