"""The whole frame's share of the card's peak: model operations of the
window's frames (``counts/frame.py``) over the window's wall time."""

from portbench.readers import frame_mfu


def read(run):
    return frame_mfu(run, run.work.get("wall_s", 0.0))
