"""The whole frame's share of the card's peak: model operations of the
frames served in the window (``counts/frame.py``) over the time their
renders took (the render spans), since idle time between requests is
load, not the frame's."""

from portbench.readers import frame_mfu, span_seconds


def read(run):
    return frame_mfu(run, span_seconds(run))
