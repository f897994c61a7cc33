"""The whole training step's share of the card's peak: model operations
of the window's steps (``counts/train_step.py``) over the window's wall
time at the compute dtype's peak."""

from portbench.counts import peaks


def read(run):
    w, c = run.work, run.config
    if run.trace is None or run.trace.busy_s <= 0 or not w.get("steps"):
        return None
    return 100.0 * w["steps"] * w["step_flops"] / (
        w["wall_s"] * peaks.FLOPS[c["compute_dtype"]])
