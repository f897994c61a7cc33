"""What the per-layer readers share: names of the hand-written kernels in
the profiler's trace, and the arithmetic over a run's trace, work, the
program's spans (``run.program_spans``) and its launch counters' deltas
(``run.counts``).  Each reader returns None where its run has nothing for
it to read: a run without a trace, or a port without spans or counters."""

from __future__ import annotations

import numpy as np

from portbench.counts import frame, k1k2, k3, peaks, sine

K3_MARKS = ("trunk_bf16", "trunk_f32")
K12_MARKS = ("tt::",)
SINE_MARKS = ("fast_sine_fwd", "fast_sine_bwd")


def named(marks):
    return lambda n: any(m in n.lower() for m in marks)


def other(n: str) -> bool:
    """Neither K1/K2 nor K3: the plain-PyTorch passes (elementwise,
    copies, cuBLAS, reductions)."""
    return not named(K3_MARKS + K12_MARKS)(n)


def idle_share(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def k3_roofline(run):
    """Sum of each K3 launch's bound over the K3 kernels' device time."""
    tr, c = run.trace, run.config
    if tr is None:
        return None
    t = tr.device_s(named(K3_MARKS))
    if t <= 0 or not run.work.get("frames"):
        return None
    bound = sum(k3.launch_bound_s(c, pts) for rays in run.work["frames"]
                for pts in k3.frame_launches(c, rays))
    return 100.0 * bound / t


def frame_mfu(run, seconds: float):
    """Model operations of the run's frames over ``seconds`` at the
    compute dtype's peak."""
    c = run.config
    if run.trace is None or run.trace.busy_s <= 0 or seconds <= 0 \
            or not run.work.get("frames"):
        return None
    ops = sum(frame.frame_flops(c, rays) for rays in run.work["frames"])
    return 100.0 * ops / (seconds * peaks.FLOPS[c["compute_dtype"]])


def span_seconds(run) -> float:
    return sum(b - a for a, b in run.work.get("render_spans", []))


def p90(values):
    return float(np.percentile(values, 90)) if len(values) else None


def ms_a_step_under(run, span: str):
    """Device ms a step of the operations launched under the program span
    ``span``."""
    steps = run.work.get("steps")
    if run.trace is None or not run.program_spans or not steps:
        return None
    t = run.trace.device_s_under(span)
    return 1e3 * t / steps if t > 0 else None


def launch_roofline(run, k: str):
    """K1's or K2's (``k``) share of its roofline: the bound of a launch
    (``counts/k1k2.py``) times the window's launches (``<k>.launches``)
    over the device time under the ``<k>.launch`` spans."""
    n = (run.counts or {}).get(f"{k}.launches")
    if run.trace is None or not run.program_spans or not n:
        return None
    t = run.trace.device_s_under(f"{k}.launch")
    if t <= 0:
        return None
    bound = k1k2.launch_bounds_s(run.config)[("k1", "k2").index(k)]
    return 100.0 * n * bound / t


def sine_roofline(run, launches):
    """The sine kernel's share of its roofline: the bound of each of
    ``launches`` (``counts/sine.py``: ``(elements, direction)``) over the
    device time of its kernels, provided the window's
    ``fast_sine.launches`` are as many as ``launches``."""
    n = (run.counts or {}).get("fast_sine.launches")
    if run.trace is None or not launches or n != len(launches):
        return None
    t = run.trace.device_s(named(SINE_MARKS))
    if t <= 0:
        return None
    c = run.config
    return 100.0 * sum(sine.launch_bound_s(c, e, d)
                       for e, d in launches) / t
