"""The traced window: ``torch.profiler`` around it, the device's operations
read back from the profiler's trace on the host's clock.

Host spans (the benchmark's own, around its calls into the program) are
kept as ``(name, start, end)`` in ``time.perf_counter`` seconds.  One
marker recorded through the profiler at a known host time ties the
trace's clock to the host's, so spans and device operations can be laid
side by side.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Callable, List, Optional, Tuple

SYNC = "portbench.sync"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


class Spans:
    """Host spans, recorded from any thread."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.items.append((name, t0, t1))


def merge(intervals):
    """Sorted, non-overlapping union of ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(union, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi)`` that the merged ``union`` covers."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union)


class Trace:
    """The device operations of a traced window, on the host's clock."""

    def __init__(self, ops, host_ops, start: float, end: float):
        self.ops = [o for o in ops if o[2] > start and o[1] < end]
        self.host_ops = host_ops
        self.start, self.end = start, end
        self.union = merge((max(a, start), min(b, end))
                           for _, a, b in self.ops)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return covered(self.union, self.start, self.end)

    def device_s(self, pick: Callable[[str], bool] = lambda n: True
                 ) -> float:
        """Summed device seconds of the operations whose name ``pick``
        takes."""
        return sum(b - a for n, a, b in self.ops if pick(n))

    def busy_within(self, spans) -> float:
        """Device busy seconds inside the host ``spans``."""
        return sum(covered(self.union, a, b) for a, b in spans)

    def breakdown(self, spans: Spans) -> dict:
        by_name = {}
        for n, a, b in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        edges = [self.start] + [x for ab in self.union for x in ab] + \
            [self.end]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[self._host_at(t0, t0 + g, spans), g]
                              for g, t0 in gaps]}

    def _host_at(self, lo: float, hi: float, spans: Spans) -> str:
        """What the host was doing over ``[lo, hi)``: the benchmark span
        and the host operation (of the profiled thread) that overlap it
        most."""
        def most(items, none):
            best, name = 0.0, none
            for n, a, b in items:
                o = min(b, hi) - max(a, lo)
                if o > best and n != SYNC:
                    best, name = o, n
            return name
        return (f"{most(spans.items, 'no span')} / "
                f"{most(self.host_ops, 'no host op')}")[:160]


@contextlib.contextmanager
def traced(enabled: bool, holder: dict):
    """Run the block under ``torch.profiler`` when ``enabled``; afterwards
    ``holder["read"](start, end)`` gives the :class:`Trace` of a host
    interval inside the block."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        with record_function(SYNC):
            pass
        t1 = time.perf_counter()
        yield
        sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    holder["read"] = lambda a, b: read_events(events, (t0 + t1) / 2, a, b)


def read_events(events, sync_host: float, start: float, end: float
                ) -> Optional[Trace]:
    """A :class:`Trace` of ``[start, end)`` (host seconds) from chrome-trace
    events whose ``SYNC`` marker happened at ``sync_host``."""
    marks = [e for e in events if e.get("name") == SYNC and "ts" in e]
    if not marks:
        return None
    base = marks[0]["ts"] * 1e-6 - sync_host
    span = lambda e: (e["ts"] * 1e-6 - base,
                      (e["ts"] + e.get("dur", 0)) * 1e-6 - base)
    ops = [(e["name"], *span(e)) for e in events
           if e.get("cat") in DEVICE_CATS and "dur" in e]
    host = [(e["name"], *span(e)) for e in events
            if e.get("cat") in HOST_CATS and "dur" in e]
    return Trace(ops, host, start, end)
