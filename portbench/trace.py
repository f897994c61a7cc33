"""The traced window: ``torch.profiler`` around it, the device's operations
read back from the profiler's trace on the host's clock, each laid under
the program span that launched it.

Two kinds of host span share ``time.perf_counter``'s clock.  The
benchmark's own (:class:`Spans`) are kept as ``(name, start, end)`` around
its calls into the program.  The program's (``season_nerf_torch.utils.
trace``'s ``Span``: name, start, end, id, parent, request, thread) mark
its layer boundaries; ``run.py`` drains them after a traced window.

Each program span opens a ``record_function`` of its name, so the trace
carries it as an annotation: the median offset between a span's midpoint
and its annotation's ties the profiler's clock to the host's
(:func:`tie`).  A marker recorded at a known host time (``SYNC``) gives
the first guess, and the tie where no program span has an annotation
(tens of microseconds to 1.6 ms off).  A span with its annotation then
takes the annotation's edges (:func:`on_trace_clock`), which the profiler
stamps on the launches' own clock.

Each device operation keeps its correlation id, which names the runtime
or driver call that launched it, and so the launch's host time and
thread.  The operation lies under the innermost program span open on that
thread at that time; where none is open there, under the deepest one open
on any thread, never ``serve.lock_wait`` (a thread that waits for the
render lock launches nothing).  The server's handler threads carry an id
in the trace that is neither their native nor their pthread id, so their
launches take that second rule.  :meth:`Trace.device_s_under` sums the
device seconds under a span's name, its children's included.

The profiler traces this process only, and each device operation keeps
the card it ran on (the event's ``device`` argument).  Busy time, and
with it the idle shares and the idle gaps, is that of one card, the
run's (``card``; an operation that names no card counts as on it);
device time by name or by span sums every operation this process
launched, on whichever card.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import statistics
import tempfile
import threading
import time
from typing import Callable, List, Optional, Tuple

SYNC = "portbench.sync"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LOCK_WAIT = "serve.lock_wait"
# wider than the SYNC tie's error: a span's annotation lies this near where
# that tie puts the span
NEAR = 4e-3
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


def depths(program) -> dict:
    """Span id -> how many of its ancestors are among ``program``."""
    parent = {s.id: s.parent for s in program}
    out = {}
    for s in program:
        chain, at = [], s.id
        while at in parent and at not in out:
            chain.append(at)
            at = parent[at]
        d = out.get(at, -1)
        for i in reversed(chain):
            d += 1
            out[i] = d
    return out


class Trace:
    """The device operations of a traced window, on the host's clock.

    ``ops`` are ``(name, start, end, correlation, card)``, ``host_ops``
    ``(name, start, end)``, ``launches`` maps a correlation id to the
    launch's ``(host time, thread)``, and ``program`` holds the program's
    spans.  ``union`` is the busy time of ``card`` (of every card where
    None)."""

    def __init__(self, ops, host_ops, start: float, end: float,
                 launches=None, program=(), card=None):
        self.ops = [o for o in ops if o[2] > start and o[1] < end]
        self.host_ops = host_ops
        self.start, self.end = start, end
        self.launches = launches or {}
        self.program = list(program)
        self.depth = depths(self.program)
        self.union = merge((max(o[1], start), min(o[2], end))
                           for o in self.ops
                           if card is None or o[4] in (None, card))
        self._under = None

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
        return sum(o[2] - o[1] for o in self.ops if pick(o[0]))

    def device_s_under(self, name: str) -> float:
        """Summed device seconds of the operations launched under a
        program span called ``name`` (or under one of its children)."""
        if self._under is None:
            self._under = self._attribute()
        return self._under.get(name, 0.0)

    def _attribute(self) -> dict:
        """Device seconds by program span name: one sweep over the spans'
        starts and ends and the operations' launches in time order."""
        spans, out = self.program, {}
        if not spans:
            return out
        by_id = {s.id: s for s in spans}
        events = [(s.start, 0, i) for i, s in enumerate(spans)]
        events += [(s.end, 2, i) for i, s in enumerate(spans)]
        events += [(self.launches[o[3]][0], 1, k)
                   for k, o in enumerate(self.ops) if o[3] in self.launches]
        events.sort()
        open_on = {}            # thread -> indices of its open spans
        for _, what, i in events:
            if what == 0:
                open_on.setdefault(spans[i].thread, set()).add(i)
            elif what == 2:
                here = open_on.get(spans[i].thread, set())
                here.discard(i)
                if not here:
                    open_on.pop(spans[i].thread, None)
            else:
                _, a, b, corr, _ = self.ops[i]
                s = self._launcher(open_on, self.launches[corr][1])
                names = set()
                while s is not None:
                    names.add(s.name)
                    s = by_id.get(s.parent)
                for n in names:
                    out[n] = out.get(n, 0.0) + (b - a)
        return out

    def _launcher(self, open_on: dict, thread):
        """The innermost span open on ``thread``, else the deepest open on
        any thread but a wait for the render lock."""
        spans, depth = self.program, self.depth
        key = lambda i: (depth[spans[i].id], spans[i].start)
        mine = open_on.get(thread)
        if mine:
            return spans[max(mine, key=key)]
        rest = [i for here in open_on.values() for i in here
                if spans[i].name != LOCK_WAIT]
        return spans[max(rest, key=key)] if rest else None

    def busy_within(self, spans) -> float:
        """Device busy seconds inside the host ``spans``."""
        return sum(covered(self.union, a, b) for a, b in spans)

    def breakdown(self, spans: Spans) -> dict:
        by_name = {}
        for n, a, b, *_ in self.ops:
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
        that overlaps it most, the deepest program span that covers at
        least half of it, and the host operation (of a profiled thread)
        that overlaps it most."""
        def most(items, none):
            best, name = 0.0, none
            for n, a, b in items:
                o = min(b, hi) - max(a, lo)
                if o > best and n != SYNC:
                    best, name = o, n
            return name
        best, prog = None, "no program span"
        for s in self.program:
            o = min(s.end, hi) - max(s.start, lo)
            if o > 0 and o >= 0.5 * (hi - lo) and (
                    best is None or (self.depth[s.id], o) > best):
                best, prog = (self.depth[s.id], o), s.name
        return (f"{most(spans.items, 'no span')} / {prog} / "
                f"{most(self.host_ops, 'no host op')}")[:160]


@contextlib.contextmanager
def traced(enabled: bool, holder: dict):
    """Run the block under ``torch.profiler`` when ``enabled``; afterwards
    ``holder["read"](start, end, program, card)`` gives the :class:`Trace`
    of a host interval inside the block, with the program's spans
    ``program``, busy on ``card``."""
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
    holder["read"] = lambda a, b, program=None, card=None: read_events(
        events, (t0 + t1) / 2, a, b, program, card)


def tie(notes, program, base: float) -> float:
    """The profiler's clock less the host's, from a first guess ``base``:
    the median over the program's spans that have one annotation of their
    name (``notes``: ``(name, start, end, thread)`` in profiler seconds)
    within ``NEAR`` of where ``base`` puts them, of the annotation's
    midpoint less the span's; ``base`` where none has.  Midpoints, since
    a span's own edges lie inside its annotation's by the cost of opening
    and of closing the ``record_function``."""
    by_name = {}
    for name, a, b, *_ in notes:
        by_name.setdefault(name, []).append((a, b))
    for ab in by_name.values():
        ab.sort()
    offsets = []
    for s in program:
        ab = by_name.get(s.name, [])
        lo = bisect.bisect_left(ab, (s.start + base - NEAR,))
        if bisect.bisect_left(ab, (s.start + base + NEAR,)) - lo == 1:
            a, b = ab[lo]
            offsets.append((a + b - s.start - s.end) / 2)
    return statistics.median(offsets) if offsets else base


def on_trace_clock(program, notes, base: float):
    """The program's spans with their annotations' edges, less ``base``,
    in place of their own, where the trace holds one annotation for each
    span of a name and thread, in the same order, each within ``NEAR`` of
    its span; the other spans keep their own edges.  The profiler stamps
    an annotation and the launches inside it on one clock, so a launch
    made in the span's block lies inside its annotation whatever the tie's
    error; the span's own edges are taken inside the block and a launch
    just before it closes can fall beyond them."""
    spans, ann = {}, {}
    for i, s in enumerate(program):
        spans.setdefault((s.name, s.thread), []).append(i)
    for name, a, b, thread in notes:
        ann.setdefault((name, thread), []).append((a, b))
    out = list(program)
    for key, idx in spans.items():
        edges = sorted(ann.get(key, []))
        idx.sort(key=lambda i: program[i].start)
        if len(edges) != len(idx) or any(
                abs(a - base - program[i].start) > NEAR
                for i, (a, _) in zip(idx, edges)):
            continue
        for i, (a, b) in zip(idx, edges):
            out[i] = program[i]._replace(start=a - base, end=b - base)
    return out


def read_events(events, sync_host: float, start: float, end: float,
                program=None, card=None) -> Optional[Trace]:
    """A :class:`Trace` of ``[start, end)`` (host seconds) from chrome-trace
    events whose ``SYNC`` marker happened at ``sync_host``, with the
    program's spans ``program``, which also tie the clocks and take their
    annotations' edges (:func:`on_trace_clock`), and busy on ``card``."""
    marks = [e for e in events if e.get("name") == SYNC and "ts" in e]
    if not marks:
        return None
    program = list(program or [])
    names = {s.name for s in program}
    notes = [(e["name"], e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6,
              e.get("tid")) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in names]
    base = tie(notes, program, marks[0]["ts"] * 1e-6 - sync_host)
    program = on_trace_clock(program, notes, base)
    at = lambda us: us * 1e-6 - base
    args = lambda e: e.get("args") or {}
    ops = [(e["name"], at(e["ts"]), at(e["ts"] + e["dur"]),
            args(e).get("correlation"), args(e).get("device"))
           for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    host = [(e["name"], at(e["ts"]), at(e["ts"] + e["dur"])) for e in events
            if e.get("cat") in HOST_CATS and "dur" in e
            and e["name"] not in names]
    launches = {args(e)["correlation"]: (at(e["ts"]), e.get("tid"))
                for e in events if e.get("cat") in LAUNCH_CATS
                and "correlation" in args(e)}
    return Trace(ops, host, start, end, launches, program, card)
