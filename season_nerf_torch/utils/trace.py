"""Spans and counters inside the port, on ``time.perf_counter``'s clock.

A span names one layer boundary's work::

    with trace.span("render.chunk"):
        ...

Off (the default), ``span`` checks one module flag and returns a shared
no-op context: no clock read, no allocation, no profiler call.  It is off
too while ``torch.compile`` or ``torch.export`` traces the code.  On
(:func:`enable`), each span keeps a :class:`Span` in memory, with its
parent (the span open on the same thread when it began) and its request
(the id of the nearest enclosing span opened with ``request=True``,
inherited by every span beneath it on that thread) and its thread's
native id, and opens
``torch.profiler.record_function(name)``, so that a profiled run carries
the same names.  :func:`drain` returns the kept spans and forgets them.

The kernels' launch counters live here too, and count always, whether
or not spans are on: ``ops/cuda_build``'s binder adds each launch to its
counter (:func:`count`) and :func:`counters` reads them all.
:data:`COUNTERS` names them.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

_on = False
_NULL = contextlib.nullcontext()
_spans: List["Span"] = []
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()

COUNTERS = {
    "k3.launches": "K3, the inference trunk (ops/fused_trunk)",
    "k1.launches": "K1, the fused training trunk's forward (ops/fused_train)",
    "k2.launches": "K2, its backward (ops/fused_train)",
    "fast_sine.launches": "the polynomial sine's kernel, both directions, "
                          "the training BatchNorm's folded launches among "
                          "them (ops/fast_math, ops/batchnorm_train)",
    "batchnorm.launches": "a training BatchNorm's column-sum pass forward "
                          "(span siren.batchnorm) and its dz pass backward "
                          "(siren.batchnorm_bwd), not a mesh's finish "
                          "(ops/batchnorm_train)",
}
_counts = dict.fromkeys(COUNTERS, 0)


class Span(NamedTuple):
    name: str
    start: float            # time.perf_counter() seconds
    end: float
    id: int
    parent: Optional[int]   # the enclosing span on the same thread
    request: Optional[int]  # the enclosing request span's id
    thread: int             # threading.get_native_id()


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def drain() -> List[Span]:
    """The spans ended since the last drain, in the order they ended."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return out


def span(name: str, request: bool = False):
    """A context that records ``name`` while spans are on.  ``request``
    starts a request: the span's id becomes the request id of every span
    beneath it on this thread."""
    if not _on:
        return _NULL
    if torch.compiler.is_compiling():
        return _NULL
    return _Open(name, request)


class _Open:
    __slots__ = ("name", "request", "id", "parent", "req", "start", "rf")

    def __init__(self, name: str, request: bool):
        self.name, self.request = name, request

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent, req = stack[-1] if stack else (None, None)
        self.req = self.id if self.request else req
        stack.append((self.id, self.req))
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        self.rf.__exit__(*exc)
        _local.stack.pop()
        rec = Span(self.name, self.start, end, self.id, self.parent,
                   self.req, threading.get_native_id())
        with _lock:
            _spans.append(rec)
        return False


def count(name: str, n: int = 1):
    """Add ``n`` launches to the counter ``name`` (one of :data:`COUNTERS`;
    frames in flight on threads launch too)."""
    with _lock:
        _counts[name] += n


def counters() -> Dict[str, int]:
    """The kernels' launches since the process started, by name."""
    with _lock:
        return dict(_counts)
