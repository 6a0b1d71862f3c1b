"""The port's tracer: named spans around the phases of its paths, and
counters of the work they do.

``span(name)`` is a context manager.  While the tracer is inactive it
returns one shared no-op context after a single flag check and records
nothing.  While it is active each span records its name, its start and end
on ``time.perf_counter_ns``, the CPU nanoseconds its thread spent inside
it (``time.thread_time_ns``), the OS thread id (``threading.get_native_id``,
the ``tid`` of a ``torch.profiler`` trace), the id of the span it opened
in, and a request id: a span opened with no open parent starts a request,
and the spans opened inside it inherit its id through a ``contextvars``
variable (a thread that should carry them runs in
``contextvars.copy_context()``).  Where a profiler is recording on the
current thread, the span also opens ``record_function("pc:" + name)``, so
the trace attributes device time to it.

``count(name, n)`` always adds n to a process-wide total, read by
``counter(name)``; while the tracer is active it also adds n to the
``counts`` of the innermost open span.

The tracer is active while a ``torch.profiler`` runs in the process (in
every thread, including those the program starts), or between
``enable()`` and ``disable()``.  Finished spans go to a buffer in memory
that keeps the last ``CAPACITY``: ``spans()`` reads it, ``reset()``
empties it.  Nothing is written anywhere.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 16  # finished spans kept; the oldest go first

_enabled = False
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_totals: dict = collections.defaultdict(int)
_totals_lock = threading.Lock()
_current: contextvars.ContextVar = contextvars.ContextVar("pc_trace_span", default=None)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


class Span:
    """One finished (or open) span; ``counts`` holds what ``count`` added
    while it was the innermost open span (None if nothing)."""

    __slots__ = ("name", "id", "parent", "request", "tid", "t0_ns", "t1_ns", "cpu_ns",
                 "counts", "_token", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        parent = _current.get()
        self.id = next(_span_ids)
        if parent is None:
            self.parent, self.request = None, next(_request_ids)
        else:
            self.parent, self.request = parent.id, parent.request
        self.tid = threading.get_native_id()
        self.counts = None
        self._token = _current.set(self)
        self._range = None
        if torch._C._autograd._profiler_enabled():
            self._range = _profiler.record_function("pc:" + self.name)
            self._range.__enter__()
        self.cpu_ns = time.thread_time_ns()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.perf_counter_ns()
        self.cpu_ns = time.thread_time_ns() - self.cpu_ns
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _current.reset(self._token)
        self._token = None
        _buffer.append(self)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def active() -> bool:
    """Whether spans record: after enable(), or while a torch profiler runs
    anywhere in the process (``torch._C._autograd._profiler_enabled`` is
    per thread; the module flag below is not)."""
    return _enabled or getattr(_profiler, "_is_profiler_enabled", False)


def span(name: str):
    """A context that records a span called ``name`` while the tracer is
    active; the shared no-op context otherwise."""
    return Span(name) if active() else _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add n to the process-wide total ``name`` and, while the tracer is
    active, to the innermost open span's counts."""
    with _totals_lock:
        _totals[name] += n
    if active():
        s = _current.get()
        if s is not None:
            if s.counts is None:
                s.counts = {}
            s.counts[name] = s.counts.get(name, 0) + n


def counter(name: str) -> int:
    """The process-wide total of ``name`` (0 if never counted)."""
    with _totals_lock:
        return _totals.get(name, 0)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def spans() -> list:
    """The finished spans in the buffer, in the order they finished."""
    return list(_buffer)


def reset() -> None:
    """Empty the span buffer (the counters' totals stay)."""
    _buffer.clear()
