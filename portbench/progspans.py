"""The program's own spans in the measured window, on the trace's clock.

The program keeps its spans and counters in memory
(``pointcloudhookup_tpu_torch/utils/trace.py``): each finished span has a
``name``, ``id``, ``parent``, ``request``, OS thread ``tid``, ``t0_ns`` and
``t1_ns`` on ``time.perf_counter_ns``, ``cpu_ns`` (its thread's CPU time
inside it) and ``counts`` (what ``trace.count`` added while it was the
innermost open span).  Its tracer records while a torch profiler runs, so a
traced run (``--trace 1``) fills the buffer with no switch of its own; an
untraced run and a program without a tracer leave nothing, and every
reader then returns None.

This module keeps the spans that start inside the harness's ``window``
span and places them on the trace's clock with one anchor: the
``pb:window`` range's ``ts`` (``window.trace.t0``, microseconds) minus the
window span's ``perf_counter`` start.  From them it gives

* self time by name: a span's wall less the walls of its children on its
  own thread (the producer thread's spans are children of ``stream`` but
  run beside it);
* counts by name, summed over the spans (each count lands on one span);
* the device's idle time inside the window (the holes between the
  trace's merged device intervals) covered by each leaf span (a span with
  no children) on any thread, the part of it when that leaf is the only
  one open, and the part with at least one leaf open;
* the leaves' time off the CPU: wall less thread CPU time, the time a
  thread was runnable but waited (the interpreter lock, the scheduler, I/O)
  or blocked.  Spans named ``*.wait`` exist to block (the consumer's queue
  wait) and are left out of that share.
"""

from __future__ import annotations

import importlib
from collections import defaultdict

PROGRAM_TRACE = "pointcloudhookup_tpu_torch.utils.trace"
WAIT = ".wait"
_CACHE = "_program_spans"


def program_buffer():
    """The program's finished spans, or None where it has no tracer."""
    try:
        mod = importlib.import_module(PROGRAM_TRACE)
    except ImportError:
        return None
    return mod.spans()


class ProgramSpans:
    """The program's spans of one window (``records``: the buffer; the
    window's bounds in perf_counter seconds; ``anchor_us``: trace clock
    minus perf_counter, in microseconds; ``busy``: the merged device
    intervals inside the window on the trace's clock)."""

    def __init__(self, records, window_s: tuple, anchor_us: float, busy: list):
        lo, hi = (int(t * 1e9) for t in window_s)
        self.spans = [s for s in records if lo <= s.t0_ns <= hi]
        self.anchor_us = anchor_us
        self.window_us = tuple(t * 1e6 + anchor_us for t in window_s)
        self.busy = busy
        parents = {s.parent for s in self.spans}
        self.leaves = [s for s in self.spans if s.id not in parents]
        self.names = {s.name for s in self.spans}
        self._idle = None

    def self_ms(self, name: str) -> float:
        """Wall of every span called name, less its same-thread children's."""
        ids = {s.id: s for s in self.spans if s.name == name}
        wall = sum(s.t1_ns - s.t0_ns for s in ids.values())
        inner = sum(c.t1_ns - c.t0_ns for c in self.spans
                    if c.parent in ids and c.tid == ids[c.parent].tid)
        return (wall - inner) / 1e6

    def count(self, name: str, prefix: bool = False) -> int | None:
        """The counts of name (of every name that starts with it, if prefix)
        over the spans; None if no span counted it."""
        total, seen = 0, False
        for s in self.spans:
            for k, v in (s.counts or {}).items():
                if k == name or (prefix and k.startswith(name)):
                    total += v
                    seen = True
        return total if seen else None

    def idle(self) -> dict:
        """Device idle microseconds in the window: 'idle' in all,
        'explained' with a leaf open on some thread and 'by_leaf' (name ->
        covered, on any thread)."""
        if self._idle is not None:
            return self._idle
        w0, w1 = self.window_us
        busy_key = object()
        events = []
        for s in self.leaves:  # on the trace's clock
            events += [(s.t0_ns / 1e3 + self.anchor_us, 1, s.name),
                       (s.t1_ns / 1e3 + self.anchor_us, -1, s.name)]
        for b0, b1 in self.busy:
            events += [(b0, 1, busy_key), (b1, -1, busy_key)]
        events.sort(key=lambda e: (e[0], e[1]))
        depth = defaultdict(int)
        open_names: set = set()
        idle = explained = 0.0
        by_leaf = defaultdict(float)
        prev = w0
        for t, step, key in events + [(w1, 0, None)]:
            a, b = max(prev, w0), min(t, w1)
            if b > a and depth[busy_key] == 0:
                idle += b - a
                if open_names:
                    explained += b - a
                    for n in open_names:
                        by_leaf[n] += b - a
            prev = max(prev, t)
            if key is None:
                continue
            depth[key] += step
            if key is not busy_key:
                if depth[key] > 0:
                    open_names.add(key)
                else:
                    open_names.discard(key)
        self._idle = dict(idle=idle, explained=explained, by_leaf=dict(by_leaf))
        return self._idle

    def offcpu_share(self) -> float | None:
        """Σ (wall − thread CPU) / Σ wall over the leaves, waits left out.
        Summed, not clamped span by span: where the thread CPU clock is
        coarse, a span of a few ms can read more CPU than wall."""
        leaves = [s for s in self.leaves if not s.name.endswith(WAIT)]
        wall = sum(s.t1_ns - s.t0_ns for s in leaves)
        if wall <= 0:
            return None
        return (wall - sum(s.cpu_ns for s in leaves)) / wall


def of(window) -> ProgramSpans | None:
    """The window's program spans (computed once a window), or None: no
    trace, no tracer in the program, or no program span in the window."""
    if hasattr(window, _CACHE):
        return getattr(window, _CACHE)
    found = None
    bounds = (window.spans.get("window") or [None])[0]
    records = program_buffer() if window.trace is not None and bounds else None
    if records:
        anchor_us = window.trace.t0 - bounds[0] * 1e6
        found = ProgramSpans(records, bounds, anchor_us, window.trace._merged())
        if not found.spans:
            found = None
    setattr(window, _CACHE, found)
    return found


def phase_ms(window, name: str) -> float | None:
    """Self ms a tile of the spans called name, or None without them."""
    p = of(window)
    if p is None or name not in p.names:
        return None
    return p.self_ms(name) / window.tiles


def count_per_tile(window, name: str, prefix: bool = False, scale: float = 1.0):
    """A counter's sum over the window's spans a tile, or None."""
    p = of(window)
    n = None if p is None else p.count(name, prefix)
    return None if n is None else n * scale / window.tiles
