"""Spans and kernel-call records, taken from the benchmark's own files.

Nothing is added inside the program: a span is a wrapper around a named
module attribute that the measured window calls into (``module:attr``,
``attr`` may be ``Class.method``), as ``chip_smoke.py``'s ``stage_walls``
(:632-657) and ``recording`` (:338-353) do.  A span's host wall comes from
``time.perf_counter``; in a traced run each span and each kernel-function
call also opens a ``torch.profiler.record_function`` range (``pb:<span>``,
``pbk:<function>``), so the trace reader can give the device time of the
kernels launched inside it.  No wrapper synchronises the device.

The kernel-function wrappers replace every binding of the function in the
program's modules (``from ... import`` copies the binding), as
``chip_smoke.py``'s ``kernel_calls`` (:356-402) does; a call made inside
another recorded call is not recorded twice.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import time
from collections import defaultdict

from portbench import roofline

PROGRAM = "pointcloudhookup_tpu_torch"
SPAN_PREFIX = "pb:"
KERNEL_PREFIX = "pbk:"


def _resolve(target: str):
    """(owner, attribute name, current value) of 'module:attr[.attr]'."""
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *heads, last = path.split(".")
    for h in heads:
        owner = getattr(owner, h)
    return owner, last, getattr(owner, last)


class Recorder:
    """Spans (name -> list of (t0, t1) perf_counter seconds) and the
    kernel-function calls' costs of one window."""

    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.spans: dict[str, list] = defaultdict(list)
        self.kernel_costs: list = []  # (function name, roofline.Cost)
        self._in_kernel = 0

    def _range(self, label: str):
        if not self.tracing:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(label)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with self._range(SPAN_PREFIX + name):
            yield
        self.spans[name].append((t0, time.perf_counter()))

    def _span_wrapper(self, name, fn):
        def call(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return call

    def _kernel_wrapper(self, name, fn):
        def call(*args, **kwargs):
            if self._in_kernel:
                return fn(*args, **kwargs)
            self._in_kernel += 1
            try:
                with self._range(KERNEL_PREFIX + name):
                    out = fn(*args, **kwargs)
            finally:
                self._in_kernel -= 1
            self.kernel_costs.append((name, roofline.cost(name, args, kwargs, out)))
            return out
        return call

    @contextlib.contextmanager
    def wrapped(self, span_targets: dict, kernel_functions: dict):
        """Wrap span_targets (span name -> 'module:attr') and every binding
        of kernel_functions (name -> (module, attr)) while the block runs."""
        saved = []
        try:
            for name, target in span_targets.items():
                owner, attr, fn = _resolve(target)
                saved.append((owner, attr, fn))
                setattr(owner, attr, self._span_wrapper(name, fn))
            originals = {}
            for name, (module, attr) in kernel_functions.items():
                originals[id(getattr(importlib.import_module(module), attr))] = name
            modules = [m for k, m in list(sys.modules.items())
                       if (k == PROGRAM or k.startswith(PROGRAM + ".")) and m is not None]
            for mod in modules:
                for attr, fn in list(vars(mod).items()):
                    name = originals.get(id(fn))
                    if name is not None and callable(fn):
                        saved.append((mod, attr, fn))
                        setattr(mod, attr, self._kernel_wrapper(name, fn))
            yield self
        finally:
            for owner, attr, fn in reversed(saved):
                setattr(owner, attr, fn)
