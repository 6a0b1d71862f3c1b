"""Progress/log plumbing.

Copy of ``pointcloudhookup_tpu/utils/logging.py``'s ``Reporter``, the
``progress_callback(int 0-100)`` / ``log_callback(str)`` pair threaded
through the pipeline functions.  The JAX package's ``StageTracer`` has no
copy here: the port's phases are timed by ``utils/trace.py``.
"""

from __future__ import annotations

from typing import Callable, Optional


class Reporter:
    """Bundles a (progress_callback, log_callback) pair."""

    def __init__(
        self,
        progress_callback: Optional[Callable[[int], None]] = None,
        log_callback: Optional[Callable[[str], None]] = None,
        echo: bool = False,
    ):
        self._progress = progress_callback
        self._log = log_callback
        self._echo = echo

    def log(self, msg: str) -> None:
        if self._log:
            self._log(msg)
        elif self._echo:
            print(msg)

    def progress(self, value: int) -> None:
        if self._progress:
            self._progress(int(value))

    def sub(self, lo: int, hi: int) -> "Reporter":
        """A reporter that maps [0,100] progress into [lo,hi]."""
        parent = self

        def scaled(v: int) -> None:
            parent.progress(lo + (hi - lo) * v // 100)

        return Reporter(scaled if self._progress else None, self._log, self._echo)

