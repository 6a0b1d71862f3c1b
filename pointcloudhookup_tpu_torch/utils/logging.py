"""Progress/log plumbing and stage tracing.

Copy of ``pointcloudhookup_tpu/utils/logging.py``: ``Reporter``, the
``progress_callback(int 0-100)`` / ``log_callback(str)`` pair threaded
through the pipeline functions, and ``StageTracer``, wall time and RSS by
named stage.
"""

from __future__ import annotations

import contextlib
import os
import time
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


def _rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


class StageTracer:
    """Per-stage wall-clock + RSS tracing."""

    def __init__(self, track_rss: bool = True):
        self.stages: list[dict] = []
        self.track_rss = track_rss

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        r0 = _rss_bytes() if self.track_rss else None
        try:
            yield
        finally:
            entry = dict(name=name, wall_s=time.perf_counter() - t0)
            if self.track_rss:
                r1 = _rss_bytes()
                if r0 is not None and r1 is not None:
                    entry["rss_mb"] = r1 / 1e6
                    entry["rss_delta_mb"] = (r1 - r0) / 1e6
            self.stages.append(entry)

    def summary(self) -> str:
        lines = []
        for s in self.stages:
            rss = f"  rss={s['rss_mb']:.0f}MB" if "rss_mb" in s else ""
            lines.append(f"{s['name']}: {s['wall_s']:.3f}s{rss}")
        return "\n".join(lines)

    def total_wall(self) -> float:
        return sum(s["wall_s"] for s in self.stages)
