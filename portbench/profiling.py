"""Readers of a ``torch.profiler`` trace of the measured window.

Frozen for the benchmark from ``chip_smoke.py``'s ``profile_iteration``
(:286-311: device-side events only, busy time and the top kernels by
name), extended to the window's Chrome trace so that device time can be
attributed to the host ranges the spans open (``spans.py``):

* device activity: events of category ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``; busy time is the union of their intervals inside the
  ``pb:window`` range;
* a range's device time: the activity whose launch (a ``cuda_runtime`` or
  ``cuda_driver`` event with the same ``correlation``) lies inside the
  range on the range's own thread;
* idle gaps: the holes between the merged device intervals, each
  labelled with the innermost ``pb:`` span open on each host thread at the
  gap's middle.

The profiler puts host and device timestamps on one clock (microseconds).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "pb:window"


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and parameter list, at most
    width characters."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    head = name.split("(")[0].strip()
    return (head or name)[:width]


class Trace:
    def __init__(self, events: list):
        self.device = []  # (ts, end, name, correlation)
        self.launch = defaultdict(list)  # tid -> sorted [(ts, correlation)]
        self.ranges = []  # (name, tid, ts, end)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", ""), corr))
            elif cat in LAUNCH_CATS and corr is not None:
                self.launch[e.get("tid")].append((ts, corr))
            elif cat == "user_annotation":
                self.ranges.append((e.get("name", ""), e.get("tid"), ts, ts + dur))
        for v in self.launch.values():
            v.sort()
        self.device.sort()
        self.by_corr = defaultdict(float)
        for ts, end, _, corr in self.device:
            if corr is not None:
                self.by_corr[corr] += end - ts
        win = [r for r in self.ranges if r[0] == WINDOW]
        if not win:
            raise ValueError("the trace holds no pb:window range")
        _, self.main_tid, self.t0, self.t1 = win[0]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def _merged(self):
        """Merged device-activity intervals clipped to the window (us)."""
        out = []
        for ts, end, _, _ in self.device:
            ts, end = max(ts, self.t0), min(end, self.t1)
            if end <= ts:
                continue
            if out and ts <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([ts, end])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged()) / 1e6

    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def device_s_inside(self, name: str) -> float:
        """Device seconds of the activity launched inside every range called
        name, on the range's thread (nested ranges of one name count once)."""
        total = 0.0
        seen = set()
        for rname, tid, ts, end in self.ranges:
            if rname != name:
                continue
            launches = self.launch.get(tid, [])
            i = bisect.bisect_left(launches, (ts, -1))
            while i < len(launches) and launches[i][0] <= end:
                corr = launches[i][1]
                if corr not in seen:
                    seen.add(corr)
                    total += self.by_corr.get(corr, 0.0)
                i += 1
        return total / 1e6

    def top_ops(self, n: int = 10) -> list:
        """[[kernel name, device seconds]] of the n names that took most."""
        per = defaultdict(float)
        for ts, end, name, _ in self.device:
            if end > self.t0 and ts < self.t1:
                per[short_name(name)] += (min(end, self.t1) - max(ts, self.t0)) / 1e6
        return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]

    def _open_spans(self, t: float) -> str:
        """The innermost pb: span open at host time t on each thread, the
        window's thread first."""
        inner = {}
        for name, tid, ts, end in self.ranges:
            if name.startswith("pb:") and name != WINDOW and ts <= t < end:
                if tid not in inner or ts > inner[tid][0]:
                    inner[tid] = (ts, name[3:])
        tids = sorted(inner, key=lambda k: (k != self.main_tid, str(k)))
        return " + ".join(inner[k][1] for k in tids) or "harness"

    def idle_gaps(self, n: int = 10) -> list:
        """[[label, seconds]] of the n longest holes in device activity
        inside the window, each labelled with the spans open at its middle."""
        merged = self._merged()
        edges = [self.t0] + [x for iv in merged for x in iv] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], (edges[i] + edges[i + 1]) / 2)
                for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: -g[0])
        return [[self._open_spans(t), d / 1e6] for d, t in gaps[:n]]
