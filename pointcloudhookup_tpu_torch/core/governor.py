"""Resource governor: host-RAM- and device-memory-aware chunk capacities.

Counterpart of ``pointcloudhookup_tpu/core/governor.py``.  The reference
sizes work to the machine instead of running out of memory on big tiles:
a chunk size from the available RAM (500k/1M/2M points for 4/8/16 GB) and
a cap on the share of memory a run may take.  Sized here:

  host   - the tile streamer's staging per point and prefetch slot
           (``core/streaming.py``): the float64 decode (24 B), then on the
           u16 wire a float64 quantisation temporary (24 B) and the pinned
           u16 upload buffer (6 B); the f32 wire takes the pinned float32
           buffer and mask (13 B) instead of the last two;
  device - the peak of ``torch.cuda.max_memory_allocated`` over one fused
           ``fast`` step and one modular step on a 4,194,304-point tile,
           per point of capacity: 269.5 B on an H100 (the modular step
           sets it; the fused step takes 61 B), plus 50 B (~19 %) of
           headroom (``chip_smoke.py`` phase 10 measures it and fails
           above this constant),
           against the memory this process can allocate on the card
           (``torch.cuda.mem_get_info`` plus what its caching allocator
           holds) times a safety fraction.

Capacities snap DOWN onto a power-of-two ladder, so repeated runs see the
same shapes.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import torch

# bytes per point of capacity (see the module docstring)
HOST_BYTES_PER_POINT = 54
DEVICE_BYTES_PER_POINT = 320

_CPU_MEMORY = 8 << 30  # the device budget of a run on the CPU

_LADDER = [1 << s for s in range(14, 27)]  # 16k .. 64M points


@dataclasses.dataclass
class ResourceBudget:
    host_available: int  # bytes
    device_budget: int  # bytes
    capacity: int  # points per device chunk
    chunk_size: int  # points per host processing chunk
    reason: str


def host_available_bytes() -> int:
    """MemAvailable from /proc/meminfo (psutil where that is missing)."""
    try:
        with open("/proc/meminfo") as f:
            m = re.search(r"MemAvailable:\s+(\d+) kB", f.read())
        if m:
            return int(m.group(1)) * 1024
    except OSError:
        pass
    try:
        import psutil

        return int(psutil.virtual_memory().available)
    except Exception:
        return 4 << 30  # the reference's smallest RAM class


def device_memory_bytes(device="cuda") -> int:
    """Memory a run on ``device`` can use: on a CUDA device what is free
    plus what this process's caching allocator already holds; on the CPU a
    fixed 8 GiB."""
    device = torch.device(device)
    if device.type == "cpu":
        return _CPU_MEMORY
    free, _total = torch.cuda.mem_get_info(device)
    return int(free + torch.cuda.memory_reserved(device))


def _snap_down(n: int) -> int:
    best = _LADDER[0]
    for v in _LADDER:
        if v <= n:
            best = v
    return best


def auto_capacity(
    *,
    device="cuda",
    max_memory_percent: float = 30.0,
    device_memory_fraction: float = 0.6,
    prefetch: int = 1,
    hard_cap: Optional[int] = None,
    n_points: Optional[int] = None,
) -> int:
    """Points per device chunk sized to both host staging RAM and device
    memory.

    max_memory_percent: the share of available host RAM the staging
    buffers may hold; device_memory_fraction leaves headroom beyond the
    measured per-point peak; hard_cap is an explicit ceiling; n_points,
    when known, avoids over-allocating for small inputs.
    """
    host_budget = int(host_available_bytes() * max_memory_percent / 100.0)
    host_cap = host_budget // (HOST_BYTES_PER_POINT * max(prefetch + 1, 2))
    dev_budget = int(device_memory_bytes(device) * device_memory_fraction)
    dev_cap = dev_budget // DEVICE_BYTES_PER_POINT
    cap = min(host_cap, dev_cap)
    if hard_cap is not None:
        cap = min(cap, hard_cap)
    cap = max(cap, _LADDER[0])
    cap = _snap_down(cap)
    if n_points is not None and n_points > 0:
        # the smallest rung that holds the whole input in one chunk, but
        # never beyond the memory-derived cap
        for v in _LADDER:
            if v >= n_points:
                return min(v, cap)
    return cap


def auto_chunk_size(*, max_memory_percent: float = 30.0) -> int:
    """Host-side processing chunk following the reference's RAM ladder
    (500k/1M/2M points for 4/8/16 GB), scaled by the same budget."""
    avail_gb = host_available_bytes() / (1 << 30)
    if avail_gb >= 16:
        base = 2_000_000
    elif avail_gb >= 8:
        base = 1_000_000
    else:
        base = 500_000
    # very large hosts scale past the reference's table linearly, capped at
    # 16M points per chunk to bound one chunk's latency
    if avail_gb > 32:
        base = min(int(base * avail_gb / 16.0), 16_000_000)
    return int(base * min(max_memory_percent, 100.0) / 30.0)


def budget(
    *,
    device="cuda",
    max_memory_percent: float = 30.0,
    prefetch: int = 1,
    hard_cap: Optional[int] = None,
    n_points: Optional[int] = None,
) -> ResourceBudget:
    host = host_available_bytes()
    dev = device_memory_bytes(device)
    cap = auto_capacity(
        device=device,
        max_memory_percent=max_memory_percent,
        prefetch=prefetch,
        hard_cap=hard_cap,
        n_points=n_points,
    )
    chunk = auto_chunk_size(max_memory_percent=max_memory_percent)
    return ResourceBudget(
        host_available=host,
        device_budget=dev,
        capacity=cap,
        chunk_size=chunk,
        reason=(
            f"host {host / (1 << 30):.1f} GiB avail @ {max_memory_percent:.0f}%"
            f", device {dev / (1 << 30):.1f} GiB -> capacity {cap:,}"
            f", chunk {chunk:,}"
        ),
    )


def estimate_points(las_path: str) -> Optional[int]:
    """Point count from the LAS header (no decode); the file size over 28
    bytes a point where the header cannot be read."""
    try:
        from pointcloudhookup_tpu_torch.io.las import peek_point_count

        return peek_point_count(las_path)
    except Exception:
        try:
            return max(os.path.getsize(las_path) // 28, 1)
        except OSError:
            return None
