"""Order-preserving stream compaction of int32 channels by a keep mask.

Counterpart of ``pointcloudhookup_tpu/ops/pallas/compactrows.py::
compact_rows_multi`` and of its Morton wrapper ``compact_rows``.  The CUDA
kernel is ``csrc/compactrows.cu``; the plain PyTorch version below is what
CPU tensors take and what the kernel is held against on the card.  Unlike
the TPU kernel there is no alignment rule on N or the capacity.
"""

from __future__ import annotations

import ctypes

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build
from pointcloudhookup_tpu_torch.ops.morton import SENTINEL_HI

launches = 0  # kernel launches in this process (read and reset by chip_smoke.py)


def compact_rows_multi(keep, channels, capacity: int):
    """Compact rows where ``keep`` into fixed [capacity] buffers.

    keep bool[N]; channels: tuple of int32[N] (view other 32-bit dtypes
    as int32 outside).  Returns (tuple of int32[capacity], count): rows
    [0, min(count, capacity)) hold the kept rows in input order, the rest
    zeros.  count is a 0-d int32 tensor holding the TRUE number of kept
    rows; count > capacity means the tail was dropped."""
    if keep.device.type == "cpu":
        return compact_rows_multi_plain(keep, channels, capacity)
    global launches
    n = keep.shape[0]
    build.require_cuda("compact_rows_multi", keep, *channels)
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise ValueError("keep must be a 1-D bool tensor")
    for c in channels:
        if c.dtype != torch.int32 or c.shape != (n,):
            raise ValueError(f"channels must be int32[{n}]")
    lib = build.library()
    if len(channels) > lib.pch_max_channels():
        raise ValueError(f"at most {lib.pch_max_channels()} channels")
    outs = tuple(
        torch.empty(capacity, dtype=torch.int32, device=keep.device)
        for _ in channels
    )
    scratch = torch.empty(
        lib.pch_compact_rows_scratch(n), dtype=torch.int32, device=keep.device
    )
    ins = (ctypes.c_void_p * max(len(channels), 1))(
        *[c.data_ptr() for c in channels]
    )
    dst = (ctypes.c_void_p * max(len(channels), 1))(*[o.data_ptr() for o in outs])
    rc = lib.pch_compact_rows(
        keep.data_ptr(), n, ins, dst, len(channels), capacity,
        scratch.data_ptr(), build.stream(keep.device),
    )
    build.check(rc, "compact_rows_multi")
    launches += 1
    return outs, scratch[-1]


def compact_rows_multi_plain(keep, channels, capacity: int):
    """Plain PyTorch version: same contract."""
    count = keep.sum(dtype=torch.int32)
    idx = torch.nonzero(keep).squeeze(1)[:capacity]
    outs = []
    for c in channels:
        o = torch.zeros(capacity, dtype=torch.int32, device=c.device)
        o[: idx.shape[0]] = c[idx]
        outs.append(o)
    return tuple(outs), count


def compact_rows(keep, hi, lo, capacity: int):
    """Compact Morton (hi, lo) int32[N] rows where ``keep`` into
    [capacity] buffers.  Returns (hi_c, lo_c, count): rows
    [0, min(count, capacity)) hold the kept rows in input order; past
    them hi_c holds SENTINEL_HI (sorting after every code) and lo_c zeros.
    count is the TRUE number of kept rows."""
    return _with_sentinel(*compact_rows_multi(keep, (hi, lo), capacity), capacity)


def compact_rows_plain(keep, hi, lo, capacity: int):
    """Plain PyTorch version of compact_rows: same contract."""
    return _with_sentinel(*compact_rows_multi_plain(keep, (hi, lo), capacity), capacity)


def _with_sentinel(channels, count, capacity: int):
    hi_c, lo_c = channels
    ok = torch.arange(capacity, device=hi_c.device) < torch.clamp(count, max=capacity)
    return torch.where(ok, hi_c, SENTINEL_HI), lo_c, count
