"""Order-preserving stream compaction of int32 channels by a keep mask.

Counterpart of ``pointcloudhookup_tpu/ops/pallas/compactrows.py::
compact_rows_multi`` and of its Morton wrapper ``compact_rows``.  The CUDA
kernel is ``csrc/compactrows.cu``: one pass that counts, scans and
scatters, and fills the rows past the count with a value per channel (the
Morton wrapper's sentinel).  The plain PyTorch version below is what CPU
tensors take and what the kernel is held against on the card.  Unlike the
TPU kernel there is no alignment rule on N or the capacity.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build
from pointcloudhookup_tpu_torch.utils import trace
from pointcloudhookup_tpu_torch.ops.morton import SENTINEL_HI


@functools.cache
def max_channels() -> int:
    """The kernel's channel limit (csrc/compactrows.cu), asked once."""
    return build.library().pch_max_channels()


def compact_rows_multi(keep, channels, capacity: int, fills=None):
    """Compact rows where ``keep`` into fixed [capacity] buffers.

    keep bool[N]; channels: tuple of int32[N] (view other 32-bit dtypes
    as int32 outside); fills: one int per channel, the value of the rows
    past the count (zeros when None).  Returns (tuple of int32[capacity],
    count): rows [0, min(count, capacity)) hold the kept rows in input
    order, the rest the fill.  count is a 0-d int32 tensor holding the TRUE
    number of kept rows; count > capacity means the tail was dropped.  On
    the card the outputs are the rows of one [len(channels), capacity]
    tensor."""
    if keep.device.type == "cpu":
        return compact_rows_multi_plain(keep, channels, capacity, fills)
    n = keep.shape[0]
    nchan = len(channels)
    build.require_cuda("compact_rows_multi", keep, *channels)
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise ValueError("keep must be a 1-D bool tensor")
    for c in channels:
        if c.dtype != torch.int32 or c.shape != (n,):
            raise ValueError(f"channels must be int32[{n}]")
    if nchan > max_channels():
        raise ValueError(f"at most {max_channels()} channels")
    if fills is not None and len(fills) != nchan:
        raise ValueError(f"one fill per channel ({nchan}), got {len(fills)}")
    lib = build.library()
    words = lib.pch_compact_rows_scratch(n)
    buf = torch.empty(words + nchan * capacity, dtype=torch.int32, device=keep.device)
    ins = (ctypes.c_void_p * nchan)(*[c.data_ptr() for c in channels])
    rc = lib.pch_compact_rows(
        keep.data_ptr(), n, ins, None if fills is None else (ctypes.c_int * nchan)(*fills),
        nchan,
        buf.data_ptr() + 4 * words, capacity, buf.data_ptr(), build.stream(keep.device),
    )
    build.check(rc, "compact_rows_multi")
    trace.count("kernel.compact_rows_multi")
    return buf[words:].view(nchan, capacity).unbind(0), buf[0]


def compact_rows_multi_plain(keep, channels, capacity: int, fills=None):
    """Plain PyTorch version: same contract."""
    count = keep.sum(dtype=torch.int32)
    idx = torch.nonzero(keep).squeeze(1)[:capacity]
    fills = fills if fills is not None else (0,) * len(channels)
    outs = []
    for c, fill in zip(channels, fills):
        o = torch.full((capacity,), fill, dtype=torch.int32, device=c.device)
        o[: idx.shape[0]] = c[idx]
        outs.append(o)
    return tuple(outs), count


def compact_rows(keep, hi, lo, capacity: int):
    """Compact Morton (hi, lo) int32[N] rows where ``keep`` into
    [capacity] buffers.  Returns (hi_c, lo_c, count): rows
    [0, min(count, capacity)) hold the kept rows in input order; past
    them hi_c holds SENTINEL_HI (sorting after every code) and lo_c zeros.
    count is the TRUE number of kept rows."""
    (hi_c, lo_c), count = compact_rows_multi(keep, (hi, lo), capacity, (SENTINEL_HI, 0))
    return hi_c, lo_c, count


def compact_rows_plain(keep, hi, lo, capacity: int):
    """Plain PyTorch version of compact_rows: same contract."""
    (hi_c, lo_c), count = compact_rows_multi_plain(keep, (hi, lo), capacity,
                                                   (SENTINEL_HI, 0))
    return hi_c, lo_c, count
