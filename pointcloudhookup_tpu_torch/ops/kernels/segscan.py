"""Segmented inclusive scan with add, max or min.

Counterpart of ``pointcloudhookup_tpu/ops/pallas/segscan.py::
segmented_scan_pallas``.  The CUDA kernel is ``csrc/segscan.cu``: one
launch (and a memset) per call, for one column or up to four columns under
one flag array.  The plain PyTorch version is the JAX package's own XLA
path (``ops/segments.py::_segmented_scan_fwd``, Hillis-Steele doubling),
so on the CPU the port sums in the same order as the reference.  On the
card integer, max and min scans are bit-identical to the plain version;
float32 sums are added in another (fixed) order, so two calls give the
same bits and differ from the plain version by rounding only.
"""

from __future__ import annotations

import functools

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build
from pointcloudhookup_tpu_torch.utils import trace


_OPS = {"add": torch.add, "max": torch.maximum, "min": torch.minimum}
_OP_CODES = {"add": 0, "max": 1, "min": 2}
_DTYPE_CODES = {torch.int32: 0, torch.float32: 1}


@functools.cache
def max_columns() -> int:
    """The kernel's column limit (csrc/segscan.cu), asked once."""
    return build.library().pch_segscan_max_cols()


def segmented_scan(values, is_start, op: str = "add", reverse: bool = False):
    """Segmented inclusive scan of ``op`` along axis 0, restarting at each
    is_start row (at each segment END if reverse).

    values int32/float32 [N] or [N, C] (each column scanned under the same
    flags; C at most 4 on the card), is_start bool[N]."""
    if op not in _OPS:
        raise ValueError(f"unsupported op {op!r}")
    if values.device.type == "cpu":
        return segmented_scan_plain(values, is_start, op, reverse)
    build.require_cuda("segmented_scan", values, is_start)
    n = values.shape[0]
    if values.dim() not in (1, 2) or values.dtype not in _DTYPE_CODES:
        raise ValueError("values must be an int32 or float32 tensor [N] or [N, C]")
    cols = 1 if values.dim() == 1 else values.shape[1]
    if not 1 <= cols <= max_columns():
        raise ValueError(f"values must have 1 to {max_columns()} columns, got {cols}")
    if is_start.dtype != torch.bool or is_start.shape != (n,):
        raise ValueError(f"is_start must be bool[{n}]")
    lib = build.library()
    out = torch.empty_like(values)
    scratch = torch.empty(
        lib.pch_segscan_scratch(n, cols), dtype=torch.int32, device=values.device
    )
    rc = lib.pch_segscan(
        values.data_ptr(), is_start.data_ptr(), out.data_ptr(), n, cols,
        _OP_CODES[op], _DTYPE_CODES[values.dtype], int(reverse),
        scratch.data_ptr(), build.stream(values.device),
    )
    build.check(rc, "segmented_scan")
    if n > 0:
        trace.count("kernel.segmented_scan")
    return out


def segmented_scan_plain(values, is_start, op: str = "add", reverse: bool = False):
    """Plain PyTorch version: same contract."""
    fn = _OPS[op]
    if reverse:
        # reset flags for a backward scan are the segment-END rows
        ends = torch.cat([is_start[1:], torch.ones(1, dtype=torch.bool,
                                                  device=is_start.device)])
        return _scan_fwd(fn, values.flip(0), ends.flip(0)).flip(0)
    return _scan_fwd(fn, values, is_start)


def _scan_fwd(fn, values, flags):
    """Hillis-Steele doubling: log2(N) shifted combines."""
    n = values.shape[0]
    iota = torch.arange(n, device=values.device)
    v, f = values, flags
    d = 1
    while d < n:
        vprev = torch.cat([v[:d], v[:-d]])  # [i-d]; rows < d masked below
        fprev = torch.cat([f[:d], f[:-d]])
        valid = iota >= d
        blocked = f | ~valid  # a segment starts here: don't merge
        if values.dim() == 2:
            blocked = blocked[:, None]
        v = torch.where(blocked, v, fn(vprev, v))
        f = f | (fprev & valid)
        d <<= 1
    return v
