"""Segmented inclusive scan with add, max or min.

Counterpart of ``pointcloudhookup_tpu/ops/pallas/segscan.py::
segmented_scan_pallas``.  The CUDA kernel is ``csrc/segscan.cu``; the plain
PyTorch version is the JAX package's own XLA path
(``ops/segments.py::_segmented_scan_fwd``, Hillis-Steele doubling), so on
the CPU the port sums in the same order as the reference.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build

launches = 0  # kernel launches in this process (read and reset by chip_smoke.py)

_OPS = {"add": torch.add, "max": torch.maximum, "min": torch.minimum}
_OP_CODES = {"add": 0, "max": 1, "min": 2}
_DTYPE_CODES = {torch.int32: 0, torch.float32: 1}


def segmented_scan(values, is_start, op: str = "add", reverse: bool = False):
    """Segmented inclusive scan of ``op`` along axis 0 of a 1-D tensor,
    restarting at each is_start row (at each segment END if reverse).

    values int32/float32[N], is_start bool[N]."""
    if op not in _OPS:
        raise ValueError(f"unsupported op {op!r}")
    if values.device.type == "cpu":
        return segmented_scan_plain(values, is_start, op, reverse)
    global launches
    build.require_cuda("segmented_scan", values, is_start)
    n = values.shape[0]
    if values.dim() != 1 or values.dtype not in _DTYPE_CODES:
        raise ValueError("values must be a 1-D int32 or float32 tensor")
    if is_start.dtype != torch.bool or is_start.shape != (n,):
        raise ValueError(f"is_start must be bool[{n}]")
    lib = build.library()
    out = torch.empty_like(values)
    scratch = torch.empty(
        lib.pch_segscan_scratch(n), dtype=torch.int32, device=values.device
    )
    rc = lib.pch_segscan(
        values.data_ptr(), is_start.data_ptr(), out.data_ptr(), n,
        _OP_CODES[op], _DTYPE_CODES[values.dtype], int(reverse),
        scratch.data_ptr(), build.stream(values.device),
    )
    build.check(rc, "segmented_scan")
    launches += 1
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
        v = torch.where(blocked, v, fn(vprev, v))
        f = f | (fprev & valid)
        d <<= 1
    return v
