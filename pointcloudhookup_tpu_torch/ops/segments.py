"""Segment reductions over sorted data.

Counterpart of ``pointcloudhookup_tpu/ops/segments.py``.  Only
``segmented_scan`` is on the exact extraction path so far.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.kernels import segscan

_OP_NAMES = {torch.add: "add", torch.maximum: "max", torch.minimum: "min"}


def segmented_scan(op, values, is_start, reverse: bool = False):
    """Segmented inclusive scan of ``op`` (torch.add, torch.maximum or
    torch.minimum) along axis 0 of a 1-D int32/float32 tensor, restarting
    at each is_start row (or segment end if reverse).  CUDA tensors run
    the segscan kernel; CPU tensors its plain version."""
    if op not in _OP_NAMES:
        raise ValueError(f"unsupported op {op!r}")
    return segscan.segmented_scan(values, is_start, _OP_NAMES[op], reverse)
