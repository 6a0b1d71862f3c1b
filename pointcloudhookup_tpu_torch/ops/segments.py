"""Segment reductions over sorted data.

Counterpart of ``pointcloudhookup_tpu/ops/segments.py``: ``boundary_flags``
and ``segmented_scan``, the two that the extraction paths call.  The rest
of that module (``segment_spans``, ``segment_sum_rows``,
``segment_{max,min}_rows``, ``pack_segments``) waits for the voxel
downsampling port.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.kernels import segscan

_OP_NAMES = {torch.add: "add", torch.maximum: "max", torch.minimum: "min"}


def boundary_flags(*keys):
    """is_start[i]: row i begins a new segment in key-sorted order (any key
    differs from the row before; row 0 always)."""
    flag = torch.zeros(keys[0].shape[0], dtype=torch.bool, device=keys[0].device)
    for k in keys:
        flag |= k != torch.roll(k, 1)
    flag[:1].fill_(True)
    return flag


def segmented_scan(op, values, is_start, reverse: bool = False):
    """Segmented inclusive scan of ``op`` (torch.add, torch.maximum or
    torch.minimum) along axis 0 of an int32/float32 tensor [N] or [N, C]
    (every column under the same flags), restarting at each is_start row
    (or segment end if reverse).  CUDA tensors run the segscan kernel (one
    launch for all C columns); CPU tensors its plain version."""
    if op not in _OP_NAMES:
        raise ValueError(f"unsupported op {op!r}")
    return segscan.segmented_scan(values, is_start, _OP_NAMES[op], reverse)
