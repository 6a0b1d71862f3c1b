"""Segment reductions over sorted data.

Counterpart of ``pointcloudhookup_tpu/ops/segments.py``: segment flags
(``boundary_flags``), each row's segment span (``segment_spans``), the
segmented scan and the per-row segment sum, max and min built on it (the
segscan kernel on the card, one launch a scan), and ``pack_segments``, one
row a segment packed into a fixed table by one stable sort.
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


def segment_spans(is_start):
    """For each row of sorted data: (start, nxt) int32, where start is the
    first row of its segment and nxt is one past the last."""
    n = is_start.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=is_start.device)
    start = torch.cummax(torch.where(is_start, iota, -1), 0).values
    behind = torch.cat([is_start[1:], torch.ones(1, dtype=torch.bool, device=is_start.device)])
    nxt = torch.cummin(torch.where(behind, iota + 1, n).flip(0), 0).values.flip(0)
    return start, nxt


def segment_sum_rows(values, is_start, nxt):
    """Per row: the sum of ``values`` ([N] or [N, C]) over the row's whole
    segment, read at the segment's last row of a segmented scan (not a
    global cumsum difference, which cancels catastrophically in f32)."""
    scan = segmented_scan(torch.add, values, is_start)
    end = torch.clamp(nxt - 1, 0, values.shape[0] - 1).long()
    return scan[end]


def segment_max_rows(values, is_start):
    """Per row: the max of ``values`` over the row's whole segment (a
    forward and a backward segmented scan)."""
    fwd = segmented_scan(torch.maximum, values, is_start)
    bwd = segmented_scan(torch.maximum, values, is_start, reverse=True)
    return torch.maximum(fwd, bwd)


def segment_min_rows(values, is_start):
    fwd = segmented_scan(torch.minimum, values, is_start)
    bwd = segmented_scan(torch.minimum, values, is_start, reverse=True)
    return torch.minimum(fwd, bwd)


def pack_segments(sort_key, payloads, capacity: int):
    """Pack one row per segment into a fixed-size table.

    sort_key: int[N], the packed index (< capacity) at each segment's
    representative row, >= capacity elsewhere (those rows are dropped).
    payloads: tuple of [N] tensors.  Returns a tuple of [capacity] tensors:
    the rows in key order (one stable sort), zero-padded past N.  Rows of
    equal key keep their input order (the JAX package's sort is unstable
    there)."""
    order = torch.sort(sort_key, stable=True).indices
    n = sort_key.shape[0]
    out = []
    for p in payloads:
        p = p[order]
        if capacity <= n:
            out.append(p[:capacity])
        else:
            out.append(torch.cat([p, p.new_zeros((capacity - n,) + tuple(p.shape[1:]))]))
    return tuple(out)
