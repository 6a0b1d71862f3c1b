"""Peaks and the bytes and operations of each kernel function's call.

The table of PERF.md §6 names the ten functions of the port that replace
the JAX package's Pallas kernels (eleven entry points: ``compact_rows`` is
``compact_rows_multi`` with two channels).  A call's bound is the larger of
its bytes over the HBM peak and its float32 operations over the float32
peak.  Bytes and operations are counted from the public function's inputs
and outputs and from what these inputs need (inputs read once, outputs
written once, only the rows the data keeps), never from an implementation:
a later change that reimplements a function keeps its count, and one that
removes a call removes its bound.  The arithmetic is frozen here from
``chip_smoke.py`` (``compact_bytes`` :2406-2410, the bound of ``case``
:2366-2385 and the pair, row and angle counts of PERF.md §6).

``cost(name, args, kwargs, out)`` runs when a call returns and keeps only
shapes and the small count tensors the call returned; ``bound_s()`` reads
them after the measured window.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

_K = "pointcloudhookup_tpu_torch.ops.kernels."
FUNCTIONS = {
    "compact_rows_multi": (_K + "compactrows", "compact_rows_multi"),
    "compact_rows": (_K + "compactrows", "compact_rows"),
    "segmented_scan": (_K + "segscan", "segmented_scan"),
    "neighbor_reduce": (_K + "neighbor", "neighbor_reduce"),
    "cluster_cells": (_K + "cluster_converge", "cluster_cells"),
    "obb_accumulate_xyz": (_K + "obb_accum", "obb_accumulate_xyz"),
    "obb_accumulate": (_K + "obb_accum", "obb_accumulate"),
    "compact_indices": (_K + "compactidx", "compact_indices"),
    "first_occurrence_flags": (_K + "dupwin", "first_occurrence_flags"),
    "window_sort_w": (_K + "winsort", "window_sort_w"),
    "merge_sort_2key": (_K + "mergesort", "merge_sort_2key"),
}
# operations a labelled (row, angle) of the OBB accumulation: u and v,
# two products and a sum each
OBB_OPS_PER_ROW_ANGLE = 6


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _arg(args, kwargs, i, name, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


class Cost:
    """One call's bytes and operations; ``counts`` are 0-d tensors that the
    call returned, read after the window."""

    def __init__(self, fixed_bytes: int, per_count_bytes: int = 0, cap: int | None = None,
                 flops_per_count: float = 0.0, counts=()):
        self.fixed_bytes = fixed_bytes
        self.per_count_bytes = per_count_bytes
        self.cap = cap
        self.flops_per_count = flops_per_count
        self.counts = counts

    def totals(self) -> tuple[float, float]:
        n = float(sum(float(c.sum()) for c in self.counts))
        moved = min(n, self.cap) if self.cap is not None else n
        return (self.fixed_bytes + self.per_count_bytes * moved, self.flops_per_count * n)

    def bound_s(self) -> float:
        nbytes, flops = self.totals()
        return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def cost(name: str, args, kwargs, out) -> Cost:
    if name in ("compact_rows_multi", "compact_rows"):
        keep = args[0]
        if name == "compact_rows_multi":
            chans, cap = _arg(args, kwargs, 1, "channels"), _arg(args, kwargs, 2, "capacity")
            count = out[1]
        else:
            chans, cap = args[1:3], _arg(args, kwargs, 3, "capacity")
            count = out[2]
        width = sum(c.element_size() for c in chans)
        # keep read once, the kept rows read once a channel, every output
        # row written once, the count written
        return Cost(_nbytes(keep) + width * cap + 4, width, cap, counts=(count,))
    if name == "segmented_scan":
        values, flags = args[0], args[1]
        return Cost(2 * _nbytes(values) + _nbytes(flags))
    if name == "neighbor_reduce":
        xyz, labels, weights, allowed = args[:4]
        m = xyz.shape[0]
        return Cost(sum(_nbytes(t) for t in (xyz, labels, weights, allowed)) + m * (4 + 4))
    if name == "cluster_cells":
        centers, ccount, alive, labels0 = args[:4]
        m = centers.shape[0]
        return Cost(sum(_nbytes(t) for t in (centers, ccount, alive, labels0)) + m * (4 + 4))
    if name in ("obb_accumulate_xyz", "obb_accumulate"):
        k, a = kwargs.get("max_clusters", 128), kwargs.get("num_angles", 256)
        inputs = args[:4] if name == "obb_accumulate_xyz" else args[:3]
        extra = 0 if name == "obb_accumulate_xyz" else _nbytes(args[3])
        nbytes = sum(_nbytes(t) for t in inputs) + extra + 4 * (6 * k + 4 * k * a)
        # every labelled row is projected on every angle
        return Cost(nbytes, flops_per_count=OBB_OPS_PER_ROW_ANGLE * a, counts=(out["cnt"],))
    if name == "compact_indices":
        flag, m = args[0], _arg(args, kwargs, 1, "m")
        return Cost(_nbytes(flag) + 4 * m)
    if name == "first_occurrence_flags":
        k1, w = args[0], args[1]
        return Cost(_nbytes(k1) + _nbytes(w) + k1.shape[0])
    if name == "window_sort_w":
        k1, w = args[0], args[1]
        return Cost(_nbytes(k1) + 2 * _nbytes(w))
    if name == "merge_sort_2key":
        hi, lo = args[0], args[1]
        return Cost(2 * (_nbytes(hi) + _nbytes(lo)))
    raise KeyError(f"no cost for kernel function {name!r}")
