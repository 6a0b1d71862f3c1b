"""Plain NumPy reference of one streamed tile through the fused fast step.

The semantics that ``stream_extract(fast=True)`` has for one tile, as the
repository's JAX package fixes them (``core/streaming.py`` and
``ops/frontend_fused.py::fused_extract_step`` with geometric voxels, sort
mode "full" and the ground pre-cut):

  1. the wire: the tile centred on its float64 mean in float32, or, on the
     u16 wire, each axis quantised to 65,535 steps over the tile's extent
     and decoded as step * pitch + (min - mean) rounded once; a tile whose
     pitch exceeds ``max_pitch`` goes on the float32 wire;
  2. 0.1 m voxels on the lattice through the masked float32 minimum
     floored to a multiple of the voxel size;
  3. the pre-cut: the ground percentile of every ``stride``-th row's z
     (stride max(capacity / 16384, 16)); rows above base + offset - margin
     survive, the first capacity / precut_div of them in row order;
  4. each surviving voxel once, at its geometric centre; a voxel is above
     ground when its centre's z exceeds base + offset;
  5. cells of 2**cell_shift voxels a side (the shift capped so that a
     cell's diagonal stays under eps); a cell is dense with at least
     ``min_cell_points`` voxels above ground (the first max_cells dense
     cells in Morton order stay); DBSCAN over the dense cells by voxel
     counts, as in ``exact.py``; clusters numbered by their first core
     cell in Morton order;
  6. per cluster below max_clusters the minimum-area rectangle over the
     voxel centres, the filters and the duplicate suppression.

The per-row arrays are laid out as the step's rows are: the surviving
voxels' Morton codes in ascending order (a voxel's first row carries its
flags), then empty rows up to the pre-cut capacity.  Imports nothing of the
program.  ``lower="bfloat16"`` rounds the wire's coordinates to bfloat16:
the control.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.reference.exact import (
    accept, cluster_cells, interleave, obb_stats, to_bfloat16,
)

f32 = np.float32


def fma32(a, b, c):
    """float32 a * b + c rounded once (through float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def percentile_fma(x: np.ndarray, q: float) -> np.float32:
    """numpy's 'linear' percentile of float32 x in float32, the last
    product and sum rounded once."""
    n = len(x)
    h = f32(n - 1) * (f32(q) / f32(100.0))
    lo = min(max(int(np.floor(h)), 0), n - 1)
    hi = min(lo + 1, n - 1)
    frac = f32(h - f32(lo))
    part = np.partition(x, (lo, hi))
    return f32(fma32(part[hi], frac, f32(part[lo] * f32(f32(1.0) - frac))))


def effective_cell_shift(eps: float, voxel_size: float, cell_shift: int) -> int:
    """The cell shift capped so that a cell's diagonal stays under eps."""
    safe = int(math.floor(math.log2(max(eps / (math.sqrt(3.0) * voxel_size), 1e-6))))
    return max(2, min(cell_shift, safe))


def wire(points: np.ndarray, st: dict):
    """The tile's float32 rows as the step receives them."""
    origin = points.mean(axis=0)
    lo, hi = points.min(axis=0), points.max(axis=0)
    if st["wire"] == "u16":
        pitch = np.maximum((hi - lo) / 65535.0, 1e-9)
        if st.get("max_pitch") is None or float(pitch.max()) <= st["max_pitch"]:
            q = np.clip(np.rint((points - lo) / pitch), 0, 65535)
            return fma32(q, pitch.astype(f32)[None, :], (lo - origin).astype(f32)[None, :]), origin
    return (points - origin).astype(f32), origin


def extract_tile(points: np.ndarray, config: dict, lower: str | None = None) -> dict:
    st, params = config["stream"], config["params"]
    gp, cp = params["ground"], params["cluster"]
    points = np.asarray(points, np.float64).reshape(-1, 3)
    cap_rows = -(-max(st["capacity"], 1) // 32768) * 32768 if st["capacity"] >= 131072 \
        else st["capacity"]
    if len(points) > cap_rows:
        raise ValueError("a tile larger than the capacity is streamed in chunks")
    xyz, origin = wire(points, st)
    if lower == "bfloat16":
        xyz = to_bfloat16(xyz)
    elif lower is not None:
        raise ValueError(f"unknown lower precision {lower!r}")
    n = len(xyz)
    vs = f32(st["voxel_size"])
    inv = f32(1.0) / vs
    mn = xyz.min(axis=0)
    mn = (np.floor(mn * inv) * vs).astype(f32)
    v = np.clip(np.floor((xyz - mn[None, :]) * inv), 0, (1 << 20) - 1).astype(np.int64)

    # the pre-cut on a strided sample of the padded rows
    stride = max(cap_rows >> 14, 16)
    sample = xyz[: n : stride, 2] if n else xyz[:0, 2]
    base = percentile_fma(sample, gp["percentile"])
    thresh = f32(f32(base + f32(gp["offset"])) - f32(st["precut_margin"]))
    ccap = -(-(cap_rows // st["precut_div"]) // 32768) * 32768
    rows = np.flatnonzero(xyz[:, 2] > thresh)[:ccap]

    # voxels of the survivors, Morton-sorted; one flag row a voxel
    codes = interleave(v[rows], (20, 20, 20))
    order = np.argsort(codes, kind="stable")
    code = codes[order]
    first = np.r_[True, code[1:] != code[:-1]] if len(code) else np.zeros(0, bool)
    vox = code[first]
    vijk = v[rows][order][first]
    zc = fma32(vijk[:, 2].astype(f32) + f32(0.5), vs, mn[2])
    keep_v = zc > f32(base + f32(gp["offset"]))
    if keep_v.sum() < gp["min_points_after"]:
        keep_v = zc > f32(base + f32(gp["retry_offset"]))

    # cells: Morton prefixes of cell_shift bits an axis
    cs = effective_cell_shift(cp["eps"], float(vs), st["cell_shift"])
    cell = vox[keep_v] >> (3 * cs)
    ucell, cfirst, cinv, ccount = np.unique(cell, return_index=True, return_inverse=True,
                                            return_counts=True)
    floor = max(cp["min_cell_points"], 1)
    dense = np.flatnonzero(ccount >= floor)[: st["max_cells"]]
    cijk = vijk[keep_v][cfirst[dense]] >> cs
    reach = float(cp["eps"]) / (float(vs) * (1 << cs))
    cell_lab = np.full(len(ucell), -1, np.int64)
    cell_lab[dense] = cluster_cells(cijk, ccount[dense], cp["min_points"], reach)
    vlab = np.full(len(vox), -1, np.int64)
    vlab[np.flatnonzero(keep_v)] = cell_lab[cinv]

    # per-row layout of the step: first row of each voxel carries its flags
    labels = np.full(ccap, -1, np.int64)
    ground_keep = np.zeros(ccap, bool)
    starts = np.flatnonzero(first)
    labels[starts] = vlab
    ground_keep[starts] = keep_v

    off = (mn + f32(float(vs) * 0.5)).astype(f32)
    x, y, z = (fma32(vijk[:, a].astype(f32), vs, off[a]) for a in range(3))
    lab_obb = np.where(keep_v, vlab, -1)
    stats = obb_stats(x, y, z, lab_obb, params["max_clusters"], params["obb_angles"])
    stats["accepted"] = accept(stats, params["filters"])
    stats["center"] = stats["center"] + origin
    stats["ties"] = [[(n, c + origin[:2], ext) for n, c, ext in t] for t in stats["ties"]]
    stats["centroid"] = stats["centroid"] + origin
    return dict(labels=labels, ground_keep=ground_keep, **stats)


def run(points: np.ndarray, config: dict, lower: str | None = None) -> dict:
    """The reference of one streamed tile of a configuration."""
    return extract_tile(points, config, lower)

