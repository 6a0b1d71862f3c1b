"""Plain NumPy reference of the exact extraction of one tile.

The semantics of the upstream tool's tower extraction
(``utils/tower_extraction.py``) as the repository's JAX package fixes them
for a tile above ``auto_grid_threshold`` points (the exact path,
``pointcloudhookup_tpu/ops/frontend_exact.py``):

  1. centre the tile on its float64 mean, float32 coordinates;
  2. ground base = the ``percentile`` of z with numpy's linear
     interpolation, in float32; keep the rows above base + offset (above
     base + retry_offset when fewer than min_points_after survive);
  3. cells of eps / 2 from the kept rows' float32 minimum corner; a cell is
     dense with at least ``min_cell_points`` kept rows (the floor doubles,
     up to 16, while more than max_cells cells are dense; past that the
     first max_cells in key order stay);
  4. DBSCAN over the dense cells: a cell's population is the rows of the
     dense cells whose centres lie within eps of its centre, core at
     min_points; core cells within eps are one cluster; a border cell joins
     the first (lowest) cluster among its core neighbours; clusters are
     numbered by their first core cell in key order (the tight Morton
     interleave of the cell coordinates);
  5. per cluster below max_clusters, the minimum-area XY rectangle over
     obb_angles orientations in [0, pi/2), extruded over the z extent;
  6. filters (height, width, aspect) and the greedy duplicate suppression
     in cluster order.

It imports nothing of the program, nor PyTorch.  Connectivity is scipy's connected
components over the cell graph, neighbours are found by hashing cell
coordinates: nothing here follows the program's kernels.  ``lower`` =
"bfloat16" rounds the centred coordinates to bfloat16 first: the control,
one precision below the float32 the configuration states.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

f32 = np.float32


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def percentile_f32(x: np.ndarray, q: float) -> np.float32:
    """numpy's 'linear' percentile of float32 x, every step in float32."""
    n = len(x)
    h = f32(n - 1) * (f32(q) / f32(100.0))
    lo = min(max(int(np.floor(h)), 0), n - 1)
    hi = min(lo + 1, n - 1)
    frac = f32(h - f32(lo))
    part = np.partition(x, (lo, hi))
    return f32(f32(part[lo] * f32(f32(1.0) - frac)) + f32(part[hi] * frac))


def interleave(ijk: np.ndarray, bits) -> np.ndarray:
    """Morton-style key of int cell coordinates [M, 3]: bit levels from the
    lowest, axes x, y, z round-robin over the axes that still have bits."""
    key = np.zeros(len(ijk), np.int64)
    p = 0
    for lvl in range(max(bits)):
        for a in range(3):
            if lvl < bits[a]:
                key |= ((ijk[:, a].astype(np.int64) >> lvl) & 1) << p
                p += 1
    return key


def cell_bits(span, eps: float):
    """Per-axis widths of the cell key (the +2 margin of the exact path's
    plan), or None when the grid needs more than 31 bits."""
    bits = [max((int(math.floor(max(float(s), 0.0) / (eps / 2.0))) + 2).bit_length(), 1)
            for s in span]
    return None if sum(bits) > 31 else tuple(bits)


def offsets_within(reach: float) -> np.ndarray:
    """Integer cell offsets whose centres lie within reach cell widths:
    cells of width w have centres within eps iff |offset|^2 <= (eps / w)^2."""
    r = int(math.floor(reach))
    return np.array([(a, b, c) for a in range(-r, r + 1) for b in range(-r, r + 1)
                     for c in range(-r, r + 1) if a * a + b * b + c * c <= reach * reach],
                    np.int64)


def _neighbour_pairs(ijk: np.ndarray, offsets: np.ndarray):
    """(i, j) index pairs of cells within eps of each other, self included."""
    pad = int(np.abs(offsets).max())
    base = ijk.min(axis=0) - pad
    width = ijk.max(axis=0) - base + pad + 1
    code = lambda v: ((v[:, 0] - base[0]) * width[1] + (v[:, 1] - base[1])) * width[2] + (v[:, 2] - base[2])  # noqa: E731
    c = code(ijk)
    order = np.argsort(c, kind="stable")
    cs = c[order]
    rows, cols = [], []
    for off in offsets:
        q = code(ijk + off)
        pos = np.clip(np.searchsorted(cs, q), 0, len(cs) - 1)
        hit = cs[pos] == q
        rows.append(np.flatnonzero(hit))
        cols.append(order[pos[hit]])
    return np.concatenate(rows), np.concatenate(cols)


def cluster_cells(ijk, counts, min_points: int, reach: float = 2.0):
    """DBSCAN over cells given in key order, neighbours within reach cell
    widths.  Returns int64 labels [M]: cluster numbers by first core cell,
    -1 noise."""
    m = len(ijk)
    if m == 0:
        return np.zeros(0, np.int64)
    r, c = _neighbour_pairs(ijk, offsets_within(reach))
    pop = np.bincount(r, weights=counts[c].astype(np.float64), minlength=m)
    core = pop >= min_points
    cc = core[r] & core[c]
    graph = coo_matrix((np.ones(int(cc.sum())), (r[cc], c[cc])), shape=(m, m))
    _, comp = connected_components(graph, directed=False)
    # a component's representative: its first core cell in key order
    rep = np.full(m, m, np.int64)
    np.minimum.at(rep, comp[core], np.flatnonzero(core))
    label_rep = np.where(core, rep[comp], m)
    border = ~core
    bc = border[r] & core[c]
    np.minimum.at(label_rep, r[bc], rep[comp[c[bc]]])
    reps = np.unique(label_rep[label_rep < m])
    return np.where(label_rep < m, np.searchsorted(reps, label_rep), -1)


def angle_table(num_angles: int):
    """cos and sin of j * (pi / 2) / num_angles, the angle in float32 (a
    float32 step times j, as the JAX package's ``ops/pallas/obb_accum.py``
    forms it), each value correctly rounded to float32.  Libraries' float32
    cos and sin differ from this in the last bit of some entries (XLA:CPU
    in 89 of 256, PyTorch in 26): ``obb_stats`` keeps every angle whose
    area such a last bit can reach."""
    ang = np.arange(num_angles, dtype=f32) * f32(math.pi / 2.0 / num_angles)
    return (np.cos(ang.astype(np.float64)).astype(f32),
            np.sin(ang.astype(np.float64)).astype(f32))


def tie_tolerance(r: float, eu: float, ev: float) -> float:
    """The largest difference between two float32 computations of one
    rectangle's area, for rows within r (|x| + |y|) of the origin: a last
    bit of a table entry and each side's rounding of a projection (with or
    without a fused multiply-add) move a projected coordinate by at most
    2 r 2**-24, so an extent by twice that on either side."""
    delta = 2.0 * r * 2.0**-24
    return 4.0 * delta * (eu + ev)


def obb_stats(x, y, z, labels, k: int, num_angles: int):
    """Per cluster below k: count, centre, extent (long, short, height),
    north angle (degrees) and centroid, in float64 from float32 rows;
    projections in float32 as the definition rounds them.  ``ties[i]``
    holds, for every angle whose area lies within ``tie_tolerance`` of the
    least, its (north, centre xy, extent long and short): the answers that
    rounding alone can choose between."""
    step = np.pi / 2.0 / num_angles
    cos_a, sin_a = angle_table(num_angles)
    out = dict(count=np.zeros(k, np.int64), center=np.zeros((k, 3)), extent=np.zeros((k, 3)),
               north=np.zeros(k), centroid=np.zeros((k, 3)), ties=[[] for _ in range(k)])
    sel = (labels >= 0) & (labels < k)
    lab = labels[sel]
    order = np.argsort(lab, kind="stable")
    lab = lab[order]
    xs, ys, zs = x[sel][order], y[sel][order], z[sel][order]
    starts = np.flatnonzero(np.r_[True, lab[1:] != lab[:-1]]) if len(lab) else np.zeros(0, int)
    ends = np.r_[starts[1:], len(lab)]

    def answer(j, ulo, uhi, vlo, vhi, eu, ev):
        theta = j * step
        cu = (float(uhi[j]) + float(ulo[j])) / 2.0
        cv = (float(vhi[j]) + float(vlo[j])) / 2.0
        uvec = np.array([math.cos(theta), math.sin(theta)])
        vvec = np.array([-math.sin(theta), math.cos(theta)])
        axis = vvec if ev[j] > eu[j] else uvec
        north = (90.0 - math.degrees(math.atan2(axis[1], axis[0]))) % 360.0
        return north, cu * uvec + cv * vvec, [max(eu[j], ev[j]), min(eu[j], ev[j])]

    for s, e in zip(starts, ends):
        i = int(lab[s])
        px, py, pz = xs[s:e, None], ys[s:e, None], zs[s:e, None]
        u = px * cos_a[None, :] + py * sin_a[None, :]
        v = py * cos_a[None, :] - px * sin_a[None, :]
        ulo, uhi, vlo, vhi = u.min(0), u.max(0), v.min(0), v.max(0)
        eu, ev = uhi - ulo, vhi - vlo
        area = (eu * ev).astype(np.float64)
        best = int(np.argmin(eu * ev))
        r = float(np.abs(px).max() + np.abs(py).max())
        tol = tie_tolerance(r, float(eu[best]), float(ev[best]))
        north, cxy, ext = answer(best, ulo, uhi, vlo, vhi, eu, ev)
        zlo, zhi = float(pz.min()), float(pz.max())
        out["count"][i] = e - s
        out["center"][i] = [*cxy, (zhi + zlo) / 2.0]
        out["extent"][i] = [*ext, zhi - zlo]
        out["north"][i] = north
        out["ties"][i] = [answer(j, ulo, uhi, vlo, vhi, eu, ev)
                          for j in np.flatnonzero(area <= area[best] + tol)]
        out["centroid"][i] = [px.astype(np.float64).mean(), py.astype(np.float64).mean(),
                              pz.astype(np.float64).mean()]
    return out


def accept(stats, filters: dict) -> np.ndarray:
    """Filters, then greedy duplicate suppression in cluster order."""
    ex, ez = stats["extent"][:, 0], stats["extent"][:, 2]
    ok = ((stats["count"] > 0) & (ez > filters["min_height"]) & (ex > filters["min_width"])
          & (ex < filters["max_width"]) & (ez / np.maximum(ex, 1e-6) > filters["aspect_ratio_threshold"]))
    accepted = np.zeros(len(ok), bool)
    thr2 = filters["duplicate_threshold"] ** 2
    for i in np.flatnonzero(ok):
        prev = stats["center"][accepted]
        accepted[i] = not (((prev - stats["center"][i]) ** 2).sum(axis=1) < thr2).any()
    return accepted


def extract(points: np.ndarray, params: dict, lower: str | None = None) -> dict:
    """The tile's extraction: dict(labels int64[N], ground_keep bool[N],
    accepted bool[K], count, center (world), extent, north, centroid
    (world), floor)."""
    gp, cp = params["ground"], params["cluster"]
    points = np.asarray(points, np.float64).reshape(-1, 3)
    origin = points.mean(axis=0)
    xyz = (points - origin).astype(f32)
    if lower == "bfloat16":
        xyz = to_bfloat16(xyz)
    elif lower is not None:
        raise ValueError(f"unknown lower precision {lower!r}")
    z = xyz[:, 2]
    base = percentile_f32(z, gp["percentile"])
    keep = z > f32(base + f32(gp["offset"]))
    if keep.sum() < gp["min_points_after"]:
        keep = z > f32(base + f32(gp["retry_offset"]))
    if cp["method"] not in ("auto", "grid") or cp["per_chunk"] or (
            cp["method"] == "auto" and len(points) <= cp["auto_grid_threshold"]):
        raise ValueError("the tile does not take the exact path")
    bits = cell_bits(points.max(axis=0) - points.min(axis=0), cp["eps"])
    if bits is None:
        raise ValueError("the tile's cell grid needs more than 31 bits (not the exact path)")
    rows = np.flatnonzero(keep)
    kept = xyz[rows]
    mn = kept.min(axis=0)
    cell = f32(cp["eps"]) / f32(2.0)
    inv_cell = f32(1.0) / cell
    ijk = np.floor((kept - mn[None, :]) * inv_cell).astype(np.int64)
    key = interleave(ijk, bits)
    ukey, first, inverse, counts = np.unique(key, return_index=True, return_inverse=True,
                                             return_counts=True)
    floor = cp["min_cell_points"]
    while True:
        dense = np.flatnonzero(counts >= floor)
        if len(dense) <= cp["max_cells"] or floor >= 16:
            break
        floor = min(floor * 2 if floor > 1 else 2, 16)
    dense = dense[: cp["max_cells"]]
    cell_lab = np.full(len(ukey), -1, np.int64)
    cell_lab[dense] = cluster_cells(ijk[first[dense]], counts[dense], cp["min_points"])
    labels = np.full(len(points), -1, np.int64)
    labels[rows] = cell_lab[inverse]
    k = params["max_clusters"]
    stats = obb_stats(xyz[:, 0], xyz[:, 1], xyz[:, 2], labels, k, params["obb_angles"])
    stats["accepted"] = accept(stats, params["filters"])
    stats["center"] = stats["center"] + origin
    stats["ties"] = [[(n, c + origin[:2], ext) for n, c, ext in t] for t in stats["ties"]]
    stats["centroid"] = stats["centroid"] + origin
    return dict(labels=labels, ground_keep=keep, floor=floor, **stats)


def run(points: np.ndarray, config: dict, lower: str | None = None) -> dict:
    """The reference of one tile of a configuration."""
    return extract(points, config["params"], lower)
