"""Plain NumPy reference of the per-chunk extraction of one tile.

The semantics of ``extract --per-chunk`` (``ClusterParams.per_chunk``), the
upstream tool's own extractor (``utils/tower_extraction.py:96-122``:
ground cut, then DBSCAN in chunks of 50,000 points whose labels are offset
per chunk and never merged), as the repository's JAX package fixes them in
its modular step (``pointcloudhookup_tpu/models/towers.py::extract_step``):

  1. centre the tile on its float64 mean, float32 coordinates; pad it with
     masked rows to a multiple of ``chunk_size``;
  2. ground base = the ``percentile`` of z with numpy's linear
     interpolation in float32, its last product and sum rounded once (the
     modular step's sort-based percentile, ``fused.percentile_fma``; the
     exact path's bisection rounds twice, ``exact.percentile_f32``); keep
     the rows above base + offset (above base + retry_offset when fewer
     than min_points_after survive);
  3. the padded tile's rows in file order, ``chunk_size`` at a time;
  4. per chunk, DBSCAN over its kept rows: a row is core with at least
     min_points kept rows of the chunk within eps, itself included, where
     "within" is the float32 ``((dx * dx + dy * dy) + dz * dz) <= eps * eps``
     of the coordinate differences, every step rounded (the port's
     ``eps_ball`` predicate); core rows within eps are one cluster; a kept
     row that is not core takes the cluster of its core neighbour with the
     least representative (noise without one);
  5. clusters numbered over the tile by ascending representative, the
     least core row of each (chunk by chunk, as the offset labels compact);
  6. per cluster below max_clusters, the sort-based search: the first
     16,384 members in row order, 32 coarse angles in [0, pi/2), then 17
     samples within one coarse step around the coarse winner, each
     projection rounded as a fused multiply-add and each area in float32;
     the box extruded over the members' z extent;
  7. filters and the greedy duplicate suppression in cluster order
     (``exact.accept``).

Departures, each written down:

* The JAX package chunks the padded tile's rows and clusters each chunk's
  kept rows (the ground flags as the mask); the upstream, as the survey
  reads it, chunks the array of kept points.  This reference follows the
  port.
* Where the least area is tied within what float32 rounding can move
  (``exact.tie_tolerance``), among the coarse angles or the samples of a
  refinement, ``ties`` holds every answer rounding can choose: the
  refinement around each tied coarse angle, and in each its tied samples.

It imports nothing of the program, nor PyTorch.  A row is core for sure
when the 27 cells of eps / 4 around its own (all within 0.87 eps of it)
hold min_points rows; the others are counted over the pairs that scipy's
k-d tree finds within eps (1 + 1e-5) in float64, each decided by the
float32 predicate.  Connectivity is a union of eps / 2 cells (any two rows
of one cell lie within eps) and of neighbouring cells that hold a core
pair within eps, the same way.  Nothing here follows the program's
kernels.  ``lower`` =
"bfloat16" rounds the centred coordinates to bfloat16 first: the control,
one precision below the float32 the configuration states.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.spatial import cKDTree

from portbench.reference.exact import accept, tie_tolerance, to_bfloat16
from portbench.reference.fused import fma32, percentile_fma

f32 = np.float32
MARGIN = 1e-5  # relative: far above float32's rounding of a distance


def within(a: np.ndarray, b: np.ndarray, eps2: np.float32) -> np.ndarray:
    """The port's float32 eps-ball predicate, row by row of a and b."""
    d = (a - b).astype(f32)
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2] <= eps2


def _pairs_within(tree: cKDTree, pts: np.ndarray, q: np.ndarray, r_hi, eps2):
    """(query index, tree index) of every pair of q's rows and the tree's
    within eps by the float32 predicate (pts: the tree's float32 rows)."""
    hits = tree.query_ball_point(q.astype(np.float64), r_hi)
    lens = np.fromiter((len(h) for h in hits), np.int64, len(hits))
    qi = np.repeat(np.arange(len(q)), lens)
    ti = np.fromiter((j for h in hits for j in h), np.int64, int(lens.sum()))
    ok = within(q[qi], pts[ti], eps2)
    return qi[ok], ti[ok]


def _find(parent: np.ndarray) -> np.ndarray:
    """Every element's root (parent pointers jumped to a fixpoint)."""
    while True:
        nxt = parent[parent]
        if np.array_equal(nxt, parent):
            return parent
        parent = nxt


def _root(parent: np.ndarray, i) -> int:
    """The root of i, halving the path on the way."""
    while parent[i] != i:
        parent[i] = parent[parent[i]]
        i = parent[i]
    return int(i)


def _cell_offsets(reach: float) -> np.ndarray:
    """Half of the integer offsets of cells of width eps / 2 whose nearest
    points lie within reach cell widths, smallest first."""
    out = []
    for a in range(-3, 4):
        for b in range(-3, 4):
            for c in range(-3, 4):
                if (a, b, c) <= (0, 0, 0):
                    continue
                gap = sum(max(abs(o) - 1, 0) ** 2 for o in (a, b, c))
                if gap <= reach * reach:
                    out.append((a * a + b * b + c * c, a, b, c))
    return np.array([o[1:] for o in sorted(out)], np.int64)


def _grid(ijk: np.ndarray, pad: int):
    """The cells' linear codes over their bounding box widened by pad
    cells on every side: (code function, cell coordinates' codes)."""
    base = ijk.min(axis=0) - pad
    width = ijk.max(axis=0) - base + pad + 1

    def code(v):
        d = v - base
        return (d[:, 0] * width[1] + d[:, 1]) * width[2] + d[:, 2]
    return code, code(ijk)


def _block_counts(p64: np.ndarray, side: float) -> np.ndarray:
    """Each row's count of rows in the 3 x 3 x 3 cells of the given side
    around its own."""
    ijk = np.floor(p64 / side).astype(np.int64)
    code, own = _grid(ijk, 1)
    ucode, counts = np.unique(own, return_counts=True)
    total = np.zeros(len(p64), np.int64)
    for off in np.array([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]):
        nb = code(ijk + off)
        pos = np.clip(np.searchsorted(ucode, nb), 0, len(ucode) - 1)
        total += np.where(ucode[pos] == nb, counts[pos], 0)
    return total


def dbscan_chunk(pts: np.ndarray, eps: float, min_points: int):
    """DBSCAN of one chunk's kept float32 rows [m, 3] (in row order).
    Returns each row's representative int64[m]: the least core row index
    of its cluster, -1 for noise."""
    m = len(pts)
    rep = np.full(m, -1, np.int64)
    if m == 0:
        return rep
    eps2 = f32(eps) * f32(eps)
    r = math.sqrt(float(eps2))
    r_lo, r_hi = r * (1.0 - MARGIN), r * (1.0 + MARGIN)
    p64 = pts.astype(np.float64)
    # core: the 27 cells of eps / 4 around a row's own lie within 0.87 eps
    # of it, and min_points rows there settle it; the rest are counted by
    # the float32 predicate over the pairs inside r_hi
    core = _block_counts(p64, r / 4.0) >= min_points
    rest = np.flatnonzero(~core)
    if len(rest):
        qi, _ = _pairs_within(cKDTree(p64), pts, pts[rest], r_hi, eps2)
        core[rest] = np.bincount(qi, minlength=len(rest)) >= min_points
    ci = np.flatnonzero(core)
    if len(ci) == 0:
        return rep
    # components of the core rows: one eps / 2 cell is a clique (its
    # diagonal is 0.87 eps); neighbouring cells join on a core pair within eps
    cp = pts[ci]
    c64 = p64[ci]
    ijk = np.floor(c64 / (r / 2.0)).astype(np.int64)
    code, own = _grid(ijk, 3)
    ucode, first, cell = np.unique(own, return_index=True, return_inverse=True)
    cell = cell.reshape(-1)
    order = np.argsort(cell, kind="stable")
    starts = np.searchsorted(cell[order], np.arange(len(ucode)))
    ends = np.r_[starts[1:], len(order)]
    members = [order[s:e] for s, e in zip(starts, ends)]
    trees = {}
    parent = np.arange(len(ucode))
    uijk = ijk[first]
    for off in _cell_offsets(2.0 * (1.0 + MARGIN)):
        nb = code(uijk + off)
        pos = np.clip(np.searchsorted(ucode, nb), 0, len(ucode) - 1)
        has = np.flatnonzero(ucode[pos] == nb)
        if not len(has):
            continue
        parent = _find(parent)
        for a, b in zip(has, pos[has]):
            ra, rb = _root(parent, a), _root(parent, b)
            if ra == rb:
                continue
            if b not in trees:
                trees[b] = cKDTree(c64[members[b]])
            q = cp[members[a]]
            d, _ = trees[b].query(q.astype(np.float64), k=1, distance_upper_bound=r_hi)
            if not np.isfinite(d).any():
                continue
            if (d <= r_lo).any() or len(_pairs_within(trees[b], cp[members[b]], q, r_hi,
                                                      eps2)[0]):
                parent[max(ra, rb)] = min(ra, rb)
    comp = _find(parent)[cell]
    least = np.full(len(ucode), m, np.int64)
    np.minimum.at(least, comp, ci)
    rep[ci] = least[comp]
    # border rows: the least representative among their core neighbours
    border = np.flatnonzero(~core)
    if len(border):
        qi, ti = _pairs_within(cKDTree(c64), cp, pts[border], r_hi, eps2)
        lab = np.full(len(border), m, np.int64)
        np.minimum.at(lab, qi, rep[ci[ti]])
        rep[border] = np.where(lab < m, lab, -1)
    return rep


def chunked_labels(xyz: np.ndarray, keep: np.ndarray, cp: dict) -> np.ndarray:
    """Per-row cluster labels int64 of the padded tile: each chunk of
    chunk_size rows clustered alone, clusters numbered over the tile by
    ascending least core row; -1 noise or not kept."""
    cs = cp["chunk_size"]
    reps = np.full(len(xyz), -1, np.int64)
    for c0 in range(0, len(xyz), cs):
        rows = c0 + np.flatnonzero(keep[c0:c0 + cs])
        rep = dbscan_chunk(xyz[rows], cp["eps"], cp["min_points"])
        reps[rows] = np.where(rep >= 0, rows[np.maximum(rep, 0)], -1)
    uniq = np.unique(reps[reps >= 0])
    return np.where(reps >= 0, np.searchsorted(uniq, reps), -1)


def _project(x, y, angles):
    """float32 projections [P, A] of the rows on the angles (float32),
    each a fused multiply-add as the port forms it."""
    a64 = angles.astype(np.float64)
    c = np.cos(a64).astype(f32)[None, :]
    s = np.sin(a64).astype(f32)[None, :]
    xc, yc = x[:, None], y[:, None]
    u = fma32(xc, c, (yc * s).astype(f32))
    v = fma32(yc, c, (-(xc * s)).astype(f32))
    return u, v


def _rects(x, y, angles):
    """Per angle: (extent u, extent v, lo u, hi u, lo v, hi v), float32."""
    u, v = _project(x, y, angles)
    ulo, uhi, vlo, vhi = u.min(0), u.max(0), v.min(0), v.max(0)
    return (uhi - ulo).astype(f32), (vhi - vlo).astype(f32), ulo, uhi, vlo, vhi


def _answer(theta: float, eu, ev, ulo, uhi, vlo, vhi):
    """(north degrees, centre xy, [long, short]) of the rectangle at theta."""
    cu = (float(uhi) + float(ulo)) / 2.0
    cv = (float(vhi) + float(vlo)) / 2.0
    uvec = np.array([math.cos(theta), math.sin(theta)])
    vvec = np.array([-math.sin(theta), math.cos(theta)])
    axis = vvec if ev > eu else uvec
    north = (90.0 - math.degrees(math.atan2(axis[1], axis[0]))) % 360.0
    return north, cu * uvec + cv * vvec, [float(max(eu, ev)), float(min(eu, ev))]


def sort_obb(x, y, coarse: int = 32, refine: int = 17):
    """The sort-based search over one cluster's member rows (float32):
    (answer, ties) with answer (north, centre xy, [long, short]) and ties
    every answer within rounding of the least area."""
    step = f32(math.pi / 2.0 / coarse)
    half = refine // 2
    a1 = (np.arange(coarse, dtype=f32) * step).astype(f32)
    eu1, ev1 = _rects(x, y, a1)[:2]
    area1 = (eu1 * ev1).astype(f32)
    best1 = int(np.argmin(area1))
    r = float(np.abs(x).max() + np.abs(y).max())
    deltas = ((np.arange(refine, dtype=f32) - f32(half))
              * f32(math.pi / 2.0 / coarse / half)).astype(f32)

    def window(j):
        a2 = (f32(f32(j) * step) + deltas).astype(f32)
        eu, ev, ulo, uhi, vlo, vhi = _rects(x, y, a2)
        area = (eu * ev).astype(f32)
        best = int(np.argmin(area))
        tol = tie_tolerance(r, float(eu[best]), float(ev[best]))
        ans = [_answer(float(a2[j]), eu[j], ev[j], ulo[j], uhi[j], vlo[j], vhi[j])
               for j in range(refine)]
        return ans[best], [ans[j] for j in np.flatnonzero(area <= float(area[best]) + tol)]

    tol1 = tie_tolerance(r, float(eu1[best1]), float(ev1[best1]))
    answer, ties = window(best1)
    for j in np.flatnonzero(area1 <= float(area1[best1]) + tol1):
        if j != best1:
            ties = ties + window(int(j))[1]
    return answer, ties


def obb_stats(xyz: np.ndarray, labels: np.ndarray, k: int, cap: int) -> dict:
    """Per cluster below k: count, centre, extent (long, short, height),
    north angle and ties, from the first cap members in row order."""
    out = dict(count=np.zeros(k, np.int64), center=np.zeros((k, 3)), extent=np.zeros((k, 3)),
               north=np.zeros(k), ties=[[] for _ in range(k)])
    for i in range(min(k, int(labels.max(initial=-1)) + 1)):
        rows = np.flatnonzero(labels == i)
        if not len(rows):
            continue
        x, y, z = (xyz[rows[:cap], a] for a in range(3))
        (north, cxy, ext), ties = sort_obb(x, y)
        zlo, zhi = float(z.min()), float(z.max())
        out["count"][i] = len(rows)
        out["center"][i] = [*cxy, (zhi + zlo) / 2.0]
        out["extent"][i] = [*ext, zhi - zlo]
        out["north"][i] = north
        out["ties"][i] = ties
    return out


def extract(points: np.ndarray, params: dict, lower: str | None = None) -> dict:
    """The tile's per-chunk extraction: dict(labels int64[N], ground_keep
    bool[N], accepted bool[K], count, center (world), extent, north, ties)."""
    gp, cp = params["ground"], params["cluster"]
    if not cp["per_chunk"]:
        raise ValueError("the configuration does not cluster per chunk")
    points = np.asarray(points, np.float64).reshape(-1, 3)
    n = len(points)
    origin = points.mean(axis=0)
    xyz = (points - origin).astype(f32)
    if lower == "bfloat16":
        xyz = to_bfloat16(xyz)
    elif lower is not None:
        raise ValueError(f"unknown lower precision {lower!r}")
    cap = -(-max(n, 1) // cp["chunk_size"]) * cp["chunk_size"]
    padded = np.zeros((cap, 3), f32)
    padded[:n] = xyz
    z = xyz[:, 2]
    base = percentile_fma(z, gp["percentile"])
    keep = z > f32(base + f32(gp["offset"]))
    if keep.sum() < gp["min_points_after"]:
        keep = z > f32(base + f32(gp["retry_offset"]))
    kept = np.zeros(cap, bool)
    kept[:n] = keep
    labels = chunked_labels(padded, kept, cp)[:n]
    k = params["max_clusters"]
    stats = obb_stats(xyz, labels, k, min(16384, cap))
    stats["accepted"] = accept(stats, params["filters"])
    stats["center"] = stats["center"] + origin
    stats["ties"] = [[(nr, c + origin[:2], ext) for nr, c, ext in t] for t in stats["ties"]]
    return dict(labels=labels, ground_keep=keep, **stats)


def run(points: np.ndarray, config: dict, lower: str | None = None) -> dict:
    """The reference of one tile of a configuration."""
    return extract(points, config["params"], lower)
