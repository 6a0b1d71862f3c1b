"""Exact-semantics extraction front-end on one device.

Counterpart of ``pointcloudhookup_tpu/ops/frontend_exact.py``: the same
stages, the same arithmetic and the same result as ``exact_extract_graph``
there, on torch tensors (CPU or CUDA; every kernel below dispatches on the
tensors' device):

  1. exact P25 ground base by radix bisection, and the ground cut;
  2. survivor compaction (compactrows kernel);
  3. ONE cell-key sort (stable ``torch.sort``; the key is unique per cell);
  4. per-cell populations by a reverse segmented scan (segscan kernel);
  5. dense-cell table pack (compactrows kernel);
  6. cell-graph clustering: pop pass (neighbor kernel), min-label flood on
     the compacted core table (cluster_converge kernel), border adoption
     (neighbor kernel, lmin mode);
  7. label forward-fill (segscan kernel);
  8. sort-free OBB accumulation (obb_accum kernel), filters and dedup.

f32 rounding follows the reference: every scalar is a float32 tensor on
the data's device (CUDA turns a division by a CPU scalar into a
multiplication by its reciprocal, which would move cell boundaries).
"""

from __future__ import annotations

import math

import torch

from pointcloudhookup_tpu_torch.config import ExtractParams
from pointcloudhookup_tpu_torch.ops.cluster import compact_labels
from pointcloudhookup_tpu_torch.ops.kernels.cluster_converge import cluster_cells
from pointcloudhookup_tpu_torch.ops.kernels.compactrows import compact_rows_multi
from pointcloudhookup_tpu_torch.ops.kernels.neighbor import neighbor_reduce
from pointcloudhookup_tpu_torch.ops.kernels.obb_accum import obb_accumulate_xyz
from pointcloudhookup_tpu_torch.ops.morton import interleave_tight
from pointcloudhookup_tpu_torch.ops.obb import _compact_valid_rows, _obb_from_accum
from pointcloudhookup_tpu_torch.ops.percentile import masked_percentile_bisect
from pointcloudhookup_tpu_torch.ops.segments import segmented_scan

_KEY_SENTINEL = 0xFFFFFFFF
_BIG = 3.0e38


def _core_flood_cluster(centers, ccount, cell_alive, eps2, min_points,
                        core_cap: int = 16384, _cut: int = 0):
    """Cell-graph DBSCAN with the repeated passes on the core subgraph:

      1. one pairwise pass gives every dense cell's eps-ball population
         -> core mask;
      2. core cells compact (order-preserving) into a [core_cap] table and
         the min-label flood runs there (cluster_cells with min_points=0
         floods every live row); the min core-table index maps back to the
         min packed index;
      3. border cells adopt the min core-neighbor label in one more
         pairwise pass with allowed = core.

    Returns (labels int32[M] -- representative packed index, M = noise --
    and core_overflow float32: core cells beyond core_cap, which makes the
    result invalid; the caller escalates)."""
    m = centers.shape[0]
    dev = centers.device
    sent = torch.tensor(m, dtype=torch.int32, device=dev)
    iota_m = torch.arange(m, dtype=torch.int32, device=dev)

    # -- 1. pop over the full dense table
    pop, _ = neighbor_reduce(
        centers, torch.zeros(m, dtype=torch.int32, device=dev), ccount,
        cell_alive, eps2, sentinel=m, mode="pop",
    )
    core = cell_alive & (pop >= torch.tensor(float(min_points), dtype=torch.float32))
    if _cut == 41:
        return pop, torch.zeros((), dtype=torch.float32, device=dev)

    # -- 2. compact core cells; flood on the small table
    cap = min(core_cap, m)
    (core_rows,), n_core, core_overflow = _compact_valid_rows(
        core, (iota_m,), cap, fill=sent
    )
    slot_ok = torch.arange(cap, dtype=torch.int32, device=dev) < torch.clamp(
        n_core, max=cap
    )
    core_centers = torch.where(
        slot_ok[:, None], centers[torch.clamp(core_rows, 0, m - 1)], _BIG
    ).contiguous()
    tab_labels, _ = cluster_cells(
        core_centers, torch.ones(cap, dtype=torch.float32, device=dev), slot_ok,
        torch.arange(cap, dtype=torch.int32, device=dev), eps2, 0.0,
    )
    # core-table index -> original packed index (order-preserving)
    rep = torch.where(
        slot_ok & (tab_labels < cap),
        core_rows[torch.clamp(tab_labels, 0, cap - 1)],
        sent,
    )
    if _cut == 42:
        return rep, core_overflow

    # -- 3. labels back on the full table + border adoption.  Dead slots
    # write to a spare row m that is then cut off (the reference's
    # scatter mode="drop").
    lab_core = torch.full((m + 1,), m, dtype=torch.int32, device=dev)
    lab_core[torch.where(slot_ok, core_rows, sent).long()] = torch.where(
        slot_ok, rep, sent
    )
    lab_core = lab_core[:m]
    _, border = neighbor_reduce(
        centers, lab_core, torch.zeros(m, dtype=torch.float32, device=dev),
        core, eps2, sentinel=m, mode="lmin",
    )
    labels = torch.where(core, lab_core, torch.where(cell_alive, border, sent))
    return labels, core_overflow


def exact_cell_plan(span_xyz, eps: float):
    """Host-side plan: per-axis cell-key bit widths for a tile.

    span_xyz: per-axis extent in meters.  Returns (bx, by, bz) with
    sum <= 31 (the all-ones key is the invalid-row sentinel), or None when
    the tile's cell grid cannot be packed into one 32-bit key.  +2 index
    margin absorbs f32 floor() slack against the f64 host span."""
    cell = float(eps) / 2.0
    bits = []
    for s in span_xyz:
        max_idx = int(math.floor(max(float(s), 0.0) / cell)) + 2
        bits.append(max(max_idx.bit_length(), 1))
    if sum(bits) > 31:
        return None
    return tuple(bits)


def exact_extract_graph(
    xyz,
    mask,
    params: ExtractParams = ExtractParams(),
    *,
    cell_bits: tuple,
    compact_cap: int,
    max_cells: int = 65536,
    min_cell_points: int = 1,
    core_cap: int = 16384,
    _cut: int = 0,
    group=None,
    local_rows: int | None = None,
    return_acc: bool = False,
):
    """Exact extraction forward step on one device.

    xyz float32[N,3] centered coords, mask bool[N] (same device);
    compact_cap: survivor capacity; cell_bits from exact_cell_plan();
    core_cap: core-cell flood-table capacity (core_overflow > 0 makes the
    result INVALID: callers escalate).  local_rows: rows >= local_rows
    join the clustering but not the OBB accumulators; return_acc also
    returns the raw accumulators under 'acc'.

    group (the JAX function's ``axis_name``; a ``parallel.sharded.Group``,
    for the sharded exact step): the ground percentile is the exact one of
    every rank's masked rows, the retry decision counts every rank's
    survivors, and the cell grid's anchor is the minimum over the ranks,
    so every rank cuts and quantizes identically.

    Returns a dict of tensors: per-cluster stats [K] + accepted[K];
    labels_sorted int32[C] (cluster id / -1) and rows_sorted int32[C]
    (original row of each cell-sorted row, meaningful below
    compact_count); base_height, used_retry, compact_count (TRUE survivor
    count), cells_overflow (dense cells beyond max_cells, + 1.0 if the
    compaction capacity overflowed) and core_overflow.  _cut returns the
    named intermediates of one stage early (see the stage list)."""
    n = xyz.shape[0]
    m = max_cells
    c = compact_cap
    gp = params.ground
    cp = params.cluster
    if m % 1024:
        raise ValueError(f"max_cells {m} must be a multiple of 1024")
    if sum(cell_bits) > 31:
        raise ValueError(f"cell_bits {cell_bits} exceed 31 bits")
    dev = xyz.device
    f32 = torch.float32

    def scalar(v):
        return torch.tensor(v, dtype=f32, device=dev)

    eps = scalar(cp.eps)
    cell = eps / 2.0
    # the reference divides by the constant cell; XLA:CPU compiles that as
    # a product with its f32 reciprocal, which floors some rows into the
    # next cell at eps 6 or 3 (never at 5 or 8)
    inv_cell = 1.0 / cell

    # ---- exact ground base + cut
    z = xyz[:, 2].contiguous()
    base = masked_percentile_bisect(z, mask, gp.percentile, group)
    keep0 = mask & (z > base + scalar(gp.offset))
    n0 = keep0.sum(dtype=torch.int32)
    if group is not None:
        n0 = group.all_reduce(n0, "sum")
    used_retry = n0 < gp.min_points_after
    keep = torch.where(used_retry, mask & (z > base + scalar(gp.retry_offset)), keep0)
    if _cut == 1:
        return dict(base=base, keep=keep)

    # ---- compact survivors (raw coords + original row index)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    xb, yb, zb = (xyz[:, a].contiguous().view(torch.int32) for a in range(3))
    (xb, yb, zb, rows_c), cnt = compact_rows_multi(keep, (xb, yb, zb, idx), c)
    compact_over = (cnt > c).to(f32)
    xs0, ys0, zs0 = (v.view(f32) for v in (xb, yb, zb))
    valid0 = torch.arange(c, device=dev) < torch.clamp(cnt, max=c)
    if _cut == 2:
        return dict(xs0=xs0, cnt=cnt)

    # ---- cell keys against the kept-set f32 min corner
    mn = torch.stack([torch.where(valid0, v, _BIG).min() for v in (xs0, ys0, zs0)])
    if group is not None:
        mn = group.all_reduce(mn, "min")
    i0 = torch.floor((xs0 - mn[0]) * inv_cell).to(torch.int32)
    i1 = torch.floor((ys0 - mn[1]) * inv_cell).to(torch.int32)
    i2 = torch.floor((zs0 - mn[2]) * inv_cell).to(torch.int32)
    ck = interleave_tight(i0, i1, i2, cell_bits)
    ck = torch.where(valid0, ck, _KEY_SENTINEL)

    # ---- ONE single-key sort; coordinates + original rows follow
    ck_s, order = torch.sort(ck, stable=True)
    xs, ys, zs, rows_s = (v[order] for v in (xs0, ys0, zs0, rows_c))
    if _cut == 3:
        return dict(ck_s=ck_s, xs=xs)

    valid_s = ck_s != _KEY_SENTINEL
    c_start = ck_s != torch.roll(ck_s, 1)
    c_start[0] = True

    # ---- per-cell population -> dense-cell start flags
    ctot = segmented_scan(torch.add, valid_s.to(torch.int32), c_start, reverse=True)
    dense_start = c_start & valid_s & (ctot >= min_cell_points)

    # ---- pack the dense-cell table: start row, population and one member
    # coordinate per dense cell, in cell order.  Slots past n_dense hold
    # zeros and are masked by cell_alive everywhere below.
    n_dense = dense_start.sum(dtype=torch.int32)
    cell_alive = torch.arange(m, device=dev) < n_dense
    pos = torch.arange(c, dtype=torch.int32, device=dev)
    (rows_packed, ctot_p, pxb, pyb, pzb), _ = compact_rows_multi(
        dense_start,
        (pos, ctot, *(v.view(torch.int32) for v in (xs, ys, zs))),
        m,
    )
    rows_m = torch.clamp(rows_packed, max=c - 1)
    ccount = torch.where(cell_alive, ctot_p.to(f32), 0.0)
    px, py, pz = (v.view(f32) for v in (pxb, pyb, pzb))
    # cell centers recomputed from a member coordinate with the SAME f32
    # arithmetic as the key assignment
    cij = torch.stack(
        [torch.floor((p - mn[a]) * inv_cell) for a, p in enumerate((px, py, pz))],
        dim=1,
    )
    centers = torch.where(cell_alive[:, None], (cij + 0.5) * cell, _BIG)
    if _cut == 4:
        return dict(centers=centers, ccount=ccount, cell_alive=cell_alive)

    # ---- cell-graph clustering
    eps2 = eps * eps
    cell_labels, core_overflow = _core_flood_cluster(
        centers, ccount, cell_alive, eps2, cp.min_points,
        core_cap=core_cap, _cut=_cut,
    )
    if _cut in (41, 42):
        return dict(v=cell_labels, o=core_overflow)
    cell_labels = compact_labels(cell_labels, m)
    if _cut == 5:
        return dict(cell_labels=cell_labels)

    # ---- per-row labels: each packed cell's label lands on its start row
    # (dead slots go to the spare row c), then a forward max-fill across
    # the cell run
    lab_at_start = torch.full((c + 1,), -1, dtype=torch.int32, device=dev)
    lab_at_start[torch.where(cell_alive, rows_m, c).long()] = torch.where(
        cell_alive, cell_labels, -1
    )
    lab_row = segmented_scan(torch.maximum, lab_at_start[:c], c_start)
    labels_s = torch.where(valid_s & (lab_row >= 0), lab_row, -1)
    if _cut == 6:
        return dict(labels_s=labels_s)

    # ---- sort-free OBB over the raw coordinates + acceptance filters
    labels_acc = labels_s
    if local_rows is not None:
        labels_acc = torch.where(rows_s < local_rows, labels_s, -1)
    acc = obb_accumulate_xyz(
        xs, ys, zs, labels_acc, max_clusters=params.max_clusters,
        num_angles=params.obb_angles,
    )
    stats = _obb_from_accum(acc, params.max_clusters, params.obb_angles)
    # models.towers imports the ops package, which imports this module
    from pointcloudhookup_tpu_torch.models.towers import filter_and_dedup

    accepted = filter_and_dedup(stats, params.filters)

    cells_overflow = torch.clamp(n_dense - m, min=0).to(f32) + compact_over
    out = dict(
        accepted=accepted,
        labels_sorted=labels_s,
        rows_sorted=rows_s,
        base_height=base,
        used_retry=used_retry,
        compact_count=cnt,
        cells_overflow=cells_overflow,
        core_overflow=core_overflow,
        **stats,
    )
    if return_acc:
        out["acc"] = acc
    return out
