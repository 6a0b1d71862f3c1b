"""Grid-accelerated Euclidean clustering (cell-graph DBSCAN).

Counterpart of ``pointcloudhookup_tpu/ops/cluster_grid.py::grid_dbscan``.
Space is cut into cells of eps/2 (all points of one cell are within eps of
each other); one sort groups the rows by cell, two segmented scans give
each row its cell's population (segscan kernel), the dense cells pack into
a table of at most max_cells rows in cell order (compactrows kernel), and
the cell graph is clustered by one ``cluster_cells`` call (cluster_converge
kernel: pop weighted by the cell populations, core rule, min-label
fixpoint, border adoption).  Point labels are one gather from the cells'.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.cluster import compact_labels
from pointcloudhookup_tpu_torch.ops.kernels.build import f32_scalar
from pointcloudhookup_tpu_torch.ops.kernels.cluster_converge import cluster_cells
from pointcloudhookup_tpu_torch.ops.kernels.compactrows import compact_rows_multi
from pointcloudhookup_tpu_torch.ops.segments import boundary_flags, segmented_scan

_SENTINEL = 2**30
_BIG = 3.0e38


def grid_dbscan(xyz, mask, eps, min_points: int, *, max_cells: int = 65536,
                max_iters: int | None = None, min_cell_points: int = 1):
    """Cell-graph DBSCAN.

    xyz float32[N,3], mask bool[N].  Returns (labels int32[N] compact ids /
    -1 noise, core bool[N], cells_overflow): the last is the number of
    DENSE cells that did not fit the table (float32 0-d tensor).  min_cell_points
    drops sparser cells before packing; cells beyond max_cells are dropped
    the same way (callers retry with a higher floor on overflow).  max_iters
    as in ``ops/cluster.py::dbscan``.

    The cell index is floor((xyz - mn) / cell), cell = eps / 2, rounded as
    the JAX function rounds it where it is called from:
      * eps a Python number is the configured eps, a compile-time constant
        inside the JAX ``extract_step``, where XLA:CPU multiplies by the
        f32 reciprocal of cell: so does this function;
      * eps a 0-d tensor is data-derived (``adaptive_cluster``'s), a traced
        value that XLA divides by: so does this function.
    (tests/test_torch_cluster.py::test_cell_index_rounds_as_xla.)"""
    n = xyz.shape[0]
    m = max_cells
    dev = xyz.device
    f32 = torch.float32
    eps_t = f32_scalar(eps, dev).reshape(())  # no host-to-device copy
    cell = eps_t / 2.0

    # ---- cell keys, rows sorted by (kx, ky, kz); order within a cell is free
    mn = torch.where(mask[:, None], xyz, _BIG).amin(dim=0)
    if isinstance(eps, torch.Tensor):
        q = (xyz - mn) / cell
    else:
        q = (xyz - mn) * (1.0 / cell)
    ijk = torch.where(mask[:, None], torch.floor(torch.where(mask[:, None], q, 0.0)),
                      float(_SENTINEL)).to(torch.int32)
    yz = (ijk[:, 1].to(torch.int64) << 31) | ijk[:, 2].to(torch.int64)
    order = torch.sort(yz, stable=True).indices
    order = order[torch.sort(ijk[order, 0], stable=True).indices]
    kx, ky, kz = (ijk[order, a] for a in range(3))
    valid_sorted = kx != _SENTINEL
    # masked rows sort last; each is a segment of its own, so the scans'
    # look-back never walks one long dead segment (same outputs)
    is_start = boundary_flags(kx, ky, kz) | ~valid_sorted

    # ---- per-row cell population: a reverse add puts the total on the
    # start row, a forward max spreads it over the cell
    totals = segmented_scan(torch.add, valid_sorted.to(torch.int32), is_start, reverse=True)
    count_row = segmented_scan(
        torch.maximum, torch.where(is_start, totals, 0), is_start
    )
    dense_row = valid_sorted & (count_row >= min_cell_points)
    dense_start = is_start & dense_row

    # packed cell index of each sorted row (m: dropped)
    pidx_row = torch.cumsum(dense_start.to(torch.int32), 0, dtype=torch.int32) - 1
    cell_sorted = torch.where(dense_row & (pidx_row < m), pidx_row, m)

    # ---- the dense-cell table: start rows compacted in cell order
    (counts_p, ckx, cky, ckz), n_true_dense = compact_rows_multi(
        dense_start, (count_row, kx, ky, kz), m
    )
    cell_alive = torch.arange(m, device=dev) < n_true_dense
    counts = torch.where(cell_alive, counts_p.to(f32), 0.0)
    centers = (torch.stack([ckx, cky, ckz], dim=1).to(f32) + 0.5) * cell
    centers = torch.where(cell_alive[:, None], centers, _BIG).contiguous()

    # row -> packed cell, back in input order
    cell_of_point = torch.empty(n, dtype=torch.int32, device=dev)
    cell_of_point[order] = cell_sorted

    # ---- the cell graph
    cell_labels, pop = cluster_cells(
        centers, counts, cell_alive, torch.arange(m, dtype=torch.int32, device=dev),
        eps_t * eps_t, float(min_points), max_iter=max_iters,
    )
    core_cell = cell_alive & (pop >= float(min_points))
    cell_labels = compact_labels(cell_labels, m)

    # ---- back to points
    in_table = mask & (cell_of_point < m)
    cp = torch.clamp(cell_of_point, 0, m - 1).long()
    labels = torch.where(in_table, cell_labels[cp], -1)
    core = in_table & core_cell[cp]
    return labels, core, torch.clamp(n_true_dense - m, min=0).to(f32)
