"""Multi-rank extraction over torch.distributed.

Counterpart of ``pointcloudhookup_tpu/parallel/sharded.py``.  The JAX
package shards a corridor's rows over a 1-D device mesh with
``shard_map``; here each rank is a process that holds its shard of rows
as tensors on its own device, and the collectives go through a
``parallel.group.Group`` (psum -> all_reduce(SUM), pmin/pmax ->
all_reduce(MIN/MAX), all_gather -> all_gather, ppermute -> send/recv
between ring neighbours):

  * the ground base is a global height percentile: per-rank histograms
    summed over the ranks, the same on every rank;
  * ranks exchange an eps-halo of boundary rows with their neighbours, so
    clustering near a slab edge sees the whole neighbourhood;
  * clustering and the raw OBB accumulators run rank-locally, on the
    port's kernels;
  * the accumulators are all-gathered, and every rank merges the
    fragments of a tower cut by a slab edge identically (union-find over
    box adjacency, then each group's accumulators combined), re-derives
    the stats and filters them: the merged geometry is the single-device
    run's over the union of the members, to f32 summation order.

Replicated compute is bit-identical on every rank: every cross-rank
reduction is of integers or a min/max, the merge sums each group in row
order, and the fragment union runs a fixed 16 rounds with no host read.
"""

from __future__ import annotations

import warnings

import torch

from pointcloudhookup_tpu_torch.config import ExtractParams
from pointcloudhookup_tpu_torch.models.towers import filter_and_dedup
from pointcloudhookup_tpu_torch.ops.cluster import dbscan
from pointcloudhookup_tpu_torch.ops.cluster_grid import grid_dbscan
from pointcloudhookup_tpu_torch.ops.frontend_exact import exact_extract_graph
from pointcloudhookup_tpu_torch.ops.frontend_fused import fused_downsample_ground_cluster
from pointcloudhookup_tpu_torch.ops.kernels.compactrows import compact_rows_multi
from pointcloudhookup_tpu_torch.ops.obb import (
    cluster_obb_accumulators,
    cluster_obb_accumulators_xyz,
    obb_stats_from_accumulators,
)
from pointcloudhookup_tpu_torch.ops.percentile import (
    _f32_full,
    histogram_counts,
    percentile_from_histogram,
)
from pointcloudhookup_tpu_torch.parallel.group import Group

_BIG = 3.0e38  # dead-row sentinel of the OBB accumulators
_UNION_ROUNDS = 16  # the JAX while_loop's cap
_FUSED_DEFAULT_CELLS = 8192


def tile_mesh(n_ranks: int | None = None) -> Group | None:
    """Group over the first n ranks of the default group (all of them by
    default): the counterpart of the JAX 1-D mesh over the first n
    devices.  Every rank of the default group must call it; the ranks
    outside the group get None."""
    world = torch.distributed.get_world_size()
    n = world if n_ranks is None else n_ranks
    if not 1 <= n <= world:
        raise ValueError(f"need 1 <= n_ranks <= {world}, got {n}")
    if n == world:
        return Group()
    pg = torch.distributed.new_group(list(range(n)))
    if torch.distributed.get_rank() >= n:
        return None
    return Group(pg)


def _global_ground_base(xyz, mask, params: ExtractParams, group: Group, num_bins: int = 4096):
    """The global height percentile and retry decision, the same on every
    rank (4 all-reduces: min, max, the histogram, the survivor count)."""
    gp = params.ground
    z = xyz[:, 2]
    lo = group.all_reduce(torch.where(mask, z, _BIG).min(), "min")
    hi = group.all_reduce(torch.where(mask, z, -_BIG).max(), "max")
    counts = group.all_reduce(histogram_counts(z, mask, lo, hi, num_bins), "sum")
    base = percentile_from_histogram(counts, lo, hi, gp.percentile)
    kept = (mask & (z > base + _f32_full(gp.offset, z.device))).sum(dtype=torch.int32)
    n_keep = group.all_reduce(kept, "sum")
    return base, n_keep < gp.min_points_after


def _fragment_union(aabb_min, aabb_max, alive, merge_radius):
    """Union-find over [K] fragments: two join when their axis-aligned
    boxes come within merge_radius on every axis.  Returns the min-index
    representative rep int32[K] (K for dead rows).  Exactly 16 rounds of
    the JAX loop's body, no host read: once the labels reach the fixpoint
    a round changes nothing, so the result is the JAX loop's, which stops
    there or after 16 rounds."""
    k = alive.shape[0]
    dev = alive.device
    rad = _f32_full(merge_radius, dev)
    gap_ok = (
        (aabb_min[:, None, :] - aabb_max[None, :, :] <= rad)
        & (aabb_min[None, :, :] - aabb_max[:, None, :] <= rad)
    ).all(dim=-1)
    adj = gap_ok & alive[:, None] & alive[None, :]
    iota = torch.arange(k, dtype=torch.int32, device=dev)
    sent = torch.full((), k, dtype=torch.int32, device=dev)
    rep = torch.where(alive, iota, sent)
    for _ in range(_UNION_ROUNDS):
        nm = torch.where(adj, rep[None, :], sent).amin(dim=1)
        new = torch.where(alive, torch.minimum(rep, nm), rep)
        rep = torch.where(
            alive, torch.minimum(new, new[torch.clamp(new, 0, k - 1).long()]), new
        )
    return rep


def _sum_in_row_order(v, grp, dk: int):
    """total[g] = the sum of v's rows in group g (grp int64[DK], DK = dead),
    added one at a time in row order from 0.0: XLA:CPU's segment_sum, a
    scatter-add over the rows in order, bit for bit on any device (CUDA
    atomics would add in a varying order).  A row's rank among its group's
    rows picks the round that adds it, so a round adds at most one row to
    each group.  One host read: the largest group's size."""
    dev = v.device
    idx = torch.arange(dk, device=dev)
    live = grp < dk
    rank = ((grp[:, None] == grp[None, :]) & (idx[None, :] < idx[:, None])).sum(dim=1)
    rounds = int(torch.where(live, rank + 1, 0).max()) if dk else 0
    total = torch.zeros((dk + 1,) + tuple(v.shape[1:]), dtype=v.dtype, device=dev)
    for r in range(rounds):
        total.index_add_(0, torch.where(live & (rank == r), grp, dk), v)
    return total[:dk]


def _merge_accumulators(acc, merge_radius):
    """Exact fragment merge over gathered [D*K] raw OBB accumulators:
    fragments join by box adjacency, and each group's accumulators are
    combined (cnt and sums summed, z and projection extremes min/maxed)
    onto the group's min-index row; other rows hold the dead values.  Every
    accumulator is a commutative monoid over members, so the combined row
    is the one a single device would make over the union of the members."""
    counts = acc["cnt"]
    dk = counts.shape[0]
    dev = counts.device
    alive = counts > 0.0
    # angle column 0 projects (u, v) onto (x, y): axis-aligned bounds
    aabb_min = torch.stack([acc["ulo"][:, 0], acc["vlo"][:, 0], acc["zlo"]], dim=1)
    aabb_max = torch.stack([acc["uhi"][:, 0], acc["vhi"][:, 0], acc["zhi"]], dim=1)
    rep = _fragment_union(aabb_min, aabb_max, alive, merge_radius)
    grp = torch.where(alive, rep, dk).long()
    idx = torch.arange(dk, dtype=torch.int32, device=dev)
    grp_min_idx = torch.full((dk + 1,), dk, dtype=torch.int32, device=dev).scatter_reduce(
        0, grp, torch.where(alive, idx, dk), "amin"
    )[:dk]
    repc = torch.clamp(rep, 0, dk - 1).long()
    is_rep = alive & (idx == grp_min_idx[repc])

    def keep(v):
        return is_rep if v.dim() == 1 else is_rep[:, None]

    sums = torch.stack([counts, acc["sx"], acc["sy"], acc["sz"]], dim=1)
    sums = torch.where(is_rep[:, None], _sum_in_row_order(sums, grp, dk)[repc], 0.0)

    def comb_ext(v, how, dead):
        init = torch.full((dk + 1,) + tuple(v.shape[1:]), dead, dtype=v.dtype, device=dev)
        index = grp.view((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
        total = init.scatter_reduce(0, index, v, how)[:dk]
        return torch.where(keep(v), total[repc], dead)

    return dict(
        cnt=sums[:, 0],
        sx=sums[:, 1],
        sy=sums[:, 2],
        sz=sums[:, 3],
        zlo=comb_ext(acc["zlo"], "amin", _BIG),
        zhi=comb_ext(acc["zhi"], "amax", -_BIG),
        ulo=comb_ext(acc["ulo"], "amin", _BIG),
        uhi=comb_ext(acc["uhi"], "amax", -_BIG),
        vlo=comb_ext(acc["vlo"], "amin", _BIG),
        vhi=comb_ext(acc["vhi"], "amax", -_BIG),
    )


def _halo_exchange(xyz, mask, group: Group, halo_width: float, halo_cap: int):
    """Send each neighbour the rows within halo_width of its x-extent (the
    ranks' extents are all-gathered) and append the rows received: ghosts
    give the clustering near a slab edge its whole eps-neighbourhood.
    Assumes rank order is slab order along x; where it is not, the ghosts
    sent are redundant or none, and redundant ghost fragments merge back
    into their home fragment.  Each side's ghosts are the first halo_cap
    such rows (a compactrows call), zeros past them.

    Returns (xyz_ext float32[N+2H, 3], mask_ext, is_local bool[N+2H],
    overflow float32: rows beyond halo_cap, summed over the ranks)."""
    n = xyz.shape[0]
    dev = xyz.device
    x = xyz[:, 0]
    my = group.rank
    gmin = group.all_gather(torch.where(mask, x, _BIG).min())  # [D]
    gmax = group.all_gather(torch.where(mask, x, -_BIG).max())
    has_r = my + 1 < group.size
    has_l = my > 0
    width = _f32_full(halo_width, dev)
    nbrmin_r = gmin[min(my + 1, group.size - 1)] if has_r else _f32_full(_BIG, dev)
    nbrmax_l = gmax[max(my - 1, 0)] if has_l else _f32_full(-_BIG, dev)
    send_r = mask & (x >= nbrmin_r - width) & has_r
    send_l = mask & (x <= nbrmax_l + width) & has_l
    bits = tuple(xyz[:, a].contiguous().view(torch.int32) for a in range(3))

    def select(sel):
        cols, cnt = compact_rows_multi(sel, bits, halo_cap)
        pts = torch.stack([c.view(torch.float32) for c in cols], dim=1)
        valid = torch.arange(halo_cap, device=dev) < torch.clamp(cnt, max=halo_cap)
        return pts, valid, torch.clamp(cnt - halo_cap, min=0).to(torch.float32)

    pts_r, val_r, over_r = select(send_r)
    pts_l, val_l, over_l = select(send_l)
    # ghosts from the left neighbour are what it sent rightward, and v.v.;
    # the edge ranks receive zeros, so their valid flags stay False
    ghost_l = group.shift(pts_r, +1)
    gval_l = group.shift(val_r, +1)
    ghost_r = group.shift(pts_l, -1)
    gval_r = group.shift(val_l, -1)
    xyz_ext = torch.cat([xyz, ghost_l, ghost_r])
    mask_ext = torch.cat([mask, gval_l, gval_r])
    is_local = torch.arange(n + 2 * halo_cap, device=dev) < n
    overflow = group.all_reduce(over_r + over_l, "sum")
    return xyz_ext, mask_ext, is_local, overflow


def _halo_capacity(n: int) -> int:
    """Ghost rows a side: generous for small shards, a bounded fraction
    with 16,384 alignment for big ones (N + 2H stays a multiple of 32,768
    when N is)."""
    if n >= 131072:
        return max(16384, -(-(n // 32) // 16384) * 16384)
    return max(512, -(-(n // 4) // 256) * 256)


def _gather_merge_finish(acc, params: ExtractParams, merge_radius, group: Group):
    """All-gather the raw accumulators (10 calls), merge exactly, finish
    the stats and filter: the same dict on every rank."""
    gathered = {
        key: group.all_gather(val).reshape((-1,) + tuple(val.shape[1:]))
        for key, val in acc.items()
    }
    merged_acc = _merge_accumulators(gathered, merge_radius)
    dk = merged_acc["cnt"].shape[0]
    merged = obb_stats_from_accumulators(merged_acc, dk, params.obb_angles)
    merged["accepted"] = filter_and_dedup(merged, params.filters)
    return merged


def make_sharded_extract(
    group: Group,
    params: ExtractParams = ExtractParams(),
    merge_radius: float = 6.0,
    fast_max_cells: int | None = None,
    mode: str = "modular",
    exact_cell_bits: tuple | None = None,
):
    """The multi-rank extraction step of this rank of ``group``.

    Returns ``step(xyz, mask)``: xyz float32[N, 3] and mask bool[N], this
    rank's shard of rows on its device (rank order = slab order along x);
    it returns (labels of the rank's rows, the merged dict of [D*K] tower
    stats with 'accepted', 'base_height', 'cells_overflow' and
    'halo_overflow', the same on every rank).  Every rank calls the step
    with the same N, as shard_map gives every device the same block.

    mode (the JAX function's ``fast=True`` is ``mode='fast'`` here):
      * 'modular': ground cut, ``grid_dbscan`` (method "grid", or "auto"
        above auto_grid_threshold rows) or ``dbscan``, accumulators over
        the local rows only;
      * 'fast': the fused front-end against the global ground base (its
        ground pre-cut at N/4 where the shard allows it); ghost rows stay
        in the accumulators (extremes are idempotent, counts may count a
        halo member twice);
      * 'exact': ``exact_extract_graph`` with the group (an exact global
        percentile, a global cell-grid anchor, ghosts excluded by row);
        needs exact_cell_bits from ``exact_cell_plan`` over the GLOBAL
        span.
    Labels: input order in 'modular'; the front-ends' compacted order in
    'fast' and cell-sorted order in 'exact', as in the JAX package.

    The fused front-end's dense-cell table (3.2 m cells) defaults to 8,192
    rows; ClusterParams.max_cells (sized for the modular grid's eps/2
    cells) is honoured below that, a larger non-default one is clamped
    with a warning; fast_max_cells (a multiple of 1,024) sizes it."""
    if mode not in ("modular", "fast", "exact"):
        raise ValueError(f"mode must be modular/fast/exact, got {mode!r}")
    if mode == "exact" and exact_cell_bits is None:
        raise ValueError(
            "mode='exact' needs exact_cell_bits: compute them host-side "
            "with ops.frontend_exact.exact_cell_plan over the GLOBAL "
            "corridor span (every rank must pack the same cell key)"
        )
    n_dev = group.size
    cp = params.cluster
    fused_cells = None
    if mode == "fast":
        if fast_max_cells is not None:
            if fast_max_cells % 1024:
                raise ValueError("fast_max_cells must be a multiple of 1024")
            fused_cells = fast_max_cells
        elif cp.max_cells <= _FUSED_DEFAULT_CELLS:
            fused_cells = cp.max_cells
        else:
            fused_cells = _FUSED_DEFAULT_CELLS
            if cp.max_cells != 65536:  # non-default: the caller meant it
                warnings.warn(
                    f"sharded fast path: ClusterParams.max_cells={cp.max_cells} "
                    f"exceeds the fused cell-table default {_FUSED_DEFAULT_CELLS}; "
                    "clamping. Pass fast_max_cells to size the fused table "
                    "explicitly.",
                    stacklevel=2,
                )

    def with_halo(xyz, mask):
        """Ghost rows from the neighbours (none on one rank).  The ground
        base counts local rows only."""
        n = xyz.shape[0]
        if n_dev == 1:
            ones = torch.ones(n, dtype=torch.bool, device=xyz.device)
            return xyz, mask, ones, _f32_full(0.0, xyz.device)
        return _halo_exchange(xyz, mask, group, 2.0 * cp.eps, _halo_capacity(n))

    def finish(acc, base, cells_over, halo_over):
        merged = _gather_merge_finish(acc, params, merge_radius, group)
        merged["base_height"] = base
        merged["cells_overflow"] = group.all_reduce(cells_over, "sum")
        merged["halo_overflow"] = halo_over
        return merged

    def fast_step(xyz, mask):
        base, use_retry = _global_ground_base(xyz, mask, params, group)
        xyz_e, mask_e, _, halo_over = with_halo(xyz, mask)
        hi, lo, keep, labels, _, mn, cells_over, _ = fused_downsample_ground_cluster(
            xyz_e, mask_e, params, max_cells=fused_cells,
            min_cell_points=cp.min_cell_points, geometric_voxels=True,
            emit="codes", ground_override=(base, use_retry),
            return_cells_overflow=True, precut_div=4,
        )
        acc = cluster_obb_accumulators(
            hi, lo, labels, keep, mn, max_clusters=params.max_clusters,
            num_angles=params.obb_angles,
        )
        return labels, finish(acc, base, cells_over, halo_over)

    def step(xyz, mask):
        n = xyz.shape[0]
        base, use_retry = _global_ground_base(xyz, mask, params, group)
        xyz_e, mask_e, is_local, halo_over = with_halo(xyz, mask)
        gp = params.ground
        off = torch.where(use_retry, _f32_full(gp.retry_offset, xyz.device),
                          _f32_full(gp.offset, xyz.device))
        keep = mask_e & (xyz_e[:, 2] > base + off)
        if cp.method == "grid" or (cp.method == "auto" and n > cp.auto_grid_threshold):
            labels, _, cells_over = grid_dbscan(
                xyz_e, keep, cp.eps, cp.min_points, max_cells=cp.max_cells,
                min_cell_points=cp.min_cell_points,
            )
        else:
            labels, _ = dbscan(xyz_e, keep, cp.eps, cp.min_points)
            cells_over = _f32_full(0.0, xyz.device)
        # input-order labels: ghosts are left to their home rank exactly
        acc = cluster_obb_accumulators_xyz(
            xyz_e, labels, keep & is_local, max_clusters=params.max_clusters,
            num_angles=params.obb_angles,
        )
        return labels[:n], finish(acc, base, cells_over, halo_over)

    def exact_step(xyz, mask):
        n = xyz.shape[0]
        xyz_e, mask_e, _, halo_over = with_halo(xyz, mask)
        ne = xyz_e.shape[0]
        # the JAX package's accelerator branch sizes the survivor table in
        # 32,768-row blocks; its CPU branch at N/4 (the CPU tests' sizes)
        if xyz.is_cuda:
            cap = -(-max(ne // 4, 32768) // 32768) * 32768
        else:
            cap = max(ne // 4, 1024)
        # the dense cells come from the compacted survivors, so a cell
        # table larger than cap can never fill
        mc = min(cp.max_cells, -(-max(cap, 1024) // 1024) * 1024)
        out = exact_extract_graph(
            xyz_e, mask_e, params, cell_bits=exact_cell_bits, compact_cap=cap,
            max_cells=mc, min_cell_points=cp.min_cell_points,
            group=group, local_rows=n, return_acc=True,
        )
        cells_over = out["cells_overflow"] + out["core_overflow"]
        return out["labels_sorted"], finish(out["acc"], out["base_height"], cells_over,
                                            halo_over)

    return {"modular": step, "fast": fast_step, "exact": exact_step}[mode]

