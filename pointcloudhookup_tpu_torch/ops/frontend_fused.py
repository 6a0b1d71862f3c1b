"""Fused extraction front-end: ONE Morton sort for downsample + cluster.

Counterpart of ``pointcloudhookup_tpu/ops/frontend_fused.py``: the same
stages, arithmetic and results as ``fused_downsample_ground_cluster`` and
``fused_extract_step`` there, on torch tensors (CPU or CUDA; every kernel
below dispatches on the tensors' device).  A cell of voxel * 2**k shares
the Morton PREFIX of its voxels, so one sort makes voxel runs and cell
runs contiguous:

  raw points --(ground pre-cut: compactrows)--> Morton keys --ONE sort-->
  voxel runs (geometric centres) --strided z percentile--> ground keep -->
  cell runs (prefix boundaries) --reverse segscan--> dense-cell table
  (compactrows or compactidx) --cluster_converge / core flood--> cell
  labels --segscan max fill--> per-voxel labels --obb_accumulate-->
  per-cluster stats --> filters.

Ported: geometric voxels, emit "codes", sort_mode "full" (the bench fast
path).  The off-default sort modes ("hier", "cell", "merge"), centroid
voxels (geometric_voxels=False), emit "xyz" and the sort-based OBB
(obb="sort") raise NotImplementedError naming their ROADMAP item; nothing
falls back silently.

f32 rounding follows the reference as XLA compiles it: a division by the
constant voxel size is a multiplication by its float32 reciprocal (XLA's
algebraic simplifier rewrites it), and the voxel and cell centre decodes
``t * vs + mn`` round once (XLA:CPU contracts them into a fused
multiply-add; ``ops/morton.py::fma_f32``).  Every scalar is a float32
tensor on the data's device, so CPU and CUDA round alike (CUDA turns a
division by a CPU scalar into a multiplication by its reciprocal).
"""

from __future__ import annotations

import math

import torch

from pointcloudhookup_tpu_torch.config import ExtractParams
from pointcloudhookup_tpu_torch.models.towers import filter_and_dedup
from pointcloudhookup_tpu_torch.ops.cluster import compact_labels
from pointcloudhookup_tpu_torch.ops.frontend_exact import _core_flood_cluster
from pointcloudhookup_tpu_torch.ops.kernels.cluster_converge import cluster_cells
from pointcloudhookup_tpu_torch.ops.kernels.compactidx import compact_indices
from pointcloudhookup_tpu_torch.ops.kernels.compactrows import (
    compact_rows,
    compact_rows_multi,
)
from pointcloudhookup_tpu_torch.ops.morton import (
    SENTINEL_HI,
    _compact10,
    fma_f32,
    morton_decode,
    morton_encode,
    shift_code,
)
from pointcloudhookup_tpu_torch.ops.obb import cluster_obb_stats_accum
from pointcloudhookup_tpu_torch.ops.percentile import masked_percentile
from pointcloudhookup_tpu_torch.ops.segments import segmented_scan

_BIG = 3.0e38
_LO_MASK = (1 << 30) - 1
_SORT_MODES = ("full", "hier", "cell", "merge")


def _scalar(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def morton_keys(xyz, mask, voxel_size: float = 0.1):
    """Voxel Morton codes of every row on a grid snapped to the global
    voxel lattice.  Returns (hi, lo, mn): masked-out rows carry
    SENTINEL_HI; mn float32[3] is the grid origin (the masked min corner
    floored to a multiple of voxel_size).  Division by voxel_size is a
    multiplication by its float32 reciprocal, as XLA compiles it."""
    vs = _scalar(voxel_size, xyz.device)
    inv = _scalar(1.0, xyz.device) / vs
    mn = torch.where(mask[:, None], xyz, _BIG).amin(dim=0)
    mn = torch.floor(mn * inv) * vs
    v = torch.floor((xyz - mn) * inv).to(torch.int32)
    hi, lo = morton_encode(v[:, 0], v[:, 1], v[:, 2])
    return torch.where(mask, hi, SENTINEL_HI), lo, mn


def precut_threshold(xyz, mask, params: ExtractParams, precut_margin: float = 0.25,
                     ground_override=None):
    """Raw-z threshold of the ground pre-cut and the base it came from.

    Without ground_override the base is the ground percentile of a
    strided raw-z sample (stride max(N >> 14, 16)); with it, the given
    (base, use_retry) and its offset.  Returns (threshold, base or None)."""
    gp = params.ground
    dev = xyz.device
    margin = _scalar(precut_margin, dev)
    if ground_override is not None:
        base_o, use_retry_o = ground_override
        off = torch.where(
            use_retry_o, _scalar(gp.retry_offset, dev), _scalar(gp.offset, dev)
        )
        return base_o + off - margin, None
    stride = max(xyz.shape[0] >> 14, 16)
    zs = xyz[::stride, 2]
    ms = mask[::stride]
    pre_base = masked_percentile(
        torch.where(ms, zs, torch.inf), ms, gp.percentile
    )
    return pre_base + _scalar(gp.offset, dev) - margin, pre_base


def pack_route(n: int, m: int) -> str:
    """How the dense-cell table is packed, as the JAX package routes it on
    its accelerator: compactrows with the row index as payload for
    N % 32768 == 0 and (N <= 2M rows or m >= 8192), else compact_indices
    (whose kernel here has no N % 32768 rule)."""
    if n % 32768 == 0 and (n <= (2 << 20) or m >= 8192):
        return "compactrows"
    return "compactidx"


def pack_dense_rows(dense_start, m: int, route: str | None = None):
    """rows_m int32[m]: the ascending rows of the first m dense-cell starts;
    slots past them hold N - 1 (the reference's clipped searchsorted)."""
    n = dense_start.shape[0]
    route = route or pack_route(n, m)
    if route == "compactidx":
        return compact_indices(dense_start, m)
    if route != "compactrows":
        raise ValueError(f"unknown pack route {route!r}")
    pos = torch.arange(n, dtype=torch.int32, device=dense_start.device)
    # one payload channel (the reference routes the row index as both
    # Morton words and clips the sentinel of dead slots to n - 1)
    (rows_c,), count = compact_rows_multi(dense_start, (pos,), m)
    live = torch.arange(m, device=dense_start.device) < torch.clamp(count, max=m)
    return torch.where(live, rows_c, n - 1)


def fused_downsample_ground_cluster(
    xyz,
    mask,
    params: ExtractParams = ExtractParams(),
    *,
    max_cells: int = 8192,
    min_cell_points: int = 2,
    cell_shift: int = 5,
    voxel_size: float = 0.1,
    geometric_voxels: bool = False,
    emit: str = "xyz",
    ground_override=None,
    return_cells_overflow: bool = False,
    sort_mode: str = "full",
    precut_div: int = 0,
    precut_margin: float = 0.25,
    core_flood_cells: int = 16384,
    core_cap: int = 16384,
    _cut: int = 0,
):
    """One-pass voxel downsample + global ground filter + cell-graph
    clustering, with geometric voxel centres and Morton codes out.

    xyz float32[N,3], mask bool[N] (one device).  Returns (hi, lo int32[C]
    Morton-sorted voxel codes, keep bool[C] kept-above-ground voxel start
    rows, labels int32[C] compact cluster ids at kept rows / -1, base
    float32, mn float32[3] grid origin); C = N, or the pre-cut capacity.
    return_cells_overflow appends cells_over (dense cells beyond
    max_cells + core-flood spill + pre-cut spill and retry flag) and
    hier_over (always 0 in sort_mode "full").  _cut 1-5 return the
    reference's early-exit intermediates: (hi, lo), (keep, base),
    (dense_start, ctot), (centers, ccount, cell_alive), (cell_labels,
    keep).  geometric_voxels and emit default as in the reference and
    must be given as True / "codes"."""
    if emit not in ("xyz", "codes"):
        raise ValueError(f"emit must be 'xyz' or 'codes', got {emit!r}")
    if emit == "codes" and not geometric_voxels:
        raise ValueError("emit='codes' requires geometric_voxels=True")
    if sort_mode not in _SORT_MODES:
        raise ValueError(
            f"sort_mode must be 'full', 'hier', 'cell' or 'merge', got {sort_mode!r}"
        )
    if sort_mode != "full" and not geometric_voxels:
        raise ValueError(f"sort_mode={sort_mode!r} requires geometric_voxels=True")
    if sort_mode != "full":
        raise NotImplementedError(
            f"sort_mode={sort_mode!r} is not ported yet (ROADMAP module item 11)"
        )
    if not geometric_voxels or emit != "codes":
        raise NotImplementedError(
            "the fused front-end's centroid voxels (geometric_voxels=False) and "
            "emit='xyz' are not ported yet (ROADMAP module item 13)"
        )
    n = xyz.shape[0]
    m = max_cells
    gp = params.ground
    cp = params.cluster
    dev = xyz.device
    f32 = torch.float32
    # cell-graph soundness: the cell diagonal must stay under eps, so
    # cell_shift is a cap that shrinks with eps
    safe_shift = int(math.floor(math.log2(
        max(cp.eps / (math.sqrt(3.0) * voxel_size), 1e-6))))
    cell_shift = max(2, min(cell_shift, safe_shift))
    shift3k = 3 * cell_shift
    vs = _scalar(voxel_size, dev)

    # ---- Morton keys
    hi, lo, mn = morton_keys(xyz, mask, voxel_size)

    # ---- ground pre-cut + stream compaction: the sort and every later
    # [N] pass run at the capacity.  The base comes from a strided raw-z
    # sample before the sort; capacity overflow and a retry on a pre-cut
    # tile fold into cells_over (the resolver re-runs the tile)
    precut_dropped = None
    precut_base = None
    if precut_div and n >= 131072 and n % 32768 == 0:
        cap = -(-(n // precut_div) // 32768) * 32768
        pre_thresh, precut_base = precut_threshold(
            xyz, mask, params, precut_margin, ground_override
        )
        keep_pre = mask & (xyz[:, 2] > pre_thresh)
        hi, lo, pre_count = compact_rows(keep_pre, hi, lo, cap)
        precut_dropped = torch.clamp(pre_count - cap, min=0).to(f32)
        n = cap

    # ---- ONE sort of the exact 2-word key: lo < 2**30, so (hi << 30) | lo
    # orders as lax.sort((hi, lo), num_keys=2) and SENTINEL_HI << 30 fits
    key = torch.sort((hi.to(torch.int64) << 30) | lo.to(torch.int64)).values
    hi = (key >> 30).to(torch.int32)
    lo = (key & _LO_MASK).to(torch.int32)
    if _cut == 1:
        return hi, lo

    # ---- voxel runs; only the z channel of the geometric centres feeds
    # the ground filter
    v_start = (hi != torch.roll(hi, 1)) | (lo != torch.roll(lo, 1))
    v_start[0] = True
    viz = _compact10(lo >> 2) | (_compact10(hi >> 2) << 10)
    zcol = fma_f32(viz.to(f32) + 0.5, vs, mn[2])
    voxel_valid = v_start & (hi != SENTINEL_HI)

    # ---- global ground percentile over the voxel centres
    if ground_override is not None:
        base, use_retry = ground_override
        off = torch.where(
            use_retry, _scalar(gp.retry_offset, dev), _scalar(gp.offset, dev)
        )
        keep = voxel_valid & (zcol > base + off)
    else:
        if precut_base is not None:
            base = precut_base
        else:
            # Morton-sorted rows make a strided sample spatially stratified
            stride = max(n >> 14, 16)
            vz_s = torch.where(voxel_valid, zcol, torch.inf)[::stride]
            base = masked_percentile(
                vz_s, voxel_valid[::stride], gp.percentile
            )
        keep = voxel_valid & (zcol > base + _scalar(gp.offset, dev))
        retry = keep.sum() < gp.min_points_after
        keep = torch.where(
            retry, voxel_valid & (zcol > base + _scalar(gp.retry_offset, dev)), keep
        )
        if precut_base is not None:
            # retry on a pre-cut tile: points between the two cuts were
            # dropped, so the caller must re-run without the pre-cut
            precut_dropped = precut_dropped + retry.to(f32)
    if _cut == 2:
        return keep, base

    # ---- cell runs (Morton prefix boundaries), populations of kept voxels
    if shift3k >= 30:
        c_hi = hi >> (shift3k - 30)
        c_lo = torch.zeros_like(lo)
    else:
        c_hi = hi
        c_lo = (lo >> shift3k) | ((hi & ((1 << shift3k) - 1)) << (30 - shift3k))
    c_start = (c_hi != torch.roll(c_hi, 1)) | (c_lo != torch.roll(c_lo, 1))
    c_start[0] = True
    ctot = segmented_scan(torch.add, keep.to(torch.int32), c_start, reverse=True)
    dense_start = c_start & (ctot >= min_cell_points)
    if _cut == 3:
        return dense_start, ctot

    # ---- dense-cell table: start rows, populations, decoded cell centres
    rows_m = pack_dense_rows(dense_start, m)
    rows_l = rows_m.long()
    ccount = ctot[rows_l].to(f32)
    d_hi, d_lo = shift_code(hi[rows_l], lo[rows_l], shift3k)
    cix, ciy, ciz = morton_decode(d_hi, d_lo)
    half_cell = float(1 << (cell_shift - 1)) if cell_shift > 0 else 0.5
    ccent = fma_f32(
        torch.stack([cix, ciy, ciz], dim=1).to(f32) * float(1 << cell_shift)
        + half_cell,
        vs, mn[None, :],
    )
    n_dense = dense_start.sum(dtype=torch.int32)
    cell_alive = torch.arange(m, device=dev) < n_dense
    ccount = torch.where(cell_alive, ccount, 0.0)
    centers = torch.where(cell_alive[:, None], ccent, _BIG).contiguous()
    if _cut == 4:
        return centers, ccount, cell_alive

    # ---- cell-graph clustering: the full-table converge kernel, or for
    # big tables the core flood (pop once, flood the compacted core cells)
    eps = _scalar(cp.eps, dev)
    eps2 = eps * eps
    core_flood_over = None
    if m >= core_flood_cells:
        cell_labels, core_flood_over = _core_flood_cluster(
            centers, ccount, cell_alive, eps2, cp.min_points, core_cap=core_cap,
        )
    else:
        cell_labels, _ = cluster_cells(
            centers, ccount, cell_alive, torch.arange(m, dtype=torch.int32, device=dev),
            eps2, float(cp.min_points),
        )
    cell_labels = compact_labels(cell_labels, m)
    if _cut == 5:
        return cell_labels, keep

    # ---- per-voxel labels: each live packed cell's label on its start row,
    # forward-filled over the cell run.  The reference scatters every slot
    # and its dead slots write -1 to row n - 1 after the live ones; only
    # live slots are written here (no repeated indices), and row n - 1
    # then takes the reference's result
    lab_at_start = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    lab_at_start[torch.where(cell_alive, rows_l, n)] = torch.where(
        cell_alive, cell_labels, -1
    )
    lab_at_start = lab_at_start[:n]
    lab_at_start[n - 1] = torch.where(n_dense < m, -1, lab_at_start[n - 1])
    lab_row = segmented_scan(torch.maximum, lab_at_start, c_start)
    labels = torch.where(keep & (lab_row >= 0), lab_row, -1)
    if not return_cells_overflow:
        return hi, lo, keep, labels, base, mn
    # dense cells beyond max_cells never get packed (their points stay
    # unlabeled); a spilled core-flood table or pre-cut have the same
    # remedy (split the tile), so they ride the same flag
    cells_over = torch.clamp(n_dense - m, min=0).to(f32)
    if core_flood_over is not None:
        cells_over = cells_over + core_flood_over
    if precut_dropped is not None:
        cells_over = cells_over + precut_dropped
    hier_over = torch.zeros((), dtype=f32, device=dev)
    return hi, lo, keep, labels, base, mn, cells_over, hier_over


def fused_extract_step(
    xyz,
    mask,
    params: ExtractParams = ExtractParams(),
    *,
    max_cells: int = 8192,
    min_cell_points: int = 2,
    geometric_voxels: bool = False,
    obb: str = "auto",
    sort_mode: str = "full",
    precut_div: int = 0,
):
    """Full fused front-end + OBB + filters (the bench fast path), on the
    geometric branch.  The OBB is always the sort-free accumulation over
    the Morton rows ("auto" picks it, as the JAX package does on its
    accelerator); obb="sort" raises until the sort-based OBB is ported."""
    if obb not in ("auto", "accum", "sort"):
        raise ValueError(f"obb must be 'auto', 'accum' or 'sort', got {obb!r}")
    if obb == "sort":
        raise NotImplementedError(
            "obb='sort' (cluster_obb_stats_codes) is not ported yet "
            "(ROADMAP module item 12)"
        )
    if not geometric_voxels:
        raise NotImplementedError(
            "the fused front-end's centroid voxels (geometric_voxels=False) are "
            "not ported yet (ROADMAP module item 13)"
        )
    hi, lo, keep, labels, base, mn, cells_over, hier_over = (
        fused_downsample_ground_cluster(
            xyz, mask, params, max_cells=max_cells,
            min_cell_points=min_cell_points, geometric_voxels=True, emit="codes",
            return_cells_overflow=True, sort_mode=sort_mode, precut_div=precut_div,
        )
    )
    stats = cluster_obb_stats_accum(
        hi, lo, labels, keep, mn, max_clusters=params.max_clusters,
        num_angles=params.obb_angles,
    )
    accepted = filter_and_dedup(stats, params.filters)
    return dict(labels=labels, ground_keep=keep, base_height=base,
                accepted=accepted, cells_overflow=cells_over,
                hier_runs_over=hier_over, **stats)
