"""Fused extraction front-end: ONE Morton sort for downsample + cluster.

Counterpart of ``pointcloudhookup_tpu/ops/frontend_fused.py``: the same
stages, arithmetic and results as ``fused_downsample_ground_cluster`` and
``fused_extract_step`` there, on torch tensors (CPU or CUDA; every kernel
below dispatches on the tensors' device).  A cell of voxel * 2**k shares
the Morton PREFIX of its voxels, so one sort makes voxel runs and cell
runs contiguous:

  raw points --(ground pre-cut: compactrows)--> Morton keys --ONE sort-->
  voxel runs (geometric centres or centroids) --z percentile--> ground
  keep --> cell runs (prefix boundaries) --reverse segscan--> dense-cell
  table (compactrows or compactidx) --cluster_converge / core flood-->
  cell labels --segscan max fill--> per-voxel labels --obb_accumulate or
  label sort--> per-cluster stats --> filters.

The sort has four modes, as in the reference:
  * "full": one sort of the exact 2-word key (hi << 30) | lo;
  * "merge": the same order through the mergesort kernels, a block sort
    and merge-path rounds (N a power of two >= 2 * 8192; other N take the
    "full" sort, as the reference routes them);
  * "hier": one stable sort of the u32 cell key k1 with the within-cell
    code w as payload, then the winsort kernel restores (k1, w) order in
    windows of hier_window rows at offsets 0 and W/2 -- exact wherever a
    cell's run is at most W/2 + 1 rows;
  * "cell": one stable sort of a cell key (the u32 cell code, or with a
    cell_plan the tight interleave of the cell coordinates plus the top g
    within-cell bits), no order restored; the dupwin kernel flags each
    voxel's first row within a window of depth rows (16 with a plan, 64
    without; 0 with a plan whose key holds the whole voxel code: an
    adjacent compare).
u32 keys are held in int64 and wrap modulo 2**32 where the reference's u32
shifts do; 0xFFFFFFFF marks masked rows and sorts last.  The reference's
single-key sorts leave payload order within a run unspecified; the port's
are stable, so CPU and CUDA give the same rows.

f32 rounding follows the reference as XLA compiles it: a division by the
constant voxel size is a multiplication by its float32 reciprocal (XLA's
algebraic simplifier rewrites it), and the voxel and cell centre decodes
``t * vs + mn`` round once (XLA:CPU contracts them into a fused
multiply-add; ``ops/morton.py::fma_f32``).  Every scalar is a float32
tensor on the data's device, so CPU and CUDA round alike (CUDA turns a
division by a CPU scalar into a multiplication by its reciprocal).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from pointcloudhookup_tpu_torch.config import ExtractParams
from pointcloudhookup_tpu_torch.ops.cluster import compact_labels
from pointcloudhookup_tpu_torch.ops.frontend_exact import _core_flood_cluster
from pointcloudhookup_tpu_torch.ops.kernels.cluster_converge import cluster_cells
from pointcloudhookup_tpu_torch.ops.kernels.compactidx import compact_indices
from pointcloudhookup_tpu_torch.ops.kernels.compactrows import (
    compact_rows,
    compact_rows_multi,
)
from pointcloudhookup_tpu_torch.ops.kernels.dupwin import first_occurrence_flags
from pointcloudhookup_tpu_torch.ops.kernels.mergesort import (
    merge_sort_2key,
    merge_sort_eligible,
)
from pointcloudhookup_tpu_torch.ops.kernels.winsort import window_sort_w
from pointcloudhookup_tpu_torch.ops.morton import (
    SENTINEL_HI,
    _compact10,
    fma_f32,
    interleave_tight,
    morton_decode,
    morton_encode,
    shift_code,
)
from pointcloudhookup_tpu_torch.ops.obb import (
    cluster_obb_stats,
    cluster_obb_stats_accum,
    cluster_obb_stats_codes,
)
from pointcloudhookup_tpu_torch.ops.percentile import masked_percentile
from pointcloudhookup_tpu_torch.ops.segments import segmented_scan

log = logging.getLogger(__name__)

_BIG = 3.0e38
_LO_MASK = (1 << 30) - 1
_U32 = 0xFFFFFFFF
_SORT_MODES = ("full", "hier", "cell", "merge")


def _scalar(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def _effective_cell_shift(eps: float, voxel_size: float, cell_shift: int) -> int:
    """cell_shift capped so the cell diagonal stays under eps (cell-graph
    soundness: points in diagonal-adjacent cells can be arbitrarily close)."""
    safe_shift = int(math.floor(math.log2(
        max(eps / (math.sqrt(3.0) * voxel_size), 1e-6))))
    return max(2, min(cell_shift, safe_shift))


def hier_sort_eligible(span_xyz, voxel_size: float = 0.1,
                       cell_shift: int = 5) -> bool:
    """True when a tile's Morton codes fit the single-u32 cell key of
    sort_mode "hier" (max code >> 3 * cell_shift < 2**32 - 1).  span_xyz:
    per-axis extent in metres (max - min), host values; the max-corner code
    bounds every point's code."""
    idx = np.floor(np.asarray(span_xyz, np.float64) / float(voxel_size)).astype(np.int64)
    if (idx >= (1 << 20)).any() or (idx < 0).any():
        return False

    def _spread(v):
        v = int(v)
        out = 0
        for b in range(20):
            out |= ((v >> b) & 1) << (3 * b)
        return out

    code = _spread(idx[0]) | (_spread(idx[1]) << 1) | (_spread(idx[2]) << 2)
    return (code >> (3 * cell_shift)) < _U32


def cell_sort_plan(span_xyz, eps: float = 8.0, voxel_size: float = 0.1,
                   cell_shift: int = 5):
    """Host-side plan of sort_mode "cell" with a TIGHT packed key: the cell
    coordinates interleaved with per-axis widths from the tile span, plus
    the top g bits of the within-cell code, which shrink equal-key runs and
    with them the dedup window (depth 16; 0 when the key holds the whole
    voxel code).  Returns (bx, by, bz, g, depth), or None when the tile
    cannot use the packed key."""
    idx = np.floor(np.asarray(span_xyz, np.float64) / float(voxel_size)).astype(np.int64)
    if (idx >= (1 << 20)).any() or (idx < 0).any():
        return None
    cs = _effective_cell_shift(eps, voxel_size, cell_shift)
    bits = [max(int(v).bit_length(), 1) for v in idx]
    cell_bits = sum(max(b - cs, 0) for b in bits)
    if cell_bits > 30:
        return None
    g = min(32 - cell_bits, 3 * cs)
    if g < 2:
        return None
    depth = 0 if g == 3 * cs else 16
    return (bits[0], bits[1], bits[2], g, depth)


def morton_keys(xyz, mask, voxel_size: float = 0.1):
    """Voxel Morton codes of every row on a grid snapped to the global
    voxel lattice.  Returns (hi, lo, mn, v): masked-out rows carry
    SENTINEL_HI; mn float32[3] is the grid origin (the masked min corner
    floored to a multiple of voxel_size); v int32[N,3] the voxel indices.
    Division by voxel_size is a multiplication by its float32 reciprocal,
    as XLA compiles it."""
    vs = _scalar(voxel_size, xyz.device)
    inv = _scalar(1.0, xyz.device) / vs
    mn = torch.where(mask[:, None], xyz, _BIG).amin(dim=0)
    mn = torch.floor(mn * inv) * vs
    v = torch.floor((xyz - mn) * inv).to(torch.int32)
    hi, lo = morton_encode(v[:, 0], v[:, 1], v[:, 2])
    return torch.where(mask, hi, SENTINEL_HI), lo, mn, v


def sort_codes(hi, lo):
    """(hi, lo) sorted lexicographically: ONE sort of the exact 2-word key;
    lo < 2**30, so (hi << 30) | lo orders as the pair and SENTINEL_HI << 30
    fits."""
    key = torch.sort((hi.to(torch.int64) << 30) | lo.to(torch.int64)).values
    return (key >> 30).to(torch.int32), (key & _LO_MASK).to(torch.int32)


def cell_key(hi, lo, mask, shift3k: int):
    """The u32 cell key of sort_mode "hier" and of "cell" without a plan,
    sorted: k1 = (hi << (30 - 3k)) | (lo >> 3k) modulo 2**32 (0xFFFFFFFF on
    masked rows), by one stable sort, and the within-cell code w16 =
    lo & (2**3k - 1) riding along.  Returns (k1 int64, w16 int32)."""
    k1 = ((hi.to(torch.int64) << (30 - shift3k)) | (lo.to(torch.int64) >> shift3k)) & _U32
    k1 = torch.where(mask, k1, _U32)
    w16 = lo & ((1 << shift3k) - 1)
    k1, perm = torch.sort(k1, stable=True)
    return k1, w16[perm]


def codes_from_cell_key(k1, w16, shift3k: int):
    """The (hi, lo) Morton words of a cell key and its within-cell code;
    SENTINEL_HI where k1 is 0xFFFFFFFF."""
    lo = (((k1 & ((1 << (30 - shift3k)) - 1)) << shift3k) | w16).to(torch.int32)
    hi = torch.where(k1 == _U32, SENTINEL_HI, (k1 >> (30 - shift3k)).to(torch.int32))
    return hi, lo


def tight_cell_key(v, hi, lo, mask, cell_plan, cell_shift: int):
    """The packed key of sort_mode "cell" with a cell_plan (bx, by, bz, g,
    depth): ksort = (interleave_tight(v >> cs) << g) | (top g bits of the
    within-cell code), modulo 2**32, 0xFFFFFFFF on masked rows, by one
    stable sort with hi and lo riding along.  Returns (ksort int64, hi, lo,
    w_low int32): w_low holds the within-cell bits below the top g, -1 on
    masked rows (never equal to a real row's)."""
    bxp, byp, bzp, gbits, _ = cell_plan
    cs = cell_shift
    shift3k = 3 * cs
    cbits = (max(bxp - cs, 0), max(byp - cs, 0), max(bzp - cs, 0))
    ck = interleave_tight(v[:, 0] >> cs, v[:, 1] >> cs, v[:, 2] >> cs, cbits)
    w15 = (lo & ((1 << shift3k) - 1)).to(torch.int64)
    ksort = ((ck << gbits) | (w15 >> (shift3k - gbits))) & _U32
    ksort = torch.where(mask, ksort, _U32)
    ksort, perm = torch.sort(ksort, stable=True)
    hi, lo = hi[perm], lo[perm]
    w_low = torch.where(hi == SENTINEL_HI, -1, lo & ((1 << (shift3k - gbits)) - 1))
    return ksort, hi, lo, w_low


def _run_starts(key):
    start = key != torch.roll(key, 1)
    start[0] = True
    return start


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
    (rows_c,), _ = compact_rows_multi(dense_start, (pos,), m, fills=(n - 1,))
    return rows_c


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
    hier_window: int = 256,
    cell_plan=None,
    precut_div: int = 0,
    precut_margin: float = 0.25,
    core_flood_cells: int = 16384,
    core_cap: int = 16384,
    _cut: int = 0,
):
    """One-pass voxel downsample + global ground filter + cell-graph
    clustering.

    xyz float32[N,3], mask bool[N] (one device).  With emit "codes"
    (geometric voxels only) returns (hi, lo int32[C] Morton-sorted voxel
    codes, keep bool[C] kept-above-ground voxel start rows, labels int32[C]
    compact cluster ids at kept rows / -1, base float32, mn float32[3] grid
    origin); C = N, or the pre-cut capacity (sort_mode "full" only).  With
    emit "xyz" returns (ds_xyz float32[N,3] voxel centres -- geometric, or
    centroids of the voxel's points -- at voxel start rows, 0 elsewhere,
    keep, labels, base).  return_cells_overflow appends cells_over (dense
    cells beyond max_cells + core-flood spill + pre-cut spill and retry
    flag) and hier_over (runs longer than the hier/cell dedup guarantee).
    _cut 1-5 return the reference's early-exit intermediates: (hi, lo),
    (keep, base), (dense_start, ctot), (centers, ccount, cell_alive),
    (cell_labels, keep)."""
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
    n = xyz.shape[0]
    m = max_cells
    gp = params.ground
    cp = params.cluster
    dev = xyz.device
    f32 = torch.float32
    cell_shift = _effective_cell_shift(cp.eps, voxel_size, cell_shift)
    shift3k = 3 * cell_shift
    vs = _scalar(voxel_size, dev)

    # ---- Morton keys
    hi, lo, mn, v = morton_keys(xyz, mask, voxel_size)

    # ---- ground pre-cut + stream compaction ("full" sort only): the sort
    # and every later [N] pass run at the capacity.  The base comes from a
    # strided raw-z sample before the sort; capacity overflow and a retry
    # on a pre-cut tile fold into cells_over (the resolver re-runs the tile)
    precut_dropped = None
    precut_base = None
    if precut_div and sort_mode == "full" and geometric_voxels and emit == "codes" \
            and n >= 131072 and n % 32768 == 0:
        cap = -(-(n // precut_div) // 32768) * 32768
        pre_thresh, precut_base = precut_threshold(
            xyz, mask, params, precut_margin, ground_override
        )
        keep_pre = mask & (xyz[:, 2] > pre_thresh)
        hi, lo, pre_count = compact_rows(keep_pre, hi, lo, cap)
        precut_dropped = torch.clamp(pre_count - cap, min=0).to(f32)
        n = cap

    # ---- the sort.  v_first: first-occurrence flags of the voxels where
    # rows of a voxel need not be adjacent (cell mode); run_key: the sort
    # key whose runs the cell-mode dedup guarantee counts
    v_first = None
    run_key = None
    depth = 0
    if not geometric_voxels:
        key, perm = torch.sort((hi.to(torch.int64) << 30) | lo.to(torch.int64), stable=True)
        hi = (key >> 30).to(torch.int32)
        lo = (key & _LO_MASK).to(torch.int32)
        sx, sy, sz = (xyz[perm, a] for a in range(3))
        w = mask.to(f32)[perm]
    elif sort_mode == "cell" and cell_plan is not None:
        depth = cell_plan[4]
        run_key, hi, lo, w_low = tight_cell_key(v, hi, lo, mask, cell_plan, cell_shift)
        if depth == 0:
            v_first = _run_starts(run_key)
        else:
            v_first = first_occurrence_flags(run_key, w_low, depth)
    elif sort_mode == "cell":
        depth = 64
        run_key, w16 = cell_key(hi, lo, mask, shift3k)
        v_first = first_occurrence_flags(run_key, w16, depth)
        hi, lo = codes_from_cell_key(run_key, w16, shift3k)
    elif sort_mode == "hier":
        k1, w16 = cell_key(hi, lo, mask, shift3k)
        w16 = window_sort_w(k1, w16, hier_window)
        hi, lo = codes_from_cell_key(k1, w16, shift3k)
    elif sort_mode == "merge" and merge_sort_eligible(n):
        hi, lo = merge_sort_2key(hi, lo)
    else:
        if sort_mode == "merge":
            log.debug("sort_mode='merge' needs a power-of-two N >= 16384 (N=%d): "
                      "one sort of the whole key, as the reference routes it", n)
        hi, lo = sort_codes(hi, lo)
    if _cut == 1:
        return hi, lo

    # ---- voxel runs -> geometric centres or centroids at run-start rows
    v_start = v_first if v_first is not None else (
        (hi != torch.roll(hi, 1)) | (lo != torch.roll(lo, 1))
    )
    v_start[0] = True
    vcent = None
    if geometric_voxels and emit == "codes":
        # only the z channel feeds the ground filter
        viz = _compact10(lo >> 2) | (_compact10(hi >> 2) << 10)
        zcol = fma_f32(viz.to(f32) + 0.5, vs, mn[2])
        voxel_valid = v_start & (hi != SENTINEL_HI)
    elif geometric_voxels:
        vcent = fma_f32(torch.stack(morton_decode(hi, lo), dim=1).to(f32) + 0.5,
                        vs, mn[None, :])
        zcol = vcent[:, 2]
        voxel_valid = v_start & (hi != SENTINEL_HI)
    else:
        # per-voxel sums of x, y, z and the weight at the run starts: one
        # reverse segmented scan of the four columns
        vals = torch.stack([sx * w, sy * w, sz * w, w], dim=1)
        vtot = segmented_scan(torch.add, vals, v_start, reverse=True)
        vcount = vtot[:, 3]
        vcent = vtot[:, :3] / torch.clamp(vcount, min=1.0)[:, None]
        zcol = vcent[:, 2]
        voxel_valid = v_start & (vcount > 0.0) & (hi != SENTINEL_HI)

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
        elif geometric_voxels:
            # Morton-sorted rows make a strided sample spatially stratified
            stride = max(n >> 14, 16)
            vz_s = torch.where(voxel_valid, zcol, torch.inf)[::stride]
            base = masked_percentile(
                vz_s, voxel_valid[::stride], gp.percentile
            )
        else:
            base = masked_percentile(
                torch.where(voxel_valid, zcol, torch.inf), voxel_valid, gp.percentile
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
    if emit == "codes":
        out = (hi, lo, keep, labels, base, mn)
    else:
        out = (torch.where(voxel_valid[:, None], vcent, 0.0), keep, labels, base)
    if not return_cells_overflow:
        return out
    # dense cells beyond max_cells never get packed (their points stay
    # unlabeled); a spilled core-flood table or pre-cut have the same
    # remedy (split the tile), so they ride the same flag
    cells_over = torch.clamp(n_dense - m, min=0).to(f32)
    if core_flood_over is not None:
        cells_over = cells_over + core_flood_over
    if precut_dropped is not None:
        cells_over = cells_over + precut_dropped
    # hier/cell dedup-exactness guard: runs longer than the guarantee
    # (W/2 + 1 rows per cell for hier; depth + 1 rows per equal sort key
    # for cell) may count a duplicate voxel twice -- reported, never
    # dropping a tower
    if sort_mode == "hier" or (sort_mode == "cell" and depth > 0):
        if sort_mode == "hier":
            guarantee, g_start = hier_window // 2 + 1, c_start
        else:
            guarantee, g_start = depth + 1, _run_starts(run_key)
        rtot = segmented_scan(
            torch.add, torch.ones(n, dtype=torch.int32, device=dev), g_start, reverse=True
        )
        hier_over = (g_start & (rtot > guarantee)).sum(dtype=torch.int32).to(f32)
    else:
        hier_over = torch.zeros((), dtype=f32, device=dev)
    return (*out, cells_over, hier_over)


def fused_extract_step(
    xyz,
    mask,
    params: ExtractParams = ExtractParams(),
    *,
    max_cells: int = 8192,
    min_cell_points: int = 2,
    geometric_voxels: bool = False,
    per_cluster_cap: int = 16384,
    points_cap: int | None = None,
    obb: str = "auto",
    sort_mode: str = "full",
    hier_window: int = 256,
    cell_plan=None,
    precut_div: int = 0,
):
    """Full fused front-end + OBB + filters (the bench fast path).

    With geometric voxels the OBB consumes the Morton codes: obb "accum"
    (and "auto", the JAX package's choice on its accelerator) accumulates
    over the rows with the obb_accumulate kernel, exact with no member cap;
    "sort" label-sorts and densifies members into [K, P]
    (cluster_obb_stats_codes; points_cap compacts labelled rows first,
    per_cluster_cap bounds P, spills are counted in 'overflow').  Centroid
    voxels (geometric_voxels=False) take the reference's branch: the
    default sort, no pre-cut, and the sort-based OBB over the voxel
    centroids (cluster_obb_stats), with ds_xyz in the result."""
    # models.towers imports the ops package, which imports this module
    from pointcloudhookup_tpu_torch.models.towers import filter_and_dedup

    if obb not in ("auto", "accum", "sort"):
        raise ValueError(f"obb must be 'auto', 'accum' or 'sort', got {obb!r}")
    if obb == "auto":
        obb = "accum"
    if geometric_voxels:
        hi, lo, keep, labels, base, mn, cells_over, hier_over = (
            fused_downsample_ground_cluster(
                xyz, mask, params, max_cells=max_cells,
                min_cell_points=min_cell_points, geometric_voxels=True, emit="codes",
                return_cells_overflow=True, sort_mode=sort_mode,
                hier_window=hier_window, cell_plan=cell_plan, precut_div=precut_div,
            )
        )
        if obb == "accum":
            stats = cluster_obb_stats_accum(
                hi, lo, labels, keep, mn, max_clusters=params.max_clusters,
                num_angles=params.obb_angles,
            )
        else:
            stats = cluster_obb_stats_codes(
                hi, lo, labels, keep, mn, max_clusters=params.max_clusters,
                num_angles=params.obb_angles, per_cluster_cap=per_cluster_cap,
                points_cap=points_cap,
            )
        accepted = filter_and_dedup(stats, params.filters)
        return dict(labels=labels, ground_keep=keep, base_height=base,
                    accepted=accepted, cells_overflow=cells_over,
                    hier_runs_over=hier_over, **stats)
    ds_xyz, keep, labels, base, cells_over, hier_over = fused_downsample_ground_cluster(
        xyz, mask, params, max_cells=max_cells, min_cell_points=min_cell_points,
        geometric_voxels=False, return_cells_overflow=True,
    )
    stats = cluster_obb_stats(
        ds_xyz, labels, keep, max_clusters=params.max_clusters,
        num_angles=params.obb_angles, per_cluster_cap=per_cluster_cap,
    )
    accepted = filter_and_dedup(stats, params.filters)
    return dict(labels=labels, ground_keep=keep, base_height=base,
                accepted=accepted, ds_xyz=ds_xyz, cells_overflow=cells_over,
                hier_runs_over=hier_over, **stats)
