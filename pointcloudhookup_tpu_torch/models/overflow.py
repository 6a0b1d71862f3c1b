"""Dense-tile overflow resolution: re-split instead of just reporting.

Counterpart of ``pointcloudhookup_tpu/models/overflow.py``.  The
fixed-shape device buffers bound the per-tile candidate space
(``ExtractParams.max_clusters`` cluster slots and, on the fused fast path,
``max_cells`` dense-cell slots).  When a tile saturates, the host driver
splits it into four overlapping xy quadrants and recurses, then merges the
per-quadrant tower lists with the same duplicate-suppression semantics as
the device dedup.

The quadrant halo (default max(duplicate_threshold, max_width, 4*eps))
guarantees every structure within halo of a cut line appears COMPLETE in
at least one quadrant; its fragments elsewhere either fail the size
filters or lose the count-ordered dedup to the complete copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pointcloudhookup_tpu_torch.config import ExtractParams, GroundParams
from pointcloudhookup_tpu_torch.core.batch import round_up
from pointcloudhookup_tpu_torch.models.pipeline import extract_from_points
from pointcloudhookup_tpu_torch.models.towers import towers_from_stats
from pointcloudhookup_tpu_torch.ops.frontend_fused import fused_extract_step
from pointcloudhookup_tpu_torch.state import to_numpy


def saturated(stats: dict, params: ExtractParams) -> bool:
    """True when the tile hit a fixed-capacity ceiling: every cluster
    slot used (candidates beyond max_clusters were dropped) or dense
    cells overflowed the fused cell table."""
    if float(np.asarray(stats.get("cells_overflow", 0.0))) > 0:
        return True
    return int(np.asarray(stats["alive"]).sum()) >= params.max_clusters


def _dedup_towers(towers: list, duplicate_threshold: float) -> list:
    """Greedy duplicate suppression across sub-tile results, biggest
    cluster first (so a boundary fragment can never displace the
    complete copy of its tower)."""
    order = sorted(towers, key=lambda t: -t.num_points)
    kept: list = []
    for t in order:
        dup = any(
            float(np.linalg.norm(t.center - k.center)) < duplicate_threshold
            for k in kept
        )
        if not dup:
            kept.append(t)
    # stable presentation: west-to-east like a corridor sweep
    kept.sort(key=lambda t: (t.center[0], t.center[1]))
    for i, t in enumerate(kept):
        t.id = f"tower_{i}"
        t.label = i
    return kept


def extract_from_points_resolving(
    points: np.ndarray,
    params: ExtractParams = ExtractParams(),
    *,
    fast: bool = False,
    max_depth: int = 3,
    halo: Optional[float] = None,
    device="cuda",
    _depth: int = 0,
):
    """Extraction with capacity-overflow resolution on ``device``.

    fast=True runs the fused fast path (``_fast_extract``), fast=False
    ``models/pipeline.py::extract_from_points``: the exact path where a
    (sub-)tile is eligible, the modular ``extract_step`` otherwise (a
    saturated tile's quadrants fall below auto_grid_threshold and run
    ``dbscan``).  Returns (towers, info) where info = dict(
    saturated_tiles, tiles_run, max_depth_used, resolved); ``resolved``
    is False only if saturation persisted at max_depth."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if halo is None:
        halo = max(
            params.filters.duplicate_threshold,
            params.filters.max_width,
            4.0 * params.cluster.eps,
        )

    if fast:
        towers, stats = _fast_extract(points, params, device=device)
    else:
        towers, stats, _origin = extract_from_points(points, params, device=device)
    info = dict(
        saturated_tiles=0, tiles_run=1, max_depth_used=_depth, resolved=True
    )
    if not saturated(stats, params):
        return towers, info
    if _depth >= max_depth or len(points) < 8:
        info["saturated_tiles"] = 1
        info["resolved"] = False
        return towers, info

    # ---- the ground percentile is a GLOBAL statistic; recomputing it per
    # sub-tile would let the cut climb into the towers as recursion zooms
    # into structure-dense regions.  Apply the TOP-LEVEL cut here on the
    # host and hand children pre-filtered points with a no-op ground stage
    if _depth == 0:
        gp = params.ground
        base = float(np.asarray(stats["base_height"]))
        # the device step saw coordinates centered on the tile mean, so
        # base_height lives in that frame
        zc = points[:, 2] - points.mean(axis=0)[2]
        keep = zc > base + gp.offset
        if keep.sum() < gp.min_points_after:
            keep = zc > base + gp.retry_offset
        points = points[keep]
        params = dataclasses.replace(
            params,
            ground=GroundParams(percentile=0.0, offset=-1.0, min_points_after=0),
        )

    # ---- split around the xy median with an overlap halo and recurse
    info["saturated_tiles"] = 1
    mx, my = np.median(points[:, 0]), np.median(points[:, 1])
    quads = [
        (points[:, 0] <= mx + halo) & (points[:, 1] <= my + halo),
        (points[:, 0] <= mx + halo) & (points[:, 1] > my - halo),
        (points[:, 0] > mx - halo) & (points[:, 1] <= my + halo),
        (points[:, 0] > mx - halo) & (points[:, 1] > my - halo),
    ]
    merged: list = []
    for sel in quads:
        sub = points[sel]
        if len(sub) == len(points):  # degenerate split: no progress
            info["resolved"] = False
            return towers, info
        t_sub, i_sub = extract_from_points_resolving(
            sub, params, fast=fast, max_depth=max_depth, halo=halo,
            device=device, _depth=_depth + 1,
        )
        merged.extend(t_sub)
        info["tiles_run"] += i_sub["tiles_run"]
        info["saturated_tiles"] += i_sub["saturated_tiles"]
        info["max_depth_used"] = max(info["max_depth_used"], i_sub["max_depth_used"])
        info["resolved"] = info["resolved"] and i_sub["resolved"]
    towers = _dedup_towers(merged, params.filters.duplicate_threshold)
    return towers, info


def _fast_extract(points: np.ndarray, params: ExtractParams, device="cuda"):
    """Fused fast-path twin of pipeline.extract_from_points: full sort,
    ground pre-cut at N/4, the configured cell-density floor (at least
    1).  Returns (towers, stats as numpy)."""
    origin = points.mean(axis=0) if len(points) else np.zeros(3)
    # large tiles pad to the 32768-row multiple the pre-cut needs
    cap = round_up(max(len(points), 1), 1024)
    if cap >= 131072:
        cap = round_up(cap, 32768)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(points)] = (points - origin).astype(np.float32)
    mask = np.zeros(cap, bool)
    mask[: len(points)] = True
    stats = fused_extract_step(
        torch.from_numpy(xyz).to(device), torch.from_numpy(mask).to(device),
        params, geometric_voxels=True,
        min_cell_points=max(params.cluster.min_cell_points, 1),
        sort_mode="full", precut_div=4,
    )
    stats = to_numpy(stats)
    return towers_from_stats(stats, origin), stats
