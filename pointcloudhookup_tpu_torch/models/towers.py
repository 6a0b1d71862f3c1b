"""Tower schema, the modular extraction step, acceptance filters and
duplicate suppression.

Counterpart of ``pointcloudhookup_tpu/models/towers.py`` (``Tower``,
``extract_step``, ``filter_and_dedup``, ``towers_from_stats``).  The port's
``Tower`` also carries the member centroid: a box centre spans the border
cells a cluster adopts, so checks locate a tower by its centroid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pointcloudhookup_tpu_torch.config import ExtractParams, TowerFilterParams
from pointcloudhookup_tpu_torch.ops.cluster import compact_labels, dbscan, dbscan_chunked
from pointcloudhookup_tpu_torch.ops.cluster_adaptive import adaptive_cluster
from pointcloudhookup_tpu_torch.ops.cluster_grid import grid_dbscan
from pointcloudhookup_tpu_torch.ops.ground import ground_filter
from pointcloudhookup_tpu_torch.ops.obb import cluster_obb_stats
from pointcloudhookup_tpu_torch.utils import trace


@dataclasses.dataclass
class Tower:
    """One extracted tower (host-side record, world coordinates)."""

    id: str
    center: np.ndarray  # f64[3] world coords (box center)
    extent: np.ndarray  # f64[3] (ex >= ey horizontal, ez vertical)
    height: float
    width: float
    north_angle: float
    angle: float  # long-axis yaw in radians
    num_points: int
    label: int
    properties: Optional[dict] = None
    centroid: Optional[np.ndarray] = None  # f64[3] world coords (members' mean)


def filter_and_dedup(stats: dict, fp: TowerFilterParams = TowerFilterParams()):
    """Tower acceptance filters + greedy duplicate suppression.

    Accept if height > min_height, min_width < width < max_width and
    height/width > aspect_ratio_threshold; then, in cluster-id order,
    reject any candidate whose 3D center lies within duplicate_threshold
    of an EARLIER accepted one.  The greedy scan is the fixpoint of
    accepted[i] = ok[i] & no earlier accepted conflict, iterated from
    accepted = ok (at most K rounds).  Each round reads the device once
    and counts as ``extract.dedup_rounds``.  Returns accepted bool[K]."""
    ext = stats["extent"]
    height = ext[:, 2]
    width = ext[:, 0]  # ex >= ey by construction
    aspect = height / torch.clamp(width, min=1e-6)
    ok = (
        stats["alive"]
        & (height > fp.min_height)
        & (width > fp.min_width)
        & (width < fp.max_width)
        & (aspect > fp.aspect_ratio_threshold)
    )
    centers = stats["center"]
    k = centers.shape[0]
    thr2 = torch.tensor(fp.duplicate_threshold, dtype=torch.float32).square()
    d2 = (centers[:, None, :] - centers[None, :, :]).square().sum(dim=-1)
    idx = torch.arange(k, device=centers.device)
    earlier_conflict = (
        (d2 < thr2.to(centers.device)) & (idx[None, :] < idx[:, None]) & ok[None, :]
    )
    accepted = ok
    for _ in range(k):
        trace.count("extract.dedup_rounds")
        new = ok & ~(earlier_conflict & accepted[None, :]).any(dim=1)
        if torch.equal(new, accepted):
            break
        accepted = new
    return accepted


def extract_step(xyz, mask, params: ExtractParams = ExtractParams()):
    """The modular extraction step on the tensors' device: ground filter,
    clustering, sort-based OBB stats, filters and dedup.

    xyz float32[N,3] centred coordinates, mask bool[N].  The clustering is
    the JAX function's choice: ``dbscan_chunked`` with per_chunk (labels
    compacted over the chunks), ``adaptive_cluster`` for method
    "adaptive", ``grid_dbscan`` for "grid" and for "auto" above
    auto_grid_threshold rows, ``dbscan`` otherwise.  Returns a dict of
    tensors: labels int32[N], ground_keep bool[N], base_height, accepted
    bool[K], cells_overflow (dense cells beyond the grid table; 0 on the
    other branches) and the per-cluster stats of ``cluster_obb_stats``.
    The four phases run under the spans ``extract.ground``,
    ``extract.cluster``, ``extract.obb`` and ``extract.filter``."""
    with trace.span("extract.ground"):
        keep, base = ground_filter(xyz, mask, params.ground)
    cp = params.cluster
    n = xyz.shape[0]
    cells_overflow = torch.zeros((), dtype=torch.float32, device=xyz.device)
    with trace.span("extract.cluster"):
        if cp.per_chunk:
            labels, _ = dbscan_chunked(xyz, keep, cp.eps, cp.min_points,
                                       chunk_size=cp.chunk_size)
            # chunk-offset labels are sparse: compact them to [0, K)
            labels = compact_labels(torch.where(labels >= 0, labels, n), n)
        elif cp.method == "adaptive":
            labels, _, _ = adaptive_cluster(
                xyz, keep, cp.min_points, min_cluster_size=cp.min_cluster_size,
                max_cells=cp.max_cells, min_cell_points=cp.min_cell_points,
                eps_fallback=cp.eps,
            )
        elif cp.method == "grid" or (cp.method == "auto" and n > cp.auto_grid_threshold):
            labels, _, cells_overflow = grid_dbscan(
                xyz, keep, cp.eps, cp.min_points, max_cells=cp.max_cells,
                min_cell_points=cp.min_cell_points,
            )
        else:
            labels, _ = dbscan(xyz, keep, cp.eps, cp.min_points)
    with trace.span("extract.obb"):
        stats = cluster_obb_stats(xyz, labels, keep, max_clusters=params.max_clusters,
                                  num_angles=params.obb_angles)
    with trace.span("extract.filter"):
        accepted = filter_and_dedup(stats, params.filters)
    return dict(labels=labels, ground_keep=keep, base_height=base, accepted=accepted,
                cells_overflow=cells_overflow, **stats)


def towers_from_stats(stats: dict, origin: np.ndarray) -> list[Tower]:
    """Host side: stats (numpy) + accepted mask -> Tower records in world
    coordinates."""
    keys = ("accepted", "center", "extent", "north_angle", "angle", "count",
            "centroid")
    stats = {k: np.asarray(stats[k]) for k in keys if k in stats}
    out = []
    for k in np.nonzero(stats["accepted"])[0]:
        center = np.asarray(stats["center"][k], np.float64) + origin
        ext = np.asarray(stats["extent"][k], np.float64)
        centroid = None
        if "centroid" in stats:
            centroid = np.asarray(stats["centroid"][k], np.float64) + origin
        out.append(
            Tower(
                id=f"tower_{int(k)}",
                center=center,
                extent=ext,
                height=float(ext[2]),
                width=float(ext[0]),
                north_angle=float(stats["north_angle"][k]),
                angle=float(stats["angle"][k]),
                num_points=int(stats["count"][k]),
                label=int(k),
                centroid=centroid,
            )
        )
    return out
