"""Configuration dataclasses.

Copy of ``pointcloudhookup_tpu/config.py``: the same frozen dataclasses,
field names and defaults, so a parameter tree means the same thing in both
packages.  ``state.extract_params_from_dict`` carries a JAX
``ExtractParams`` across (through ``dataclasses.asdict``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VoxelParams:
    """Voxel-grid downsampling.  In "parity" mode voxels are deduplicated
    only within a chunk of ``chunk_size`` points; in "global" mode the
    whole cloud shares one voxel grid."""

    voxel_size: float = 0.1
    chunk_size: int = 500_000
    per_chunk: bool = False


@dataclasses.dataclass(frozen=True)
class GroundParams:
    """Height-percentile ground filtering."""

    percentile: float = 25.0
    offset: float = 3.0
    # If fewer than `min_points_after` survive, retry with `retry_offset`.
    min_points_after: int = 1000
    retry_offset: float = 1.0


@dataclasses.dataclass(frozen=True)
class ClusterParams:
    """DBSCAN-equivalent Euclidean clustering."""

    eps: float = 8.0
    min_points: int = 80
    # parity mode clusters 50k-point chunks independently (labels offset
    # per chunk); global mode clusters the whole tile at once
    chunk_size: int = 50_000
    per_chunk: bool = False
    # clustering backend: "exact" (tiled DBSCAN), "grid" (cell-graph fast
    # path), "adaptive" (data-derived eps + min-cluster-size semantics) or
    # "auto" (grid above auto_grid_threshold)
    method: str = "auto"
    auto_grid_threshold: int = 200_000
    # grid-path knobs
    max_cells: int = 65536
    min_cell_points: int = 1
    # adaptive-path knob: clusters smaller than this many points are
    # demoted to noise (None -> min_points)
    min_cluster_size: int | None = None


@dataclasses.dataclass(frozen=True)
class TowerFilterParams:
    """Tower acceptance filters + dedup."""

    aspect_ratio_threshold: float = 0.8
    min_height: float = 15.0
    max_width: float = 50.0
    min_width: float = 8.0
    duplicate_threshold: float = 30.0


@dataclasses.dataclass(frozen=True)
class ExtractParams:
    """Full extraction pipeline parameters (downsample + ground + cluster +
    OBB + filters)."""

    ground: GroundParams = GroundParams()
    cluster: ClusterParams = ClusterParams()
    filters: TowerFilterParams = TowerFilterParams()
    # Maximum number of cluster candidates / accepted towers carried in
    # fixed-shape device buffers.
    max_clusters: int = 128
    # Number of candidate orientations scanned for the min-area XY
    # rectangle (the gravity-aligned OBB).
    obb_angles: int = 256


@dataclasses.dataclass(frozen=True)
class MatchParams:
    """GIM <-> point-cloud tower matching."""

    distance_threshold: float = 50.0  # meters, haversine
    height_threshold: float = 100.0  # meters, |orthometric height difference|
    region_n_value: float = 25.0  # fallback geoid undulation (m)
