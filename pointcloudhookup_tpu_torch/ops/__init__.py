"""Device compute on torch tensors; kernels live in ``ops.kernels``."""

from pointcloudhookup_tpu_torch.ops.cluster import (  # noqa: F401
    dbscan,
    dbscan_chunked,
    merge_cluster_fragments,
)
from pointcloudhookup_tpu_torch.ops.cluster_grid import grid_dbscan  # noqa: F401
from pointcloudhookup_tpu_torch.ops.frontend_fused import (  # noqa: F401
    fused_downsample_ground_cluster,
    fused_extract_step,
)
from pointcloudhookup_tpu_torch.ops.geo import (  # noqa: F401
    cgcs2000_to_wgs84,
    ellipsoid_to_orthometric,
    haversine_m,
    haversine_matrix,
    local_cgcs2000_to_wgs84,
    tm_forward,
    tm_inverse,
    wgs84_to_cgcs2000,
)
from pointcloudhookup_tpu_torch.ops.ground import (  # noqa: F401
    ground_filter,
    percentile_cut,
    ransac_plane,
    remove_ground_ransac,
    remove_ground_tiled_ransac,
)
from pointcloudhookup_tpu_torch.ops.obb import cluster_obb_stats  # noqa: F401
from pointcloudhookup_tpu_torch.ops.percentile import (  # noqa: F401
    histogram_percentile,
    masked_percentile,
)
from pointcloudhookup_tpu_torch.ops.registration import (  # noqa: F401
    batched_icp,
    icp,
    kabsch,
    register_tower_pairs,
)
from pointcloudhookup_tpu_torch.ops.sample import random_downsample  # noqa: F401
from pointcloudhookup_tpu_torch.ops.voxel import (  # noqa: F401
    voxel_downsample,
    voxel_downsample_chunked,
)
