"""Device time a tile of the kernels and copies launched inside
ops/obb.py cluster_obb_stats (as models/towers.py calls it: the
sort-based OBB search of the modular step), from the profiler's trace."""

LAYER = "ops/obb.py cluster_obb_stats"
UNIT = "ms"
MOVES = "mpts_per_s"
SPANS = {"cluster_obb_stats": "pointcloudhookup_tpu_torch.models.towers:cluster_obb_stats"}


def read(window):
    if window.trace is None or "cluster_obb_stats" not in window.spans:
        return None
    s = window.trace.device_s_inside("pb:cluster_obb_stats")
    return s * 1e3 / window.tiles if s > 0 else None
