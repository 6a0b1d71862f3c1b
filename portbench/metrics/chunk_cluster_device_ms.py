"""Device time a tile of the kernels and copies launched inside
ops/cluster.py dbscan_chunked (as models/towers.py calls it: one dbscan a
chunk), from the profiler's trace."""

LAYER = "ops/cluster.py dbscan_chunked"
UNIT = "ms"
MOVES = "mpts_per_s"
SPANS = {"dbscan_chunked": "pointcloudhookup_tpu_torch.models.towers:dbscan_chunked"}


def read(window):
    if window.trace is None or "dbscan_chunked" not in window.spans:
        return None
    s = window.trace.device_s_inside("pb:dbscan_chunked")
    return s * 1e3 / window.tiles if s > 0 else None
