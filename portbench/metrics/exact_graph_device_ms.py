"""Device time a tile of the kernels and copies launched inside
ops/frontend_exact.py exact_extract_graph (every ladder step), from the
profiler's trace."""

LAYER = "ops/frontend_exact.py exact graph"
UNIT = "ms"
MOVES = "mpts_per_s"
SPANS = {"exact_extract_graph": "pointcloudhookup_tpu_torch.models.pipeline:exact_extract_graph"}


def read(window):
    if window.trace is None or "exact_extract_graph" not in window.spans:
        return None
    s = window.trace.device_s_inside("pb:exact_extract_graph")
    return s * 1e3 / window.tiles if s > 0 else None
