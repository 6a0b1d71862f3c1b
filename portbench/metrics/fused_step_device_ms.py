"""Device time a tile of the kernels and copies launched inside
ops/frontend_fused.py fused_extract_step (with ops/obb.py), from the
profiler's trace."""

LAYER = "ops/frontend_fused.py fused step"
UNIT = "ms"
MOVES = "mpts_per_s"
SPANS = {"fused_extract_step": "pointcloudhookup_tpu_torch.ops.frontend_fused:fused_extract_step"}


def read(window):
    if window.trace is None or "fused_extract_step" not in window.spans:
        return None
    s = window.trace.device_s_inside("pb:fused_extract_step")
    return s * 1e3 / window.tiles if s > 0 else None
