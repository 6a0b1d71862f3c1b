"""Device time a request of the kernels and copies launched inside
ops/registration.py batched_icp (three calls a request), from the
profiler's trace."""

LAYER = "ops/registration.py batched_icp"
UNIT = "ms"
MOVES = "mpts_per_s"
SPANS = {"batched_icp": "pointcloudhookup_tpu_torch.ops.registration:batched_icp"}


def read(window):
    if window.trace is None or "batched_icp" not in window.spans:
        return None
    s = window.trace.device_s_inside("pb:batched_icp")
    return s * 1e3 / window.tiles if s > 0 else None
