"""The ICP's share of its roofline over the window: the sum of each
request's bound over the device time launched inside
ops/registration.py batched_icp (the profiler's trace).

The bound counts the work of the refinement as published
(models/refine.py), not of an implementation, from each request's
``meta``: for every refined tower, each nearest sweep pairs its frame
rows with its member rows.  A pair needs |b|^2 - 2 a.b, three fused
multiply-adds once |b|^2 is known a member row and -2a a frame row: 6
float32 operations (OPS_PER_PAIR; the comparison that keeps the least is
not an arithmetic operation).  Bytes: the frame and the member rows read
once a sweep, 12 bytes a row, and the index and distance of each frame row
written once, 8 bytes.  A sweep's bound is the larger of its operations
over 67 TFLOP/s and its bytes over 3.35 TB/s (roofline.py); Kabsch's
per-row sums are left out, so the bound is a floor.  A later kernel that
reimplements the search is held to the same count."""

from portbench import roofline

LAYER = "ops/registration.py batched_icp"
UNIT = "%"
MOVES = "mpts_per_s"
SPANS = {"batched_icp": "pointcloudhookup_tpu_torch.ops.registration:batched_icp"}
OPS_PER_PAIR = 6
ROW_BYTES = 12
OUT_BYTES = 8


def sweep_work(frame_rows: int, cloud_rows: int) -> tuple[float, float]:
    """(float32 operations, bytes) of one tower's nearest sweep."""
    ops = OPS_PER_PAIR * frame_rows * cloud_rows
    nbytes = ROW_BYTES * (frame_rows + cloud_rows) + OUT_BYTES * frame_rows
    return float(ops), float(nbytes)


def request_bound_s(meta: dict) -> float:
    """The least device seconds of one request's ICP: per stage (one
    batched call), the larger of its operations and bytes over the peaks."""
    work = [sweep_work(n, m) for n, m in meta["pairs"]]
    ops, nbytes = sum(w[0] for w in work), sum(w[1] for w in work)
    return sum(max(s * ops / roofline.F32_FLOPS_PER_S, s * nbytes / roofline.HBM_BYTES_PER_S)
               for s in meta["sweeps"])


def read(window):
    if window.trace is None or "batched_icp" not in window.spans:
        return None
    device_s = window.trace.device_s_inside("pb:batched_icp")
    bound_s = sum(request_bound_s(m) for r in window.requests for m in r.meta if "sweeps" in m)
    return 100.0 * bound_s / device_s if device_s > 0 and bound_s > 0 else None
