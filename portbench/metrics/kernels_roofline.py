"""The kernel functions' share of their roofline over the window: the sum
of every call's bound (roofline.py: bytes over 3.35 TB/s or float32
operations over 67 TFLOP/s, the larger) over the sum of the device time of
what each call launched (the profiler's trace)."""

LAYER = "ops/kernels csrc kernels"
UNIT = "%"
MOVES = "mpts_per_s"
KERNELS = True


def read(window):
    if window.trace is None or not window.kernel_costs:
        return None
    bound_s = device_s = 0.0
    for name in sorted({n for n, _ in window.kernel_costs}):
        d = window.trace.device_s_inside("pbk:" + name)
        if d > 0:  # a function whose device time the trace lacks is left out
            device_s += d
            bound_s += sum(c.bound_s() for n, c in window.kernel_costs if n == name)
    return 100.0 * bound_s / device_s if device_s > 0 else None
