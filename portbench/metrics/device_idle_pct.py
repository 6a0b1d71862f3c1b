"""Share of the traced window in which no kernel, copy or memset ran on
the device: 1 - (union of device activity) / window, from the trace."""

LAYER = "device"
UNIT = "%"
MOVES = "mpts_per_s"


def read(window):
    if window.trace is None:
        return None
    busy = window.trace.busy_s()
    return 100.0 * (1.0 - busy / window.trace.window_s()) if busy > 0 else None
