"""Host wall a tile of the stream_extract step and its blocking [K]
fetches: meta["step_seconds"], which stream_extract gives with
timings=True (the traced run asks for it)."""

LAYER = "core/streaming.py stream_extract step"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    steps = [m["step_seconds"] for r in window.requests for m in r.meta if "step_seconds" in m]
    return sum(steps) * 1e3 / len(steps) if steps else None
