"""Host ms a tile of the program's span stream.stage.fill in the producer
thread: the float32 centring or the u16 quantising into the staging
buffers, the mask, and the issue of the copies."""

from portbench import progspans

LAYER = "core/streaming.py TileStreamer staging"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "stream.stage.fill")
