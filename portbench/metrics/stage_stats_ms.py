"""Host ms a tile of the program's span stream.stage.stats in the
streamer's producer thread (core/streaming.py TileStreamer._prepare):
the chunk's f64 mean, min and max and the wire's choice."""

from portbench import progspans

LAYER = "core/streaming.py TileStreamer staging"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "stream.stage.stats")
