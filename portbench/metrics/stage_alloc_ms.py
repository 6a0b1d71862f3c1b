"""Host ms a tile of the program's span stream.stage.alloc in the
producer thread: the two fresh zeroed staging tensors of the chunk,
pinned on a CUDA device."""

from portbench import progspans

LAYER = "core/streaming.py TileStreamer staging"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "stream.stage.alloc")
