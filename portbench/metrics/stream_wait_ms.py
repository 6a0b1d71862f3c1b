"""Host ms a tile of the program's span stream.wait: the consumer blocked
on the streamer's queue (TileStreamer.__iter__), waiting for the
producer thread's next chunk."""

from portbench import progspans

LAYER = "core/streaming.py TileStreamer queue"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "stream.wait")
