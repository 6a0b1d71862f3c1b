"""Host wall a tile of core/streaming.py TileStreamer._load in the
producer thread (the native LAS reader, native/las_codec.cpp)."""

LAYER = "core/streaming.py TileStreamer decode"
UNIT = "ms"
MOVES = "mpts_per_s"
SPANS = {"stream_load": "pointcloudhookup_tpu_torch.core.streaming:TileStreamer._load"}


def read(window):
    s = window.span_s("stream_load")
    return None if s is None else s * 1e3 / window.tiles
