"""Host wall a tile of core/streaming.py TileStreamer._prepare in the
producer thread: the tile's mean, extent, the wire's quantisation or
float32 centring into pinned buffers and the copies' launch."""

LAYER = "core/streaming.py TileStreamer staging"
UNIT = "ms"
MOVES = "mpts_per_s"
SPANS = {"stream_prepare": "pointcloudhookup_tpu_torch.core.streaming:TileStreamer._prepare"}


def read(window):
    s = window.span_s("stream_prepare")
    return None if s is None else s * 1e3 / window.tiles
