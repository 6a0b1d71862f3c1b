"""Host LAS read a tile: the wall of every models/pipeline.py read_las call
of the window (io/las.py), over the tiles completed."""

LAYER = "io/las.py host LAS read"
UNIT = "ms"
MOVES = "mpts_per_s"
SPANS = {"read_las": "pointcloudhookup_tpu_torch.models.pipeline:read_las"}


def read(window):
    s = window.span_s("read_las")
    return None if s is None else s * 1e3 / window.tiles
