"""Host wall of models/pipeline.py extract_from_points a tile: padding,
the retry ladder with its device graph, the label rebuild and the tower
records."""

LAYER = "models/pipeline.py extract_from_points"
UNIT = "ms"
MOVES = "mpts_per_s"
SPANS = {"extract_from_points": "pointcloudhookup_tpu_torch.models.pipeline:extract_from_points"}


def read(window):
    s = window.span_s("extract_from_points")
    return None if s is None else s * 1e3 / window.tiles
