"""Host wall a tile of the GIM layers: models/pipeline.py import_gim
(io/gim.py, io/sevenzip.py, io/cbm.py), correct (ops/geo.py, the match)
and save_gim (the CBM write-back and the 7z repack), summed."""

LAYER = "io/gim.py io/sevenzip.py ops/geo.py GIM workflow"
UNIT = "ms"
MOVES = "mpts_per_s"
_P = "pointcloudhookup_tpu_torch.models.pipeline:"
SPANS = {"import_gim": _P + "import_gim", "correct": _P + "correct", "save_gim": _P + "save_gim"}


def read(window):
    parts = [window.span_s(name) for name in SPANS]
    if all(p is None for p in parts):
        return None
    return sum(p for p in parts if p is not None) * 1e3 / window.tiles
