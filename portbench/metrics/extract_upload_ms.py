"""Host ms a tile of the program's span extract.upload: the pageable
upload of the padded float32 [N, 3] and bool [N] to the device, once a
tile."""

from portbench import progspans

LAYER = "models/pipeline.py extract_from_points"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "extract.upload")
