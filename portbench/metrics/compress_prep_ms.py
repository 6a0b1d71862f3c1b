"""Host ms a tile of the program's span compress.prepare
(models/pipeline.py compress): the mean, the float32 centring and
padding, and the pageable upload."""

from portbench import progspans

LAYER = "models/pipeline.py compress"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "compress.prepare")
