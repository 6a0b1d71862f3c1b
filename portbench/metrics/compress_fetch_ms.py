"""Host ms a tile of the program's span compress.fetch: the downsampled
[N, 3] and mask brought to the host, the selection and the f64 shift."""

from portbench import progspans

LAYER = "models/pipeline.py compress"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "compress.fetch")
