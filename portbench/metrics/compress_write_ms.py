"""Host ms a tile of the program's span compress.write: make_las and
write_las of the downsampled tile."""

from portbench import progspans

LAYER = "models/pipeline.py compress"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "compress.write")
