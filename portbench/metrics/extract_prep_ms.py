"""Host ms a tile of the program's span extract.prepare
(models/pipeline.py extract_from_points): the f64 mean, the padded
float32 copy and mask, and _exact_fast_plan's min and max."""

from portbench import progspans

LAYER = "models/pipeline.py extract_from_points"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "extract.prepare")
