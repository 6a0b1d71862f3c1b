"""Host ms a tile of the program's spans extract.finish: the label
scatter and ground keep of the settled step, and towers_from_stats."""

from portbench import progspans

LAYER = "models/pipeline.py extract_from_points"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "extract.finish")
