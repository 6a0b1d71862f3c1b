"""Host ms a tile of the program's span extract.fetch: state.to_numpy of
every ladder step's stats dict, one blocking copy a tensor."""

from portbench import progspans

LAYER = "models/pipeline.py extract_from_points"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "extract.fetch")
