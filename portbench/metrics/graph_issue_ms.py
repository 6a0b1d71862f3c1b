"""Self host ms a tile of the program's span extract.graph, every ladder
step's exact_extract_graph call (extract_step on the modular path): the
graph's host issue and the waits inside it."""

from portbench import progspans

LAYER = "models/pipeline.py extract_from_points"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "extract.graph")
