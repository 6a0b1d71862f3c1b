"""Passes of the extraction's retry ladder a tile: the program's counter
extract.ladder_step, one a graph run (exact_extract_graph, or the modular
extract_step)."""

from portbench import progspans

LAYER = "models/pipeline.py extract_from_points"
UNIT = "count"
MOVES = "mpts_per_s"


def read(window):
    return progspans.count_per_tile(window, "extract.ladder_step")
