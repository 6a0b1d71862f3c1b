"""Fixpoint rounds a tile of models/towers.py filter_and_dedup: the
program's counter extract.dedup_rounds, one device-to-host read each."""

from portbench import progspans

LAYER = "models/towers.py filter_and_dedup"
UNIT = "count"
MOVES = "mpts_per_s"


def read(window):
    return progspans.count_per_tile(window, "extract.dedup_rounds")
