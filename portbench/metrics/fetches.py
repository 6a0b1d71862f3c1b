"""Tensors brought to the host a tile: the program's counter fetch
(state.to_numpy's tensors, stream_extract's [K] fetches, compress's two)."""

from portbench import progspans

LAYER = "host-device copies"
UNIT = "count"
MOVES = "mpts_per_s"


def read(window):
    return progspans.count_per_tile(window, "fetch")
