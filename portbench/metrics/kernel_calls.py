"""Calls of the ten kernel functions that launched their kernel, a tile:
the sum of the program's counters kernel.<function> (ops/kernels); a call
with no rows launches nothing and is not counted."""

from portbench import progspans

LAYER = "ops/kernels csrc kernels"
UNIT = "count"
MOVES = "mpts_per_s"


def read(window):
    return progspans.count_per_tile(window, "kernel.", prefix=True)
