"""MiB a tile copied from host arrays to the device on the extract,
compress and streaming paths: the program's counter upload_bytes."""

from portbench import progspans

LAYER = "host-device copies"
UNIT = "MiB"
MOVES = "mpts_per_s"


def read(window):
    return progspans.count_per_tile(window, "upload_bytes", scale=2.0**-20)
