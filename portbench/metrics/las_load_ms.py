"""Host ms a tile of the whole LAS read of models/pipeline.py extract and
compress: the self ms of the program's spans las.load (around the whole
read), las.read (io/las.py read_las) and las.xyz (the f64 rows: one native
pass, or the records' columns), over those the window has.  A program
without las.load reads las.read and las.xyz alone, which are then the same
read."""

from portbench import progspans

LAYER = "io/las.py host LAS read"
UNIT = "ms"
MOVES = "mpts_per_s"
NAMES = ("las.load", "las.read", "las.xyz")


def read(window):
    got = [progspans.phase_ms(window, name) for name in NAMES]
    got = [ms for ms in got if ms is not None]
    return sum(got) if got else None
