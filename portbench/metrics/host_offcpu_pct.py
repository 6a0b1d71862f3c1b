"""Share of the program's leaf spans' wall time their threads spent off
the CPU (wall less thread CPU time): runnable but waiting for the
interpreter lock or the scheduler, or in I/O.  Spans that exist to wait
(``*.wait``) are left out."""

from portbench import progspans

LAYER = "host threads"
UNIT = "%"
MOVES = "mpts_per_s"


def read(window):
    p = progspans.of(window)
    share = None if p is None else p.offcpu_share()
    return None if share is None else 100.0 * share
