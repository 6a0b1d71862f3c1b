"""Share of the device's idle time in the traced window during which at
least one leaf span of the program (a span with no children) is open on
some thread: how much of the idle time the program's spans account for."""

from portbench import progspans

LAYER = "device"
UNIT = "%"
MOVES = "mpts_per_s"


def read(window):
    p = progspans.of(window)
    idle = None if p is None else p.idle()
    return 100.0 * idle["explained"] / idle["idle"] if idle and idle["idle"] > 0 else None
