"""End-to-end: the 95th percentile (numpy's linear percentile) of the host
wall of every request of the window, from the call with the LAS path to
the towers returned: the wait of an engineer at one tile.  Read in the
untraced run, in cells whose request is one tile."""

import numpy as np

UNIT = "ms"


def read(window):
    walls = [r.wall_s * 1e3 for r in window.requests if len(r.tiles) == 1]
    return float(np.percentile(walls, 95)) if walls else None
