"""Host ms a request of the program's span icp.refine (models/refine.py
refine_tower_centers): the whole ICP refinement of the matched towers,
its three stages with their packing, copies and solves."""

from portbench import progspans

LAYER = "models/refine.py refine_tower_centers"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    p = progspans.of(window)
    walls = [s.t1_ns - s.t0_ns for s in p.spans if s.name == "icp.refine"] if p else []
    return sum(walls) / 1e6 / window.tiles if walls else None
