"""Host ms a request of the program's span icp.pack (models/refine.py
refine_tower_centers), three a request: the frames and tower-local
clouds (first stage), the targets re-based by the shift so far and the
padded batch."""

from portbench import progspans

LAYER = "models/refine.py refine_tower_centers"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "icp.pack")
