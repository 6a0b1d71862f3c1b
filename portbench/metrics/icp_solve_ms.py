"""Self host ms a request of the program's span icp.solve
(ops/registration.py solve_pairs), three a request: batched_icp's issue
of every nearest sweep and Kabsch solve, and the waits for the device
inside it (the 3x3 SVD's result, once an iteration)."""

from portbench import progspans

LAYER = "ops/registration.py batched_icp"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    return progspans.phase_ms(window, "icp.solve")
