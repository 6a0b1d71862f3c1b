"""Host ms a tile of the program's span extract.cluster (models/towers.py
extract_step): on the per-chunk path the loop that issues dbscan once a
chunk, and the compaction of the chunk-offset labels."""

from portbench import progspans

LAYER = "ops/cluster.py dbscan_chunked"
UNIT = "ms"
MOVES = "mpts_per_s"


def read(window):
    p = progspans.of(window)
    walls = [s.t1_ns - s.t0_ns for s in p.spans if s.name == "extract.cluster"] if p else []
    return sum(walls) / 1e6 / window.tiles if walls else None
