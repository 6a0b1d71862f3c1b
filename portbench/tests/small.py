"""Small configurations of the benchmark's cells for CPU tests.

A cell's own configuration with a tile small enough for the program's
plain PyTorch kernels on the CPU: the same code paths (the exact path at a
lowered auto_grid_threshold, the fused step with its pre-cut at 131,072
rows), in seconds.
"""

import copy

SMALL_TILE = {"tile.towers": 6, "tile.extent_m": 300.0, "tile.span_m": 270.0,
              "tile.sway_m": 20.0, "tile.period_m": 125.0}
SMALL = {
    "tile4m.extract": dict(SMALL_TILE, **{"tile.points": 60000,
                                          "params.cluster.auto_grid_threshold": 1000,
                                          "params.cluster.max_cells": 4096}),
    # run-all takes the command line's defaults: above auto_grid_threshold
    # (200,000 points) for the exact path
    "tile4m.run_all": dict(SMALL_TILE, **{"tile.points": 240000}),
    "stream1m.las": dict(SMALL_TILE, **{"tile.points": 120000, "stream.capacity": 131072,
                                        "distinct_tiles": 2}),
}


def shrink(config: dict, changes: dict) -> dict:
    """A copy of config with each dotted key of changes set."""
    out = copy.deepcopy(config)
    for dotted, value in changes.items():
        *heads, last = dotted.split(".")
        node = out
        for h in heads:
            node = node[h]
        if last not in node:
            raise KeyError(f"no configuration key {dotted!r}")
        node[last] = value
    return out


def small_info(workload: str) -> dict:
    """resolve(workload) with the cell's configuration cut to SMALL."""
    from portbench import harness

    info = harness.resolve(workload)
    info["config"] = shrink(info["config"], SMALL[workload])
    return info
