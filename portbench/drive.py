"""The general traffic generator.

A traffic mix is a data file, ``traffic/<mix>.json``, that names the entry
kind its requests go through (``"entry"``); a configuration is a data
file, ``configs/<config>.json``.  An entry kind is a module found by name,
``entries/<entry>.py``, whose ``ENTRY`` is a subclass of ``Entry`` here:
how one request drives the program, what the check reads from its answer
(``form``) and which plain reference it is held against (``REFERENCE``,
else the configuration's ``reference``).  This module makes the
configuration's distinct tiles from the seed, as LAS files under the run's
work directory, and builds the entry.  A closed loop: the next request
starts when the last one has returned.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import shutil

from portbench import lasio
from portbench.synthetic import make_tiles


def extract_params(params: dict):
    """The program's ExtractParams of a configuration's parameter tree."""
    from pointcloudhookup_tpu_torch.config import (
        ClusterParams, ExtractParams, GroundParams, TowerFilterParams,
    )

    return ExtractParams(
        ground=GroundParams(**params["ground"]),
        cluster=ClusterParams(**params["cluster"]),
        filters=TowerFilterParams(**params["filters"]),
        max_clusters=params["max_clusters"],
        obb_angles=params["obb_angles"],
    )


class Request:
    """One request: its tiles (indices into the distinct tiles), input
    points, host wall seconds and per-tile outputs for the check."""

    def __init__(self, tiles, points, wall_s, outputs, meta=None):
        self.tiles = tiles
        self.points = points
        self.wall_s = wall_s
        self.outputs = outputs
        self.meta = meta or []


class Entry:
    """Common part of every entry kind: the distinct tiles, written under
    workdir as LAS at the configuration's scale."""

    REFERENCE: str | None = None  # a module of reference/; None: the configuration's

    def __init__(self, config: dict, traffic: dict, seed: int, device: str, workdir: str):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.workdir = workdir
        self.paths: list = []
        self.centres: list = []
        self.tracing = False

    def prepare(self):
        tiles = make_tiles(self.config, self.seed, self.config["distinct_tiles"])
        os.makedirs(self.workdir, exist_ok=True)
        for t, (pts, centres) in enumerate(tiles):
            self.centres.append(centres)
            path = os.path.join(self.workdir, f"tile_{t:03d}.las")
            lasio.write_las(path, pts, self.config["tile"]["las_scale"])
            self.paths.append(path)
        self.n_points = [len(p) for p, _ in tiles]

    def reference_input(self, t: int):
        """What the plain reference is handed for distinct tile t: its
        world coordinates as the program read them."""
        return lasio.read_las(self.paths[t])

    def window(self):
        """A context that captures what the check needs while it is open."""
        return contextlib.nullcontext()

    def request(self, i: int) -> Request:
        raise NotImplementedError

    def form(self, out: dict) -> dict:
        """One tile's answer in the check's common form (check.py)."""
        raise NotImplementedError

    def cleanup(self):
        """Remove every file the run wrote under workdir."""
        shutil.rmtree(self.workdir, ignore_errors=True)


def make_entry(config: dict, traffic: dict, seed: int, device: str, workdir: str) -> Entry:
    kind = traffic["entry"]
    try:
        mod = importlib.import_module(f"portbench.entries.{kind}")
    except ModuleNotFoundError as e:
        if e.name != f"portbench.entries.{kind}":
            raise
        raise ValueError(f"unknown entry {kind!r}: no portbench/entries/{kind}.py") from None
    return mod.ENTRY(config, traffic, seed, device, workdir)

