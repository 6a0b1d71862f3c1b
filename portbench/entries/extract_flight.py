"""Entry kind ``extract_flight``: the ``extract`` entry kind on tiles
written in flight order.

A surveyed LAS stores its returns in GPS-time order: the aircraft flies
along the corridor, so consecutive rows lie in a strip across it.  Here
each distinct tile's rows are stably sorted by x, the corridor's axis,
before the tile is written; the plain reference reads the same file.  A
request is ``extract(<tile.las>, params=..., device=...)``, as in
``entries/extract.py``."""

from __future__ import annotations

import os

import numpy as np

from portbench import lasio
from portbench.entries.extract import ExtractEntry
from portbench.synthetic import make_tiles


class ExtractFlightEntry(ExtractEntry):
    def prepare(self):
        tiles = make_tiles(self.config, self.seed, self.config["distinct_tiles"])
        os.makedirs(self.workdir, exist_ok=True)
        self.n_points = []
        for t, (pts, centres) in enumerate(tiles):
            pts = pts[np.argsort(pts[:, 0], kind="stable")]
            self.centres.append(centres)
            path = os.path.join(self.workdir, f"tile_{t:03d}.las")
            lasio.write_las(path, pts, self.config["tile"]["las_scale"])
            self.paths.append(path)
            self.n_points.append(len(pts))


ENTRY = ExtractFlightEntry
