"""Entry kind ``icp``: one request is the 校对 (correct) step with ICP,
``models/pipeline.py::correct(records, towers, icp=True, pc_clouds=...,
device=...)``, on one corridor section's extracted towers, their member
clouds and the section's GIM, the configuration's distinct sections in
turn.  Held against ``reference/icp.py``.

Set-up (``prepare``) makes each section's tile in memory (no LAS is
written), extracts it once with ``extract_from_points`` on the device,
keeps on the host the towers and each tower's member rows
(``pts[labels == t.label]``, world float64, as the ``correct --icp``
command gathers them), writes the section's GIM (``gim.py``) and reads it
with the program's ``import_gim``; then it drops the tile, so the window
holds the ICP's device memory alone.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np

from portbench import geo, gim
from portbench.drive import Entry, Request, extract_params
from portbench.synthetic import make_tiles

MIN_ROWS = 16  # a tower with fewer member rows is not refined


def stage_sweeps(iterations: int) -> list:
    """Nearest sweeps of each of the three stages: its iterations and a
    final sweep (models/refine.py)."""
    return [max(iterations // 3, 5) + 1] * 3


class IcpEntry(Entry):
    REFERENCE = "icp"

    def __init__(self, *args):
        super().__init__(*args)
        from pointcloudhookup_tpu_torch.models import pipeline

        self.pipeline = pipeline
        self.params = extract_params(self.config["params"])
        self.sections: list = []

    def prepare(self):
        os.makedirs(self.workdir, exist_ok=True)
        g = self.config["gim"]
        tiles = make_tiles(self.config, self.seed, self.config["distinct_tiles"])
        for t in range(len(tiles)):
            pts, centres = tiles[t]
            tiles[t] = None
            towers, stats, _ = self.pipeline.extract_from_points(pts, self.params,
                                                                 device=self.device)
            labels = np.asarray(stats["labels"][: len(pts)])
            clouds = [pts[labels == tw.label] for tw in towers]
            del pts, stats, labels
            lon, lat = geo.tm_inverse(centres[:, 0], centres[:, 1])
            written = [dict(id=f"P{i}", lat=float(lat[i]), lng=float(lon[i]),
                            h=float(centres[i, 2]) - g["h_below_centre_m"],
                            r=g["rotation_deg"]) for i in range(len(centres))]
            path = os.path.join(self.workdir, f"model_{t:03d}.gim")
            gim.write_gim(path, written)
            records, _, _ = self.pipeline.import_gim(path, os.path.join(self.workdir, f"gim_{t:03d}"))
            blha = gim.read_blha(path)  # the reference's own reading of the same file
            height = float(gim.FAM_PROPS["杆塔高"])
            gim_ref = [dict(zip(("lat", "lng", "h", "r"), blha[w["id"]]), id=w["id"], height=height)
                       for w in written]
            self.sections.append(dict(towers=towers, clouds=clouds, records=records,
                                      gim_ref=gim_ref, rows=sum(len(c) for c in clouds)))
        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()

    def request(self, i: int) -> Request:
        t = i % len(self.sections)
        s = self.sections[t]
        g, icp = self.config["gim"], self.config["icp"]
        t0 = time.perf_counter()
        res = self.pipeline.correct(
            s["records"], s["towers"], region_n_value=g["region_n_value"],
            distance_threshold=g["distance_threshold_m"],
            height_threshold=g["height_threshold_m"], icp=True, pc_clouds=s["clouds"],
            icp_iters=icp["iterations"], icp_max_corr_dist=icp["max_corr_dist_m"],
            device=self.device)
        wall = time.perf_counter() - t0
        tp = icp["template"]
        frame_rows = tp["levels"] * 4 * tp["per_edge"]
        matched = dict.fromkeys(pi for _, pi in res.pairs)
        meta = dict(pairs=[(frame_rows, len(s["clouds"][pi])) for pi in matched
                           if len(s["clouds"][pi]) >= MIN_ROWS],
                    sweeps=stage_sweeps(icp["iterations"]))
        return Request([t], s["rows"], wall, [dict(result=res, towers=s["towers"])], [meta])

    def reference_input(self, t: int):
        s = self.sections[t]
        towers = [dict(label=int(tw.label), center=np.asarray(tw.center, np.float64),
                       extent=np.asarray(tw.extent, np.float64), height=float(tw.height),
                       angle=float(tw.angle), north=float(tw.north_angle),
                       count=int(tw.num_points)) for tw in s["towers"]]
        return dict(towers=towers, clouds=s["clouds"], gim_towers=s["gim_ref"])

    def form(self, out: dict) -> dict:
        """The refined towers by label (centre: the refined world centre;
        extents, north angle and count: the tower's own) and the BLHA of
        the refined pairs, unrounded; no rows."""
        res, towers = out["result"], out["towers"]
        refined, blha = {}, {}
        for gi, pi in res.pairs:
            c = res.converted_towers[pi]
            if c.icp_rmse is None:
                continue
            t = towers[pi]
            refined[int(t.label)] = dict(center=np.asarray(c.original_center, np.float64),
                                         extent=np.asarray(t.extent, np.float64),
                                         north=float(t.north_angle), count=int(t.num_points))
            blha[res.gim_rows[gi][0]] = (float(c.converted_center[1]),
                                         float(c.converted_center[0]),
                                         float(c.converted_center[2]), float(c.north_angle))
        return dict(labels=np.zeros(0, np.int64), ground_keep=np.zeros(0, bool),
                    towers=refined, blha=blha)


ENTRY = IcpEntry
