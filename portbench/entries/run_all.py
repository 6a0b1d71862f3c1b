"""Entry kind ``run_all``: one request is the run-all command in this
process, ``__main__.main(["run-all", <tile.las>, <model.gim>, <out.gim>,
...])``, on the distinct tiles in turn, each with a GIM of its towers;
exit 0 is success.  Each request reads a hard link of its tile, so the
downsampled LAS it writes beside it (``<name>_ds.las``) is its own.  Held
against ``reference/run_all.py``."""

from __future__ import annotations

import contextlib
import os
import time

from portbench import geo, gim, lasio
from portbench.drive import Request
from portbench.entries.extract import ExtractEntry


class RunAllEntry(ExtractEntry):
    REFERENCE = "run_all"

    def prepare(self):
        super().prepare()
        self.gims, self.gim_towers = [], []
        for t, centres in enumerate(self.centres):
            lon, lat = geo.tm_inverse(centres[:, 0], centres[:, 1])
            towers = [dict(id=f"P{i}", lat=float(lat[i]), lng=float(lon[i]),
                           h=float(centres[i, 2]) - self.config["gim"]["h_below_centre_m"],
                           r=self.config["gim"]["rotation_deg"]) for i in range(len(centres))]
            path = os.path.join(self.workdir, f"model_{t:03d}.gim")
            gim.write_gim(path, towers)
            self.gims.append(path)
            self.gim_towers.append(towers)

    def window(self):
        pipeline = self.pipeline
        inner = pipeline.extract
        towers = self._towers = []

        def capture(*args, **kwargs):
            out = inner(*args, **kwargs)
            towers.append(out)
            return out

        @contextlib.contextmanager
        def ctx():
            with super(RunAllEntry, self).window():
                pipeline.extract = capture
                try:
                    yield
                finally:
                    pipeline.extract = inner
        return ctx()

    def request(self, i: int) -> Request:
        from pointcloudhookup_tpu_torch import __main__ as cli

        t = i % len(self.paths)
        las = os.path.join(self.workdir, f"req_{i:05d}.las")
        if not os.path.exists(las):
            os.link(self.paths[t], las)
        out_gim = os.path.join(self.workdir, f"out_{i:05d}.gim")
        cp = self.config["params"]["cluster"]
        argv = ["run-all", las, self.gims[t], out_gim,
                "--output-folder", os.path.join(self.workdir, f"gim_{i:05d}"),
                "--voxel-size", str(self.config["compress"]["voxel_size"]),
                "--eps", str(cp["eps"]), "--min-points", str(cp["min_points"]),
                "--device", str(self.device)]
        self._stats.clear()
        if hasattr(self, "_towers"):
            self._towers.clear()
        t0 = time.perf_counter()
        try:
            cli.main(argv)
            code = 0
        except SystemExit as e:
            code = e.code
        wall = time.perf_counter() - t0
        if code not in (0, None):
            raise RuntimeError(f"run-all exited {code} on tile {t}")
        out = dict(towers=self._towers[-1] if getattr(self, "_towers", None) else [],
                   ds_path=las[:-4] + "_ds.las", out_gim=out_gim)
        if self._stats:  # padded rows: the check cuts them to the downsampled tile
            out.update(labels=self._stats[-1]["labels"], ground_keep=self._stats[-1]["ground_keep"])
        return Request([t], self.n_points[t], wall, [out])

    def reference_input(self, t: int):
        return dict(path=self.paths[t], gim_towers=self.gim_towers[t])

    def form(self, out: dict) -> dict:
        """Its extraction, the downsampled LAS it wrote and the BLHA lines
        of the GIM it saved."""
        form = super().form(out)
        form["ds"] = lasio.read_las(out["ds_path"])
        form["blha"] = gim.read_blha(out["out_gim"])
        n = len(form["ds"])  # the extraction's rows past the tile are padding
        for key in ("labels", "ground_keep"):
            if form[key] is not None:
                form[key] = form[key][:n]
        return form


ENTRY = RunAllEntry
