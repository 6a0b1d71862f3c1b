"""Entry kind ``extract``: one request is
``models/pipeline.py::extract(<tile.las>, params=..., device=...)`` on the
configuration's distinct tiles in turn.  The stats that
``extract_from_points`` returns (per-point labels and ground mask) are
kept by reference, no copy, for the check."""

from __future__ import annotations

import contextlib
import time

import numpy as np

from portbench.drive import Entry, Request, extract_params


def towers_of(records) -> dict:
    """The program's Tower records in the check's per-tower form."""
    return {int(t.label): dict(center=np.asarray(t.center, np.float64),
                               extent=np.asarray(t.extent, np.float64),
                               north=float(t.north_angle), count=int(t.num_points))
            for t in records}


class ExtractEntry(Entry):
    def __init__(self, *args):
        super().__init__(*args)
        from pointcloudhookup_tpu_torch.models import pipeline

        self.pipeline = pipeline
        self.params = extract_params(self.config["params"])
        self._stats = []

    def window(self):
        pipeline = self.pipeline
        inner = pipeline.extract_from_points
        kept = self._stats

        def capture(*args, **kwargs):
            out = inner(*args, **kwargs)
            kept.append(out[1])
            return out

        @contextlib.contextmanager
        def ctx():
            pipeline.extract_from_points = capture
            try:
                yield
            finally:
                pipeline.extract_from_points = inner
        return ctx()

    def request(self, i: int) -> Request:
        t = i % len(self.paths)
        n = self.n_points[t]
        self._stats.clear()
        t0 = time.perf_counter()
        towers = self.pipeline.extract(self.paths[t], params=self.params, device=self.device)
        wall = time.perf_counter() - t0
        out = dict(towers=towers)
        if self._stats:
            stats = self._stats[-1]
            out.update(labels=stats["labels"][:n], ground_keep=stats["ground_keep"][:n],
                       ladder=stats.get("ladder"))
        return Request([t], n, wall, [out])

    def form(self, out: dict) -> dict:
        """Its Tower records and the stats that extract_from_points returned."""
        return dict(labels=out.get("labels"), ground_keep=out.get("ground_keep"),
                    towers=towers_of(out["towers"]))


ENTRY = ExtractEntry
