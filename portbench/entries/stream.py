"""Entry kind ``stream``: one request is
``core/streaming.py::stream_extract`` over the configuration's distinct
LAS tiles, with its ``stream`` settings.  After each request the
point-sized results it left on the device are copied to the host for the
check and the device copies dropped, as a caller would."""

from __future__ import annotations

import time

import numpy as np

from portbench import check
from portbench.drive import Entry, Request, extract_params


class StreamEntry(Entry):
    def __init__(self, *args):
        super().__init__(*args)
        from pointcloudhookup_tpu_torch.core import streaming

        self.streaming = streaming
        self.params = extract_params(self.config["params"])

    def request(self, i: int) -> Request:
        import torch

        st = self.config["stream"]
        t0 = time.perf_counter()
        res = self.streaming.stream_extract(
            self.paths, capacity=st["capacity"], params=self.params, wire=st["wire"],
            fast=st["fast"], prefetch=st["prefetch"], precut_div=st["precut_div"],
            timings=self.tracing, device=self.device,
        )
        wall = time.perf_counter() - t0
        outputs, metas = [], []
        for stats, meta in res:
            out = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                   for k, v in stats.items()}
            outputs.append(dict(stats=out, origin=meta["origin"], wire=meta["wire"],
                                n=meta["n"]))
            metas.append({k: meta[k] for k in ("step_seconds", "decode_seconds",
                                               "stage_seconds") if k in meta})
        return Request(list(range(len(self.paths))), sum(self.n_points), wall, outputs, metas)

    def form(self, out: dict) -> dict:
        """One streamed tile: its [K] stats (centres in the tile's centred
        frame, moved by the streamer's origin) and point-sized rows."""
        s = out["stats"]
        center = np.asarray(s["center"], np.float64) + np.asarray(out["origin"], np.float64)
        return dict(labels=s.get("labels"), ground_keep=s.get("ground_keep"),
                    towers=check.towers_form(s["accepted"], center, s["extent"],
                                             s["north_angle"], s["count"]))


ENTRY = StreamEntry
