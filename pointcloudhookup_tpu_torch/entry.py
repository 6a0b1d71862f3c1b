"""Single-device forward step of the port, for callers and smoke tests.

Counterpart of ``entry`` and ``_example_batch`` in the JAX package's
``__graft_entry__.py``: ``entry(device)`` returns ``(fn, (xyz, mask))``
where ``fn(xyz, mask)`` is the modular extraction step
(``models/towers.py::extract_step``) with default ``ExtractParams()``
and the arguments are a 60,000-point synthetic corridor padded to
65,536 rows on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloudhookup_tpu_torch.config import ExtractParams
from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor
from pointcloudhookup_tpu_torch.models.towers import extract_step


def _example_batch(capacity, n_points, seed=0, spread=400.0):
    """Centred float32 corridor rows padded to capacity, and their mask."""
    rng = np.random.default_rng(seed)
    pts, _ = synthetic_corridor(
        rng,
        n_ground=int(n_points * 0.75),
        n_veg=int(n_points * 0.1),
        pts_per_tower=int(n_points * 0.05),
        extent=spread,
    )
    pts = pts[:n_points] if len(pts) > n_points else pts
    xyz = np.zeros((capacity, 3), np.float32)
    xyz[: len(pts)] = (pts - pts.mean(axis=0)).astype(np.float32)
    mask = np.zeros(capacity, bool)
    mask[: len(pts)] = True
    return xyz, mask


def entry(device="cuda"):
    """The modular extraction step and its example batch on ``device``."""
    params = ExtractParams()

    def fn(xyz, mask):
        return extract_step(xyz, mask, params)

    xyz, mask = _example_batch(capacity=65536, n_points=60000)
    return fn, (torch.from_numpy(xyz).to(device), torch.from_numpy(mask).to(device))
