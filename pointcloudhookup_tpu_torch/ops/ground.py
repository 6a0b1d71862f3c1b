"""Height-percentile ground removal.

Counterpart of ``ground_filter`` and ``percentile_cut`` in
``pointcloudhookup_tpu/ops/ground.py``.  The RANSAC functions there wait
for the compress port: they draw from ``jax.random``, which a torch
generator cannot repeat.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.config import GroundParams
from pointcloudhookup_tpu_torch.ops.percentile import masked_percentile


def ground_filter(xyz, mask, params: GroundParams = GroundParams()):
    """Reference ground cut: keep z > P(percentile) + offset, or, when
    fewer than min_points_after rows survive, z > P + retry_offset (chosen
    on the device, no host read).  Returns (keep bool[N], base float32
    0-d tensor)."""
    z = xyz[:, 2]
    base = masked_percentile(z, mask, params.percentile)
    keep = mask & (z > base + params.offset)
    retry = keep.sum() < params.min_points_after
    return torch.where(retry, mask & (z > base + params.retry_offset), keep), base


def percentile_cut(xyz, mask, percentile=10.0, offset=4.0):
    """Simple low cut: drop z < P(percentile) + offset."""
    z = xyz[:, 2]
    base = masked_percentile(z, mask, percentile)
    return mask & (z >= base + offset)
