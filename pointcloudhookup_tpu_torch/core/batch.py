"""Fixed-capacity padded point batches.

Counterpart of ``pointcloudhookup_tpu/core/batch.py``.  Every point buffer
on the device is padded to a fixed capacity with an explicit validity mask,
and coordinates are stored centred (float32 relative to a float64 host
origin): projected corridor coordinates (~1e5..1e7 m) do not fit float32 at
centimetre resolution.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


@dataclasses.dataclass
class PointBatch:
    """A padded batch of 3D points on a device.

    xyz:    float32[capacity, 3] centred coordinates (origin-relative).
    mask:   bool[capacity], True for real points.
    origin: float64[3] numpy, the world origin the points are relative to,
            kept on the host so world coordinates keep full precision.
    """

    xyz: torch.Tensor
    mask: torch.Tensor
    origin: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float64))

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def count(self) -> torch.Tensor:
        return self.mask.to(torch.int32).sum()

    @staticmethod
    def from_numpy(
        points: np.ndarray,
        capacity: Optional[int] = None,
        origin: Optional[np.ndarray] = None,
        pad_multiple: int = 1024,
        device="cuda",
    ) -> "PointBatch":
        """A PointBatch on ``device`` from world-coordinate points f64[N,3]
        (origin: their mean unless given)."""
        points = np.asarray(points, np.float64).reshape(-1, 3)
        n = points.shape[0]
        if origin is None:
            origin = points.mean(axis=0) if n else np.zeros(3, np.float64)
        origin = np.asarray(origin, np.float64)
        if capacity is None:
            capacity = max(round_up(max(n, 1), pad_multiple), pad_multiple)
        xyz, mask = pad_points(points - origin, capacity)
        return PointBatch(torch.from_numpy(xyz).to(device),
                          torch.from_numpy(mask).to(device), origin)

    def to_numpy(self) -> np.ndarray:
        """World-coordinate points f64[N,3] (valid points only)."""
        xyz = self.xyz.cpu().numpy()
        return xyz[self.mask.cpu().numpy()].astype(np.float64) + self.origin


def pad_points(points: np.ndarray, capacity: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad f32[N,3] -> (f32[capacity,3], bool[capacity])."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    out = np.zeros((capacity, 3), np.float32)
    out[:n] = points
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    return out, mask
