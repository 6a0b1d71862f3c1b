"""Random subsampling on the device.

Counterpart of ``pointcloudhookup_tpu/ops/sample.py``: one random key a
point and the ``max_points`` smallest kept (one sort, no host read), and
the host-RAM chunk-size heuristic.  The JAX function draws its keys from
``jax.random``, which a torch generator cannot repeat, so the port splits
it: ``random_downsample`` draws u32 bits from a ``torch.Generator`` and
``random_downsample_from_bits`` is the deterministic rest, which given the
same bits keeps the same points.
"""

from __future__ import annotations

from typing import Optional

import torch

_U32 = 0xFFFFFFFF


def random_bits(n: int, generator: Optional[torch.Generator] = None, device=None):
    """n uniform u32 values (held in int64), drawn on the generator's
    device (``device`` without one) and moved to ``device``."""
    where = generator.device if generator is not None else device
    bits = torch.randint(0, _U32 + 1, (n,), dtype=torch.int64, generator=generator,
                         device=where)
    return bits.to(device)


def random_downsample_from_bits(xyz, mask, bits, max_points: int):
    """Keep the valid points with the max_points smallest keys.

    xyz f32[N, 3], mask bool[N], bits: u32 values [N] (int64 or uint32).
    Returns (xyz f32[N, 3], mask bool[N]) with the kept points packed at
    the front in key order and zeros behind.  If fewer than max_points are
    valid, all survive.  Rows of equal key come out in input order (the JAX
    package's sort is unstable there)."""
    n = xyz.shape[0]
    r = torch.where(mask, bits.to(torch.int64) >> 1, _U32)  # invalid points sort last
    order = torch.sort(r, stable=True).indices
    keep = (torch.arange(n, device=xyz.device) < max_points) & mask[order]
    return torch.where(keep[:, None], xyz[order], 0.0), keep


def random_downsample(xyz, mask, max_points: int,
                      generator: Optional[torch.Generator] = None):
    """Keep a uniform random subset of at most max_points valid points
    (see random_downsample_from_bits), keys drawn from ``generator``."""
    bits = random_bits(xyz.shape[0], generator, device=xyz.device)
    return random_downsample_from_bits(xyz, mask, bits, max_points)


def recommend_chunk_size(available_gb: float, bytes_per_point: float = 24.0) -> int:
    """500k/1M/2M-point chunks for 4/8/16 GB hosts (~24 B a point)."""
    if available_gb < 6:
        return 500_000
    if available_gb < 12:
        return 1_000_000
    return 2_000_000
