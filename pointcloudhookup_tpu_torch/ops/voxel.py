"""Voxel-grid downsampling.

Counterpart of ``pointcloudhookup_tpu/ops/voxel.py``: Open3D semantics
(voxel index = floor((p - min_bound) / voxel_size), min_bound the cloud's
minimum; output = per-voxel centroid), global (``voxel_downsample``) or per
contiguous chunk against the chunk's own min bound
(``voxel_downsample_chunked``, the reference's per-500k-point chunks).

The JAX function sorts by the three integer keys with one stable
``lax.sort`` (num_keys=3).  Here two stable ``torch.sort`` calls give the
same order: first by (ky, kz) packed into one int64, then by (chunk, kx).
A single sort of the three keys packed into 63 bits would need the key
range, a device-to-host read; two sorts are exact for any int32 keys and
read nothing back.  The per-voxel sums are one reverse segmented add scan
of the [N, 4] float32 values (x w, y w, z w, w): the segscan kernel on the
card, its plain version (the JAX package's doubling scan) on the CPU.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.segments import boundary_flags, segmented_scan

SENTINEL = 2**30  # the masked rows' voxel key on every axis: they sort last
_BIG = 3.0e38


def voxel_downsample(xyz, mask, voxel_size, *, expand: int = 1):
    """Global voxel-grid centroid downsample.

    xyz f32[N, 3] (centred coordinates), mask bool[N], voxel_size a float
    or a 0-d tensor.  Returns (out_xyz f32[N, 3], out_mask bool[N]): the
    per-voxel centroids in voxel-key order, one valid row per voxel (at the
    voxel's first sorted row), the rest zero and masked out.  ``expand`` is
    unused (the JAX signature's)."""
    del expand
    min_bound = torch.where(mask[:, None], xyz, _BIG).amin(dim=0)
    return _voxelize(xyz, mask, min_bound, voxel_size, None)


def voxel_downsample_chunked(xyz, mask, voxel_size, *, chunk_size: int):
    """Chunk-local voxelization: each contiguous block of chunk_size rows
    is voxelized against its own min bound, and voxels never merge across
    blocks.  The row count must be a multiple of chunk_size.  Output order:
    chunk-major, voxel-key sorted within a chunk."""
    n = xyz.shape[0]
    if n % chunk_size:
        raise ValueError(f"capacity {n} not a multiple of chunk_size {chunk_size}")
    masked = torch.where(mask[:, None], xyz, _BIG).view(-1, chunk_size, 3)
    min_bound = masked.amin(dim=1).repeat_interleave(chunk_size, dim=0)
    chunk = torch.arange(n, device=xyz.device, dtype=torch.int64) // chunk_size
    return _voxelize(xyz, mask, min_bound, voxel_size, chunk)


def voxel_order(xyz, mask, min_bound, voxel_size, chunk=None):
    """The stable sort of the rows by (chunk, kx, ky, kz): returns (order
    int64[N], the sorted keys: (kx, ky, kz), or (chunk, kx, ky, kz) with
    chunk int64[N]).  min_bound is f32[3] or f32[N, 3]; masked rows carry
    SENTINEL on every axis."""
    # a true division by a device scalar, as XLA divides by the jitted
    # function's traced voxel_size (a CPU scalar would be turned into a
    # multiplication by its reciprocal on the card)
    if isinstance(voxel_size, torch.Tensor):
        vs = voxel_size.to(xyz.device, torch.float32)
    else:
        vs = torch.full((), float(voxel_size), dtype=torch.float32, device=xyz.device)
    ijk = torch.floor((xyz - min_bound) / vs).to(torch.int32)
    ijk = torch.where(mask[:, None], ijk, SENTINEL)
    kx, ky, kz = ijk.unbind(1)
    minor = (ky.to(torch.int64) << 32) + (kz.to(torch.int64) + 2**31)
    _, order = torch.sort(minor, stable=True)
    major = kx[order].to(torch.int64)
    if chunk is not None:
        major = (chunk[order] << 32) + (major + 2**31)
    _, second = torch.sort(major, stable=True)
    order = order[second]
    keys = (kx[order], ky[order], kz[order])
    return order, keys if chunk is None else (chunk[order], *keys)


def _voxelize(xyz, mask, min_bound, voxel_size, chunk):
    """Reduce each voxel of the stably sorted rows to its centroid at its
    first row."""
    order, keys = voxel_order(xyz, mask, min_bound, voxel_size, chunk)
    is_start = boundary_flags(*keys)
    w = mask[order].to(torch.float32)
    vals = torch.cat([xyz[order] * w[:, None], w[:, None]], dim=1)
    totals = segmented_scan(torch.add, vals, is_start, reverse=True)
    counts = totals[:, 3]
    centroids = totals[:, :3] / torch.clamp(counts, min=1.0)[:, None]
    out_mask = is_start & (counts > 0.0) & (keys[-3] != SENTINEL)
    return torch.where(out_mask[:, None], centroids, 0.0), out_mask
