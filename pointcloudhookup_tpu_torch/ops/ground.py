"""Ground removal: the height-percentile cut and RANSAC planes.

Counterpart of ``pointcloudhookup_tpu/ops/ground.py``: ``ground_filter``,
``percentile_cut``, and the batched-hypothesis RANSAC of ``ransac_plane``,
``remove_ground_ransac`` and ``remove_ground_tiled_ransac``.

The JAX RANSAC draws its point triples from ``jax.random``, which a torch
generator cannot repeat, so each RANSAC function here is a draw
(``torch.multinomial`` from an explicit generator) and a ``_from_indices``
core that, given the same triples, picks the JAX function's plane.  The
[N, H] inlier distances are full float32 matmuls (never TF32), taken over
row chunks of at most ``_CHUNK_ELEMS`` elements, so no [N, H] tensor is
built; the tiled version fits each tile on its own rows, never on a
[T, N, H] tensor.  The plane offsets and the signed distances of the
removal round as XLA:CPU compiles the JAX functions: fused multiply-add
chains (``fma_f32``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pointcloudhookup_tpu_torch.config import GroundParams
from pointcloudhookup_tpu_torch.ops.geo import _full_f32_matmul
from pointcloudhookup_tpu_torch.ops.morton import fma_f32
from pointcloudhookup_tpu_torch.ops.percentile import masked_percentile

# elements of one [rows, hypotheses] distance chunk: 128 MiB of float32,
# with its flags and their int32 counts under 0.5 GiB
_CHUNK_ELEMS = 1 << 25


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


def draw_triples(mask, num_hypotheses: int, generator: Optional[torch.Generator] = None):
    """[H, 3] row indices drawn with replacement from the valid rows, by
    the JAX draw's weights p / sum(p) + 1e-30 (p = mask), on the
    generator's device (the mask's without one)."""
    where = generator.device if generator is not None else mask.device
    p = mask.to(device=where, dtype=torch.float32)
    idx = torch.multinomial(p / p.sum() + 1e-30, 3 * num_hypotheses, replacement=True,
                            generator=generator)
    return idx.reshape(num_hypotheses, 3).to(mask.device)


def _planes(xyz, idx):
    """Unit normals f32[H, 3], offsets d (n.p + d = 0) and the degenerate
    flags of the planes through the [H, 3] row triples."""
    p0, p1, p2 = (xyz[idx[:, i]] for i in range(3))
    normal = torch.linalg.cross(p1 - p0, p2 - p0)
    norm = torch.linalg.vector_norm(normal, dim=1, keepdim=True)
    normal = normal / torch.clamp(norm, min=1e-12)
    # d as XLA:CPU compiles the JAX sum of products: two fused multiply-adds
    d = fma_f32(normal[:, 2], p0[:, 2], fma_f32(normal[:, 1], p0[:, 1], normal[:, 0] * p0[:, 0]))
    return normal, -d, norm[:, 0] < 1e-9


def _inlier_chunks(xyz, mask, normal, d, dist_thresh):
    """Yield (row slice, inlier bool[rows, H]) over row chunks: |xyz . n +
    d| <= dist_thresh on valid rows, in full float32."""
    n, h = xyz.shape[0], normal.shape[0]
    rows = max(1024, _CHUNK_ELEMS // max(h, 1))
    with _full_f32_matmul():
        for s in range(0, n, rows):
            sl = slice(s, s + rows)
            dist = (xyz[sl] @ normal.T).add_(d).abs_()
            yield sl, dist.masked_fill_(~mask[sl, None], torch.inf) <= dist_thresh


def _best_plane(xyz, mask, idx, dist_thresh):
    """The plane of the most inliers among the triples (the first on a
    tie, as jnp.argmax), flipped to nz >= 0, its inlier rows, the winner's
    index and every hypothesis's score (-1 where degenerate)."""
    normal, d, degenerate = _planes(xyz, idx)
    scores = torch.zeros(idx.shape[0], dtype=torch.int64, device=xyz.device)
    for _, inl in _inlier_chunks(xyz, mask, normal, d, dist_thresh):
        scores += inl.sum(0, dtype=torch.int32)
    scores = torch.where(degenerate, -1, scores)
    best = torch.argmax(scores)
    # the same chunked products again, so the winner's column is the one
    # that was counted
    inliers = torch.zeros(xyz.shape[0], dtype=torch.bool, device=xyz.device)
    for sl, inl in _inlier_chunks(xyz, mask, normal, d, dist_thresh):
        inliers[sl] = inl[:, best]
    flip = torch.where(normal[best, 2] < 0, -1.0, 1.0)
    return normal[best] * flip, d[best] * flip, inliers, best, scores


def ransac_plane_from_indices(xyz, mask, idx, dist_thresh=0.3):
    """The RANSAC fit given the hypotheses' row triples idx int[H, 3]:
    (normal f32[3] with unit norm and nz >= 0, offset d, inlier bool[N])."""
    return _best_plane(xyz, mask, idx, dist_thresh)[:3]


def ransac_plane(xyz, mask, generator: Optional[torch.Generator] = None, dist_thresh=0.3,
                 num_hypotheses: int = 256):
    """Batched-hypothesis RANSAC plane fit: num_hypotheses triples drawn
    from ``generator``, every candidate plane scored by its inlier count in
    one pass, the best returned as (normal, d, inlier bool[N])."""
    return ransac_plane_from_indices(
        xyz, mask, draw_triples(mask, num_hypotheses, generator), dist_thresh)


def _signed(xyz, normal, d):
    """xyz . normal + d a row (normal and d [3] and [], or [N, 3] and [N]),
    as XLA:CPU compiles the JAX package's ``xyz @ normal + d`` and
    ``sum(xyz * normal, 1) + d``: two fused multiply-adds, then + d."""
    n = normal.expand(xyz.shape[0], 3)
    return fma_f32(xyz[:, 2], n[:, 2], fma_f32(xyz[:, 1], n[:, 1], xyz[:, 0] * n[:, 0])) + d


def remove_ground_ransac_from_indices(xyz, mask, idx, dist_thresh=0.5):
    """remove_ground_ransac given the triples idx int[H, 3]."""
    normal, d, _ = ransac_plane_from_indices(xyz, mask, idx, dist_thresh)
    return mask & (_signed(xyz, normal, d) > dist_thresh), (normal, d)


def remove_ground_ransac(xyz, mask, generator: Optional[torch.Generator] = None,
                         dist_thresh=0.5, num_hypotheses: int = 256):
    """Remove the dominant plane's inliers and everything below it (keeps
    the points above the plane + dist_thresh).  Returns (keep, (normal,
    d))."""
    return remove_ground_ransac_from_indices(
        xyz, mask, draw_triples(mask, num_hypotheses, generator), dist_thresh)


def tile_ids(xyz, mask, grid: int = 8):
    """Each row's tile of the grid x grid lattice over the valid rows' xy
    bounds: int64[N] (i * grid + j)."""
    big = torch.tensor(3.0e38, dtype=xyz.dtype, device=xyz.device)
    xy = xyz[:, :2]
    mn = torch.where(mask[:, None], xy, big).amin(0)
    mx = torch.where(mask[:, None], xy, -big).amax(0)
    span = torch.clamp(mx - mn, min=1e-6)
    ij = torch.clamp(((xy - mn) / span * grid).to(torch.int32), 0, grid - 1).long()
    return ij[:, 0] * grid + ij[:, 1]


def _tile_rows(xyz, mask, grid):
    """(tile id int64[N], each tile's fit rows in ascending order: its own
    valid rows, or every valid row where it has fewer than 3, as the JAX
    package's ``tmask | (~has & mask)``)."""
    tile = tile_ids(xyz, mask, grid)
    t = grid * grid
    keyed = torch.where(mask, tile, t)
    order = torch.sort(keyed, stable=True).indices
    counts = torch.bincount(keyed, minlength=t + 1)[:t].cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    every = torch.nonzero(mask).squeeze(1)
    fit = [order[s:s + c] if c >= 3 else every for s, c in zip(starts, counts)]
    return tile, fit


def draw_tile_triples(xyz, mask, grid: int = 8, num_hypotheses: int = 64,
                      generator: Optional[torch.Generator] = None):
    """[T, H, 3] row indices: each tile's triples drawn with replacement
    from its fit rows (uniformly, the JAX draw's weights on them)."""
    _, fit = _tile_rows(xyz, mask, grid)
    out = []
    for rows in fit:
        where = generator.device if generator is not None else rows.device
        pick = torch.multinomial(torch.ones(max(len(rows), 1), device=where),
                                 3 * num_hypotheses, replacement=True, generator=generator)
        out.append(rows[pick.to(rows.device)] if len(rows) else pick.to(rows.device))
    return torch.stack(out).reshape(grid * grid, num_hypotheses, 3)


def remove_ground_tiled_ransac_from_indices(xyz, mask, idx, dist_thresh=0.5, grid: int = 8):
    """remove_ground_tiled_ransac given each tile's triples idx int[T, H, 3]
    (T = grid * grid, global row indices): each tile's plane is fit on its
    own rows (every valid row for a tile of fewer than 3), and a row is kept
    where it lies above its tile's plane + dist_thresh."""
    tile, normals, ds, _ = tile_planes(xyz, mask, idx, dist_thresh, grid)
    return mask & (_signed(xyz, normals[tile], ds[tile]) > dist_thresh)


def tile_planes(xyz, mask, idx, dist_thresh=0.5, grid: int = 8):
    """Each tile's RANSAC plane from its triples idx int[T, H, 3]: (tile id
    int64[N], normals f32[T, 3], offsets f32[T], winning hypothesis int64[T])."""
    tile, fit = _tile_rows(xyz, mask, grid)
    planes = []
    for t, rows in enumerate(fit):
        planes.append(_best_plane(xyz[rows], torch.ones(len(rows), dtype=torch.bool,
                                                        device=xyz.device),
                                  _local(idx[t], rows), dist_thresh))
    return (tile, torch.stack([p[0] for p in planes]), torch.stack([p[1] for p in planes]),
            torch.stack([p[3] for p in planes]))


def _local(idx, rows):
    """Global row indices idx as positions in the ascending row list rows."""
    return torch.searchsorted(rows, idx)


def remove_ground_tiled_ransac(xyz, mask, generator: Optional[torch.Generator] = None,
                               tile_size=15.0, dist_thresh=0.5, grid: int = 8,
                               num_hypotheses: int = 64):
    """Tiled RANSAC for undulating terrain: rows are assigned to a grid x
    grid XY lattice over the data bounds (``tile_size`` is unused, as in
    the JAX package), a plane is fit per tile on that tile's rows, and a
    row is kept if it is above its own tile's plane."""
    del tile_size  # the lattice is derived from the data bounds
    idx = draw_tile_triples(xyz, mask, grid, num_hypotheses, generator)
    return remove_ground_tiled_ransac_from_indices(xyz, mask, idx, dist_thresh, grid)
