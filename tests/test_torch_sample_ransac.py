"""random_downsample and the RANSAC ground functions of the port against
the JAX package, fed the JAX functions' own draws: the bits of
``jax.random.bits`` (ops/sample.py) and the triples of
``jax.random.categorical`` (ops/ground.py).  Given them, the port's
deterministic cores keep the same points and pick the same planes.

Tolerances: the kept rows are identical where the sort keys are distinct
(the JAX sort is unstable, so within a run of equal keys the sets are
compared).  The planes' normals and offsets round as XLA:CPU compiles the
JAX functions (d and the signed distances are fused multiply-add chains),
and the [N, H] inlier distances come from a full float32 matmul: on these
tiles every score, winner, normal, offset and kept row is equal; a row
could differ only where its distance ties the threshold to the last bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudhookup_tpu.ops import ground as jground
from pointcloudhookup_tpu.ops import sample as jsample
from pointcloudhookup_tpu_torch.ops import ground, sample


def _padded(rng, n, cap, span=100.0):
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n] = rng.uniform(-span, span, (n, 3))
    return xyz, np.arange(cap) < n


@pytest.mark.parametrize("n,cap,max_points", [(1000, 1024, 256), (1000, 1024, 2000),
                                              (30000, 32768, 20000), (5, 64, 3)])
def test_random_downsample_from_jax_bits(n, cap, max_points):
    rng = np.random.default_rng(n)
    xyz, mask = _padded(rng, n, cap)
    key = jax.random.key(n)
    ref_xyz, ref_keep = (np.asarray(a) for a in jsample.random_downsample(
        jnp.asarray(xyz), jnp.asarray(mask), key, max_points))
    bits = np.asarray(jax.random.bits(key, (cap,), jnp.uint32))
    got_xyz, got_keep = (a.numpy() for a in sample.random_downsample_from_bits(
        torch.from_numpy(xyz), torch.from_numpy(mask), torch.from_numpy(bits.astype(np.int64)),
        max_points))
    assert got_xyz.dtype == ref_xyz.dtype and np.array_equal(got_keep, ref_keep)
    assert int(got_keep.sum()) == min(n, max_points)
    # row by row where the key is unique; as sets within runs of equal keys
    key_s = np.sort(np.where(mask, bits >> 1, 0xFFFFFFFF))
    runs = np.flatnonzero(np.diff(key_s) != 0) + 1
    for lo, hi in zip(np.r_[0, runs], np.r_[runs, cap]):
        g = {tuple(r) for r in got_xyz[lo:hi]}
        assert g == {tuple(r) for r in ref_xyz[lo:hi]}, (lo, hi)


def test_random_downsample_draw_and_chunk_size():
    rng = np.random.default_rng(2)
    xyz, mask = _padded(rng, 1000, 1024)
    out, keep = sample.random_downsample(torch.from_numpy(xyz), torch.from_numpy(mask), 256,
                                         generator=torch.Generator().manual_seed(0))
    assert int(keep.sum()) == 256
    kept = {tuple(p) for p in out[keep].numpy()}
    assert kept <= {tuple(p) for p in xyz[:1000]} and len(kept) == 256
    again = sample.random_downsample(torch.from_numpy(xyz), torch.from_numpy(mask), 256,
                                     generator=torch.Generator().manual_seed(0))[0]
    assert torch.equal(out, again)
    _, keep2 = sample.random_downsample(torch.from_numpy(xyz), torch.from_numpy(mask), 2000)
    assert int(keep2.sum()) == 1000
    for gb in (2, 4, 6, 8, 12, 16, 64):
        assert sample.recommend_chunk_size(gb) == jsample.recommend_chunk_size(gb)


def _ground_tile(rng, n_ground, n_tower=0, slope=0.0, wave=0.0, noise=0.05, span=100.0):
    xy = rng.uniform(-span, span, (n_ground, 2))
    z = slope * xy[:, 0] + wave * np.sin(xy[:, 0] / 30.0) + rng.normal(0, noise, n_ground)
    pts = [np.column_stack([xy, z])]
    if n_tower:
        tx = rng.uniform(-span / 2, span / 2)
        pts.append(np.column_stack([rng.uniform(-3, 3, n_tower) + tx, rng.uniform(-3, 3, n_tower),
                                    slope * tx + rng.uniform(3, 30, n_tower)]))
    return np.vstack(pts).astype(np.float32)


def _jax_triples(mask, key, h):
    probs = jnp.asarray(mask).astype(jnp.float32)
    logits = jnp.log(probs / jnp.sum(probs) + 1e-30)
    return np.array(jax.random.categorical(key, logits, shape=(h, 3)))


@jax.jit
def _jax_scores(xyz, mask, idx, dist_thresh):
    """The JAX ransac_plane body up to its argmax (ops/ground.py), to hold
    the port's scores and winner against."""
    p0, p1, p2 = (xyz[idx[:, i]] for i in range(3))
    normal = jnp.cross(p1 - p0, p2 - p0)
    norm = jnp.linalg.norm(normal, axis=1, keepdims=True)
    normal = normal / jnp.maximum(norm, 1e-12)
    d = -jnp.sum(normal * p0, axis=1)
    dist = jnp.abs(jnp.dot(xyz, normal.T, precision=jax.lax.Precision.HIGHEST) + d[None, :])
    inl = (dist <= dist_thresh) & mask[:, None]
    scores = jnp.where(norm[:, 0] < 1e-9, -1, jnp.sum(inl.astype(jnp.int32), axis=0))
    return scores, jnp.argmax(scores)


@pytest.mark.parametrize("h,thresh,outliers", [(256, 0.2, True), (64, 0.3, False)])
def test_ransac_plane_from_jax_triples(h, thresh, outliers):
    rng = np.random.default_rng(h)
    xyz = _ground_tile(rng, 4000, slope=0.1)
    if outliers:
        extra = rng.uniform(-50, 50, (400, 3)).astype(np.float32)
        extra[:, 2] += 30.0
        xyz = np.vstack([xyz, extra])
    mask = np.ones(len(xyz), bool)
    mask[::50] = False
    key = jax.random.key(7)
    idx = _jax_triples(mask, key, h)
    ref = [np.asarray(a) for a in jground.ransac_plane(jnp.asarray(xyz), jnp.asarray(mask),
                                                      key, thresh, h)]
    jscores, jbest = (np.asarray(a) for a in _jax_scores(jnp.asarray(xyz), jnp.asarray(mask),
                                                          jnp.asarray(idx), thresh))
    t = (torch.from_numpy(xyz), torch.from_numpy(mask), torch.from_numpy(idx).long())
    normal, d, inl, best, scores = ground._best_plane(*t, thresh)
    assert int(best) == int(jbest) and np.array_equal(scores.numpy(), jscores)
    got = ground.ransac_plane_from_indices(*t, thresh)
    assert np.array_equal(got[0].numpy(), ref[0]) and float(got[1]) == float(ref[1])
    assert np.array_equal(got[2].numpy(), ref[2])
    # the JAX tests' properties
    n_true = np.array([0.1, 0.0, -1.0]) / np.linalg.norm([0.1, 0.0, -1.0])
    assert abs(np.dot(got[0].numpy(), n_true)) > 0.999
    assert got[2].numpy()[:4000][mask[:4000]].mean() > 0.9
    if outliers:
        assert got[2].numpy()[4000:].mean() < 0.05


def test_remove_ground_ransac_from_jax_triples():
    rng = np.random.default_rng(5)
    xyz = _ground_tile(rng, 3000, n_tower=150, wave=0.0)
    mask = np.ones(len(xyz), bool)
    key = jax.random.key(1)
    ref_keep, (ref_n, ref_d) = jground.remove_ground_ransac(jnp.asarray(xyz), jnp.asarray(mask),
                                                            key, 0.5, 256)
    idx = torch.from_numpy(_jax_triples(mask, key, 256)).long()
    keep, (normal, d) = ground.remove_ground_ransac_from_indices(
        torch.from_numpy(xyz), torch.from_numpy(mask), idx, 0.5)
    assert np.array_equal(normal.numpy(), np.asarray(ref_n)) and float(d) == float(ref_d)
    assert np.array_equal(keep.numpy(), np.asarray(ref_keep))
    assert keep[3000:].float().mean() > 0.95 and keep[:3000].float().mean() < 0.05
    # the draw from a torch generator finds the same ground
    keep_g, _ = ground.remove_ground_ransac(torch.from_numpy(xyz), torch.from_numpy(mask),
                                            torch.Generator().manual_seed(3), 0.5, 256)
    assert keep_g[3000:].float().mean() > 0.95 and keep_g[:3000].float().mean() < 0.05


def _jax_tile_triples(xyz, mask, key, grid, h):
    """The triples remove_ground_tiled_ransac draws (ops/ground.py:98-111):
    one key a tile, categorical over the tile's rows (every valid row for a
    tile of fewer than 3)."""
    tile = np.asarray(_jax_tile_ids(jnp.asarray(xyz), jnp.asarray(mask), grid))
    keys = jax.random.split(key, grid * grid)
    out = []
    for t in range(grid * grid):
        tmask = mask & (tile == t)
        out.append(_jax_triples(tmask if tmask.sum() >= 3 else mask, keys[t], h))
    return np.stack(out), tile


@jax.jit
def _jax_tile_ids(xyz, mask, grid=8):
    big = jnp.float32(3.0e38)
    mn = jnp.min(jnp.where(mask[:, None], xyz[:, :2], big), axis=0)
    mx = jnp.max(jnp.where(mask[:, None], xyz[:, :2], -big), axis=0)
    span = jnp.maximum(mx - mn, 1e-6)
    ij = jnp.clip(((xyz[:, :2] - mn) / span * grid).astype(jnp.int32), 0, grid - 1)
    return ij[:, 0] * grid + ij[:, 1]


@pytest.mark.parametrize("grid,sparse", [(4, False), (8, True)])
def test_tiled_ransac_from_jax_triples(grid, sparse):
    """Undulating ground with a tower on a slope; with ``sparse`` one corner
    of the lattice holds fewer than 3 rows (the whole-cloud fallback)."""
    rng = np.random.default_rng(grid)
    xyz = _ground_tile(rng, 3000, n_tower=150, slope=0.2, wave=0.5, noise=0.1)
    mask = np.ones(len(xyz), bool)
    if sparse:
        corner = (xyz[:, 0] > 70) & (xyz[:, 1] > 70)
        mask &= ~corner
        mask[np.flatnonzero(corner)[:2]] = True
    key = jax.random.key(2)
    ref = np.asarray(jground.remove_ground_tiled_ransac(
        jnp.asarray(xyz), jnp.asarray(mask), key, dist_thresh=0.5, grid=grid,
        num_hypotheses=64))
    idx, tile = _jax_tile_triples(xyz, mask, key, grid, 64)
    got_tile = ground.tile_ids(torch.from_numpy(xyz), torch.from_numpy(mask), grid).numpy()
    assert np.array_equal(got_tile, tile)
    if sparse:
        assert (np.bincount(tile[mask], minlength=grid * grid) < 3).any()
    keep = ground.remove_ground_tiled_ransac_from_indices(
        torch.from_numpy(xyz), torch.from_numpy(mask), torch.from_numpy(idx).long(), 0.5,
        grid).numpy()
    assert np.array_equal(keep, ref), int((keep != ref).sum())
    assert keep[3000:].mean() > 0.9 and keep[:3000].mean() < 0.1
    drawn = ground.remove_ground_tiled_ransac(
        torch.from_numpy(xyz), torch.from_numpy(mask), torch.Generator().manual_seed(4),
        dist_thresh=0.5, grid=grid).numpy()
    assert drawn[3000:].mean() > 0.9 and drawn[:3000].mean() < 0.1


def test_ransac_chunks_agree_with_one_pass(monkeypatch):
    """Row chunks far smaller than the tile give the same plane, scores and
    inliers as one chunk."""
    rng = np.random.default_rng(9)
    xyz = torch.from_numpy(_ground_tile(rng, 5000, slope=0.05))
    mask = torch.ones(len(xyz), dtype=torch.bool)
    idx = ground.draw_triples(mask, 32, torch.Generator().manual_seed(1))
    whole = ground._best_plane(xyz, mask, idx, 0.3)
    monkeypatch.setattr(ground, "_CHUNK_ELEMS", 32 * 700)
    chunked = ground._best_plane(xyz, mask, idx, 0.3)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
