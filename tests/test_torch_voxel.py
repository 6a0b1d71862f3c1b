"""The port's voxel downsampling against the JAX package's, on the CPU:
``voxel_downsample`` and ``voxel_downsample_chunked`` on the same seeded
inputs.

The output mask and row order must be identical and the centroids bit for
bit equal.  Bit equality is owed, not luck: the port sorts stably as
``lax.sort`` does (so a voxel's rows are summed in input order), and the
plain version of its segmented scan is the same Hillis-Steele doubling
scan as ``pointcloudhookup_tpu/ops/segments.py:103-121``, which the JAX
package runs on the CPU, so every sum is added in the same order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudhookup_tpu.ops import voxel as jvoxel
from pointcloudhookup_tpu_torch.ops import voxel as tvoxel

torch.set_num_threads(2)


def _padded(pts, cap):
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = pts
    return xyz, np.arange(cap) < len(pts)


def _both(xyz, mask, voxel_size, chunk_size=None):
    """(port, JAX) results as numpy: (out_xyz, out_mask)."""
    if chunk_size is None:
        ref = jvoxel.voxel_downsample(jnp.asarray(xyz), jnp.asarray(mask), voxel_size)
        got = tvoxel.voxel_downsample(torch.from_numpy(xyz), torch.from_numpy(mask), voxel_size)
    else:
        ref = jvoxel.voxel_downsample_chunked(
            jnp.asarray(xyz), jnp.asarray(mask), voxel_size, chunk_size=chunk_size)
        got = tvoxel.voxel_downsample_chunked(
            torch.from_numpy(xyz), torch.from_numpy(mask), voxel_size, chunk_size=chunk_size)
    return tuple(g.numpy() for g in got), tuple(np.asarray(r) for r in ref)


def _assert_identical(got, ref):
    (gx, gm), (rx, rm) = got, ref
    assert gx.dtype == np.float32 and gm.dtype == bool
    np.testing.assert_array_equal(gm, rm)
    np.testing.assert_array_equal(gx.view(np.uint32), rx.view(np.uint32))
    assert gm.any()


def _cloud(seed, n, cap, scale=(30.0, 20.0, 8.0), dup_share=0.5):
    """n rows of a centred tile padded to cap; about dup_share of them
    share a voxel with another row."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, size=(n, 3)) * np.asarray(scale)
    k = int(n * dup_share)
    pts[:k] = pts[rng.integers(k, n, k)] + rng.uniform(-0.02, 0.02, size=(k, 3))
    return _padded(pts[rng.permutation(n)].astype(np.float32), cap)


@pytest.mark.parametrize("voxel_size", [0.1, 0.5, 2.0])
def test_voxel_downsample_matches_jax(voxel_size):
    xyz, mask = _cloud(1, 3000, 4096)
    _assert_identical(*_both(xyz, mask, voxel_size))


@pytest.mark.parametrize("chunk_size", [512, 1024])
def test_voxel_downsample_chunked_matches_jax(chunk_size):
    xyz, mask = _cloud(2, 3500, 4096)
    _assert_identical(*_both(xyz, mask, 0.25, chunk_size))


def test_voxel_size_as_tensor():
    xyz, mask = _cloud(3, 1000, 1024)
    ref = tvoxel.voxel_downsample(torch.from_numpy(xyz), torch.from_numpy(mask), 0.3)
    got = tvoxel.voxel_downsample(torch.from_numpy(xyz), torch.from_numpy(mask),
                                  torch.tensor(0.3))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def _edge_rows(voxel_size):
    """Rows one ulp below and above voxel edges k * voxel_size, on each
    axis, with the min bound at 0 (a row at the origin)."""
    vs = np.float32(voxel_size)
    edges = (np.arange(1, 200, dtype=np.float32) * vs).astype(np.float32)
    vals = np.concatenate([np.nextafter(edges, np.float32(0)), edges,
                           np.nextafter(edges, np.float32(1e9))]).astype(np.float32)
    rng = np.random.default_rng(4)
    rows = np.stack([rng.permutation(vals) for _ in range(3)], axis=1)
    return np.concatenate([np.zeros((1, 3), np.float32), rows]).astype(np.float32)


@pytest.mark.parametrize("voxel_size", [0.1, 0.3, 0.7])
def test_voxel_edges_round_as_xla(voxel_size):
    """The JAX function divides by the traced voxel_size; the port must
    divide too.  The rows one ulp either side of an edge include some whose
    voxel differs between the division and a multiplication by the f32
    reciprocal, so a port that multiplied would fail here."""
    rows = _edge_rows(voxel_size)
    vs = np.float32(voxel_size)
    by_div = np.floor(rows / vs)
    by_mul = np.floor(rows * (np.float32(1) / vs))
    assert (by_div != by_mul).any()
    xyz, mask = _padded(rows, 1024)
    _assert_identical(*_both(xyz, mask, voxel_size))
    _assert_identical(*_both(xyz, mask, voxel_size, 512))


def test_chunks_sharing_a_voxel_key_stay_apart():
    """The last voxel of one chunk and the first voxel of the next have the
    same key (each chunk against its own min bound): they must stay two
    voxels, as in the JAX package's vmap over chunks."""
    rng = np.random.default_rng(5)
    c = 256
    xyz = np.zeros((3 * c, 3), np.float32)
    mask = np.zeros(3 * c, bool)
    # chunk 0: voxels (0,0,0) and (3,0,0); chunk 1 (full): (0,0,0) first
    xyz[:20] = rng.uniform(0, 0.09, (20, 3))
    xyz[20:40] = rng.uniform(0, 0.09, (20, 3)) + [0.3, 0, 0]
    mask[:40] = True
    xyz[c:2 * c] = rng.uniform(0, 0.09, (c, 3)) + [5.0, 5.0, 5.0]
    mask[c:2 * c] = True
    # chunk 2 starts with the same key as chunk 1 ends
    xyz[2 * c:2 * c + 30] = rng.uniform(0, 0.09, (30, 3)) - 7.0
    mask[2 * c:2 * c + 30] = True
    got, ref = _both(xyz, mask, 0.1, c)
    _assert_identical(got, ref)
    assert int(got[1].sum()) == 4
    _assert_identical(*_both(xyz, mask, 0.1))


def test_wide_key_range_and_sentinel_rows():
    """Keys beyond 21 bits a axis (a single 63-bit packing would not hold
    them) and masked rows scattered through the input."""
    rng = np.random.default_rng(6)
    n = 2048
    pts = rng.uniform(0, 2.0e4, size=(n, 3)).astype(np.float32)
    pts[: n // 2] = pts[rng.integers(n // 2, n, n // 2)]  # exact duplicates
    mask = rng.random(n) < 0.7
    got, ref = _both(pts, mask, 0.004)
    _assert_identical(got, ref)
    keys = np.floor((pts[mask] - pts[mask].min(0)) / np.float32(0.004))
    assert keys.max() >= 2**21
    _assert_identical(*_both(pts, mask, 0.004, 512))


def test_empty_and_fully_masked_chunk():
    xyz, mask = _cloud(7, 300, 1024)
    mask[:] = False
    got, ref = _both(xyz, mask, 0.1)
    np.testing.assert_array_equal(got[1], ref[1])
    assert not got[1].any()
    xyz, mask = _cloud(8, 600, 1024)  # chunk 1 of 512 rows holds 88 rows
    _assert_identical(*_both(xyz, mask, 0.1, 512))
    xyz2, mask2 = _cloud(9, 400, 1024)  # chunk 1 holds nothing
    _assert_identical(*_both(xyz2, mask2, 0.1, 512))
