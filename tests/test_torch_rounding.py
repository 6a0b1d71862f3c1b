"""The port rounds as XLA:CPU compiles the JAX package: a product feeding a
sum is one fused multiply-add.  Two places of the OBB finisher, held
against the jitted JAX functions on the CPU:

* the north angle, (90 - degrees(theta)) mod 360: bit-equal through the
  same atan2 output; end to end within one float32 ulp, because
  ``torch.atan2`` and the libm atan2 that XLA calls differ in the last bit
  for a few per cent of arguments (a standing deviation);
* the sort-based OBB (``cluster_obb_stats``) on 20,000 rows in 32
  clusters: angle, north angle, box centre and extent bit-equal; the
  centroid sums differ in order only (within 2 n u mean|x|).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pointcloudhookup_tpu.ops.obb import cluster_obb_stats as jax_cluster_obb_stats
from pointcloudhookup_tpu_torch.ops import obb as tobb


def _jax_north(theta):
    return jnp.mod(90.0 - jnp.degrees(theta), 360.0)


def test_north_angle_bit_equal_through_same_atan2():
    theta = np.random.default_rng(0).uniform(-math.pi, math.pi, 200_000).astype(np.float32)
    ref = np.asarray(jax.jit(_jax_north)(theta))
    got = tobb.north_angle_deg(torch.from_numpy(theta)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_north_angle_end_to_end_within_one_ulp():
    """torch.atan2 and XLA's atan2 differ by at most one ulp of theta; the
    north angle then by at most what that ulp makes of it."""
    rng = np.random.default_rng(1)
    y, x = rng.uniform(-1.0, 1.0, (2, 200_000)).astype(np.float32)
    jax_theta = np.asarray(jax.jit(jnp.arctan2)(y, x))
    ref = np.asarray(jax.jit(lambda a, b: _jax_north(jnp.arctan2(a, b)))(y, x))
    theta = torch.atan2(torch.from_numpy(y), torch.from_numpy(x))
    ulps = np.abs(theta.numpy().view(np.int32).astype(np.int64)
                  - jax_theta.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    got = tobb.north_angle_deg(theta).numpy()
    d = np.abs(got.astype(np.float64) - ref)
    d = np.minimum(d, 360.0 - d)  # 0 and 360 are one angle
    bound = (np.degrees(np.spacing(np.abs(jax_theta)))
             + np.spacing(np.maximum(np.abs(got), np.abs(ref))))
    assert (d <= bound).all()
    np.testing.assert_array_equal(got[ulps == 0], ref[ulps == 0])


def _clusters(seed, n=20_000, k=32):
    rng = np.random.default_rng(seed)
    lab = rng.integers(-1, k, n).astype(np.int32)
    cen = rng.uniform(-500, 500, (k, 3))
    ang = rng.uniform(0, np.pi, k)
    ext = rng.uniform(2, 20, (k, 3))
    loc = rng.uniform(-0.5, 0.5, (n, 3)) * ext[lab]
    c, s = np.cos(ang[lab]), np.sin(ang[lab])
    xyz = np.stack([loc[:, 0] * c - loc[:, 1] * s, loc[:, 0] * s + loc[:, 1] * c,
                    loc[:, 2]], 1) + cen[lab]
    return xyz.astype(np.float32), lab, np.ones(n, bool)


def test_sort_obb_mismatches_counted():
    """Before the repair 5-8 of the 32 angles, ~17 extents and every centre
    differed in the last bits; the contractions XLA makes here (the
    projections, the gathered angle, the centre) are now mirrored."""
    k = 32
    xyz, lab, mask = _clusters(0, k=k)
    ref = jax.jit(lambda a, b, c: jax_cluster_obb_stats(a, b, c, max_clusters=k))(xyz, lab, mask)
    ref = {key: np.asarray(v) for key, v in ref.items()}
    got = tobb.cluster_obb_stats(torch.from_numpy(xyz), torch.from_numpy(lab),
                                 torch.from_numpy(mask), max_clusters=k)
    got = {key: v.numpy() for key, v in got.items()}
    mismatched = {key: int((got[key] != ref[key]).sum())
                  for key in ("angle", "north_angle", "center", "extent")}
    assert mismatched["angle"] < 8
    assert mismatched == dict(angle=0, north_angle=0, center=0, extent=0)
    alive = ref["alive"]
    bound = 2 * ref["count"][alive, None] * 2.0**-24 * np.abs(ref["centroid"][alive]) + 1e-5
    assert (np.abs(got["centroid"][alive] - ref["centroid"][alive]) <= bound).all()
