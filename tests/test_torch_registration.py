"""Registration (``ops/registration.py``) and ICP refinement
(``models/refine.py``, ``correct(icp=True)``) of the port on the CPU.

The first eight tests mirror ``tests/test_registration.py`` and
``tests/test_refine.py`` against the port's functions.  The rest hold the
port against the JAX package on the same numpy inputs:

* ``kabsch``: R and t within 1e-5;
* ``_nearest`` (the sweep's plain version, ``ops/kernels/nearest.py``):
  the same index wherever the best and the second-best d^2
  are more than 1e-4 apart; d^2 within 1e-5 of the exact value (the port
  takes |a - b|^2 directly; the JAX module's |a|^2 + |b|^2 - 2 a.b rounds
  by up to ~3e-4 at |x| ~ 10 m);
* ``icp``, ``batched_icp``, ``register_tower_pairs`` (padded, varied sizes):
  R within 1e-4, t within 1e-4 m, rmse within 1e-4 m (below 0.03 m on both
  sides for an exact fit, whose rmse is rounding noise), the inlier share
  within one row;
* ``tower_frame_template``: bit-identical;
* ``refine_tower_centers`` and ``correct(icp=True)`` on config 4's
  ``gim_scenario`` corridor: the same pairs, refined centres within 1e-3 m;
* the tiled ``_nearest`` equals the untiled one exactly;
* the plain sweep's rules that the card's kernel (``csrc/nearest.cu``) is
  held to: the first index on exact ties, index 0 and d^2 +inf where every
  destination is masked or +inf away, the first NaN, masks that are not
  prefixes, ``_moved``'s fused order; ``nearest_moved`` takes the plain
  path for CPU tensors, and ``plan`` splits the work by B, N and M;
* ``refine_tower_centers`` on the member clouds of the 4M bench tile's
  towers 2 and 10 (``tests/fixtures/torch_icp_widened.npz``): the JAX
  refinement's centres, and the card's, within 1e-3 m.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from pointcloudhookup_tpu.config import ClusterParams as JClusterParams
from pointcloudhookup_tpu.config import ExtractParams as JExtractParams
from pointcloudhookup_tpu.config import GroundParams as JGroundParams
from pointcloudhookup_tpu.models import pipeline as jpipe
from pointcloudhookup_tpu.models import refine as jrefine
from pointcloudhookup_tpu.ops import registration as jreg
from pointcloudhookup_tpu_torch import state
from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams
from pointcloudhookup_tpu_torch.io.synthetic import build_synthetic_gim, synthetic_corridor
from pointcloudhookup_tpu_torch.models import pipeline
from pointcloudhookup_tpu_torch.models.refine import refine_tower_centers, tower_frame_template
from pointcloudhookup_tpu_torch.ops import registration as reg
from pointcloudhookup_tpu_torch.ops.kernels import nearest
from pointcloudhookup_tpu_torch.ops.geo import tm_forward, tm_inverse

CPU = "cpu"


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rot_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


# ----------------------------------------------- mirrors of the JAX tests
def test_kabsch_exact_recovery(rng):
    src = rng.normal(0, 5, size=(200, 3)).astype(np.float32)
    r_true = _rot_z(0.3)
    t_true = np.array([1.5, -2.0, 0.7], np.float32)
    dst = (src @ r_true.T + t_true).astype(np.float32)
    r, t = reg.kabsch(*_t(src[None], dst[None], np.ones((1, 200), np.float32)))
    np.testing.assert_allclose(r[0].numpy(), r_true, atol=1e-4)
    np.testing.assert_allclose(t[0].numpy(), t_true, atol=1e-4)


def test_kabsch_weighted_ignores_outliers(rng):
    src = rng.normal(0, 5, size=(100, 3)).astype(np.float32)
    r_true = _rot_z(-0.2)
    dst = (src @ r_true.T).astype(np.float32)
    dst[:10] += 100.0
    w = np.ones(100, np.float32)
    w[:10] = 0.0
    r, _ = reg.kabsch(*_t(src[None], dst[None], w[None]))
    np.testing.assert_allclose(r[0].numpy(), r_true, atol=1e-4)


def _tower_cloud(rng, n):
    t_param = rng.uniform(0, 1, n)
    half = 6.0 * (1 - 0.7 * t_param)
    return np.column_stack([
        rng.uniform(-1, 1, n) * half, rng.uniform(-1, 1, n) * half, t_param * 35.0,
    ]).astype(np.float32)


def test_icp_converges_small_perturbation(rng):
    cloud = _tower_cloud(rng, 600)
    r_true = _rot_z(0.1)
    t_true = np.array([0.8, -0.5, 0.3], np.float32)
    dst = (cloud @ r_true.T + t_true).astype(np.float32)
    mask = np.ones(600, bool)
    out = reg.icp(*_t(cloud, mask, dst, mask), iters=30)
    assert float(out["rmse"]) < 0.15
    np.testing.assert_allclose(out["R"].numpy(), r_true, atol=0.02)
    np.testing.assert_allclose(out["t"].numpy(), t_true, atol=0.2)


def test_batched_icp_independent_pairs(rng):
    b, n = 4, 300
    src = rng.normal(0, 4, size=(b, n, 3)).astype(np.float32)
    rs = [_rot_z(a) for a in (0.05, -0.1, 0.15, 0.0)]
    ts = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0.5, 0.5, 0.5]], np.float32)
    dst = np.stack([src[i] @ rs[i].T + ts[i] for i in range(b)]).astype(np.float32)
    mask = np.ones((b, n), bool)
    out = reg.batched_icp(*_t(src, mask, dst, mask), iters=25)
    assert (out["rmse"].numpy() < 0.2).all()
    for i in range(b):
        np.testing.assert_allclose(out["R"][i].numpy(), rs[i], atol=0.05)


def test_register_tower_pairs_varied_sizes(rng):
    a = rng.normal(0, 3, size=(120, 3))
    b = rng.normal(0, 3, size=(80, 3))
    res = reg.register_tower_pairs(
        [a, b], [a + np.array([0.5, 0, 0]), b + np.array([0, 0.5, 0])], iters=15,
        device=CPU,
    )
    assert len(res) == 2
    np.testing.assert_allclose(res[0]["t"], [0.5, 0, 0], atol=0.05)
    np.testing.assert_allclose(res[1]["t"], [0, 0.5, 0], atol=0.05)
    assert res[0]["rmse"] < 0.05


def _perturbed_corridor(rng, n_towers=3, stub_reach=7.0):
    """tests/test_refine.py's corridor: lattice towers with a one-sided
    conductor stub that drags each box centre off the lattice axis."""
    e0, n0 = (float(v) for v in tm_forward(113.5, 28.2))
    height, width = 32.0, 12.0
    parts = [np.column_stack([
        e0 + rng.uniform(-250, 250, 6000), n0 + rng.uniform(-250, 250, 6000),
        rng.normal(0.0, 0.2, 6000) + 80.0,
    ])]
    truth = []
    for k in range(n_towers):
        cx, cy, base = e0 + (k - 1) * 160.0, n0 + 30.0 * (k % 2), 80.0
        t = rng.uniform(0, 1, 900)
        half = width / 2 * (1 - 0.6 * t)
        parts.append(np.column_stack([
            cx + rng.uniform(-1, 1, 900) * half, cy + rng.uniform(-1, 1, 900) * half,
            base + t * height,
        ]))
        m = 220
        parts.append(np.column_stack([
            cx + width / 2 + rng.uniform(0, stub_reach, m), cy + rng.normal(0, 0.6, m),
            base + height * rng.uniform(0.6, 0.85, m),
        ]))
        truth.append([cx, cy, base + height / 2])
    return np.vstack(parts), np.asarray(truth)


@pytest.fixture(scope="module")
def perturbed():
    pts, truth = _perturbed_corridor(np.random.default_rng(42))
    params = ExtractParams(cluster=ClusterParams(eps=5.0, min_points=40))
    towers, stats, _ = pipeline.extract_from_points(pts, params, device=CPU)
    labels = stats["labels"][: len(pts)]
    return pts, truth, towers, [pts[labels == t.label] for t in towers]


def test_template_shape():
    t = tower_frame_template(30.0, 12.0)
    assert t.dtype == np.float32
    assert abs(t[:, 2].min() + 15.0) < 1e-5 and abs(t[:, 2].max() - 15.0) < 1e-5
    np.testing.assert_allclose(t[:, :2].max(), 6.0, atol=1e-5)
    assert np.abs(t[t[:, 2] > 14.9][:, :2]).max() < 6.0 * 0.45


def test_refined_centers_beat_greedy(perturbed):
    pts, truth, towers, clouds = perturbed
    assert len(towers) == len(truth)
    refined = refine_tower_centers(towers, clouds, list(range(len(towers))),
                                   iters=30, max_corr_dist=2.0, device=CPU)
    assert set(refined) == set(range(len(towers)))
    for i, t in enumerate(towers):
        d = np.linalg.norm(truth[:, :2] - t.center[None, :2], axis=1)
        j = int(np.argmin(d))
        refined_err = float(np.linalg.norm(refined[i]["center"][:2] - truth[j, :2]))
        assert d[j] > 1.5, "fixture no longer perturbs the box center"
        assert refined_err < d[j] * 0.5, (i, d[j], refined_err)
        assert refined_err < 1.0, (i, refined_err)


def test_correct_icp_writes_refined_coordinates(perturbed):
    pts, truth, towers, clouds = perturbed
    gim_list = []
    for c in truth:
        lon, lat = (float(v) for v in tm_inverse(c[0], c[1]))
        gim_list.append(dict(lat=lat, lng=lon, h=float(c[2]) - 25.0, r=10.0,
                             properties={"杆塔编号": f"P{len(gim_list) + 1}"}))
    plain = pipeline.correct(gim_list, towers)
    res = pipeline.correct(gim_list, towers, icp=True, pc_clouds=clouds, device=CPU)
    assert res.pairs == plain.pairs and len(res.pairs) == len(truth)
    for gi, pi in res.pairs:
        assert res.converted_towers[pi].icp_rmse < 2.0
        lat_r, lng_r = float(res.gim_rows[gi][1]), float(res.gim_rows[gi][2])
        lat_g, lng_g = float(plain.gim_rows[gi][1]), float(plain.gim_rows[gi][2])
        t_lat, t_lng = gim_list[gi]["lat"], gim_list[gi]["lng"]
        assert np.hypot(lat_r - t_lat, lng_r - t_lng) < np.hypot(lat_g - t_lat, lng_g - t_lng)
    with pytest.raises(ValueError):
        pipeline.correct(gim_list, towers, icp=True)


# ----------------------------------------------- parity with the JAX package
def test_kabsch_matches_jax():
    rng = np.random.default_rng(0)
    b, n = 6, 257
    src = rng.normal(0, 8, (b, n, 3)).astype(np.float32)
    dst = (src @ _rot_z(0.2).T + rng.normal(0, 0.3, (b, n, 3))).astype(np.float32)
    w = rng.uniform(0, 1, (b, n)).astype(np.float32)
    w[:, :40] = 0.0
    r, t = reg.kabsch(*_t(src, dst, w))
    jr, jt = jax.jit(jax.vmap(jreg.kabsch))(src, dst, w)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-5)


def _padded_pairs(rng, sizes_n, sizes_m, n, m):
    b = len(sizes_n)
    src = np.zeros((b, n, 3), np.float32)
    dst = np.zeros((b, m, 3), np.float32)
    sm = np.zeros((b, n), bool)
    dm = np.zeros((b, m), bool)
    for i, (a, c) in enumerate(zip(sizes_n, sizes_m)):
        cloud = _tower_cloud(rng, max(a, c))
        rot = _rot_z(rng.uniform(-0.1, 0.1))
        shift = rng.uniform(-1, 1, 3)
        src[i, :a] = cloud[:a]
        dst[i, :c] = cloud[:c] @ rot.T + shift
        sm[i, :a] = True
        dm[i, :c] = True
    return src, sm, dst, dm


def test_nearest_matches_jax():
    rng = np.random.default_rng(1)
    src, sm, dst, dm = _padded_pairs(rng, [300, 120, 512], [256, 400, 64], 512, 400)
    idx, d2 = nearest._nearest(*_t(src, sm, dst, dm))
    jidx, jd2 = jax.jit(jax.vmap(jreg._nearest))(src, sm, dst, dm)
    jidx, jd2 = np.asarray(jidx), np.asarray(jd2)
    # the gap between each row's best and second-best d^2 (JAX's numbers)
    full = np.where(dm[:, None, :], ((src[:, :, None] - dst[:, None]) ** 2).sum(-1), np.inf)
    two = np.sort(full, axis=-1)[..., :2]
    clear = (two[..., 1] - two[..., 0]) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[clear], jidx[clear])
    np.testing.assert_array_equal(np.isinf(d2.numpy()), np.isinf(jd2))
    fin = np.isfinite(jd2)
    # the port takes |a - b|^2 directly: d^2 within a few float32 ulp of the
    # exact value, where the JAX module's |a|^2 + |b|^2 - 2 a.b is off by up
    # to ~3e-4 on these clouds
    picked = np.take_along_axis(dst.astype(np.float64), idx.numpy()[..., None], axis=1)
    exact = ((src.astype(np.float64) - picked) ** 2).sum(-1)
    np.testing.assert_allclose(d2.numpy()[fin], exact[fin], rtol=0, atol=1e-5)


def test_nearest_tiled_equals_untiled(monkeypatch):
    """Tiles of at most 1, 7 and 64 source rows (NEAREST_TILE_ELEMS lowered
    to that many [B, rows, M] elements; 64 splits 300 rows into five tiles
    of 60) give the untiled indices and d^2, bit for bit."""
    rng = np.random.default_rng(2)
    src, sm, dst, dm = _padded_pairs(rng, [300, 120], [256, 400], 300, 400)
    args = _t(src, sm, dst, dm)
    idx, d2 = nearest._nearest(*args)  # 2 x 400 columns: one tile of 300 rows
    for rows in (1, 7, 64):
        monkeypatch.setattr(nearest, "NEAREST_TILE_ELEMS", rows * 2 * 400)
        ti, td = nearest._nearest(*args)
        assert torch.equal(ti, idx) and torch.equal(td, d2)


def _sweep(src, sm, dst, dm, r=None, t=None):
    """nearest_moved on CPU tensors (the identity motion by default)."""
    b = src.shape[0]
    r = np.broadcast_to(np.eye(3, dtype=np.float32), (b, 3, 3)) if r is None else r
    t = np.zeros((b, 3), np.float32) if t is None else t
    return nearest.nearest_moved(*_t(src, sm, dst, dm, r, t))


def _fma32(a, b, c):
    """float32 a * b + c rounded once (the float64 form of fma_f32)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _brute_nearest(a, sm, dst, dm):
    """numpy's twin of _nearest on moved rows a: d^2 in the same order,
    np.argmin's first index (and first NaN), masked rows +inf."""
    with np.errstate(invalid="ignore", over="ignore"):
        e = [(a[:, :, None, k] - dst[:, None, :, k]).astype(np.float32) for k in range(3)]
        d2 = _fma32(e[2], e[2], _fma32(e[1], e[1], e[0] * e[0]))
    d2 = np.where(dm[:, None, :], d2, np.float32(np.inf))
    idx = np.argmin(d2, axis=-1)
    best = np.take_along_axis(d2, idx[..., None], axis=-1)[..., 0]
    return idx, np.where(sm, best, np.float32(np.inf))


@pytest.mark.parametrize("kind", ["duplicated", "equidistant"])
def test_nearest_first_index_on_exact_ties(kind):
    """Rows of equal d^2 (copies of one row, or rows one unit away on each
    axis) at scattered indices: the smallest index wins, in ``_nearest``
    and in the sweep."""
    m = 1500
    rng = np.random.default_rng(5)
    dst = rng.uniform(20, 30, (1, m, 3)).astype(np.float32)
    src = np.zeros((1, 4, 3), np.float32)
    src[0, 1] = [1.5, -2.0, 0.25]
    tied = [1207, 403, 911, 64, 1499]
    for k, j in enumerate(tied):
        off = np.zeros(3, np.float32)
        if kind == "equidistant":
            off[k % 3] = 1.0 if k < 3 else -1.0
        dst[0, j] = src[0, 1] + off
    sm, dm = np.ones((1, 4), bool), np.ones((1, m), bool)
    idx, d2, matched = _sweep(src, sm, dst, dm)
    assert int(idx[0, 1]) == min(tied)
    assert float(d2[0, 1]) == (0.0 if kind == "duplicated" else 1.0)
    np.testing.assert_array_equal(matched[0, 1].numpy(), dst[0, min(tied)])
    ref_i, ref_d = _brute_nearest(src, sm, dst, dm)
    np.testing.assert_array_equal(idx.numpy(), ref_i)
    np.testing.assert_array_equal(d2.numpy(), ref_d)


@pytest.mark.parametrize("how", ["masked", "infinite"])
def test_nearest_all_candidates_infinite(how):
    """A tower whose every destination is masked (or +inf away: |e|^2
    overflows float32) gives index 0 and d^2 +inf, as torch.argmin; a
    masked frame row reports +inf whatever its nearest row."""
    src = np.array([[[0.0, 0.0, 0.0], [1.0, 2.0, 3.0], [5.0, 5.0, 5.0]],
                    [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [2.0, 2.0, 2.0]]], np.float32)
    dst = np.array([[[1.0, 0.0, 0.0], [0.0, 2.0, 3.0], [4.0, 4.0, 4.0], [9.0, 9.0, 9.0]],
                    [[1e30, 0.0, 0.0], [0.0, -1e30, 0.0], [0.0, 0.0, 3e38], [1e20, 1e20, 1e20]]],
                   np.float32)
    sm = np.array([[True, False, True], [True, True, True]])
    dm = np.ones((2, 4), bool)
    if how == "masked":
        dm[1] = False
    idx, d2, _ = _sweep(src, sm, dst, dm)
    np.testing.assert_array_equal(idx[1].numpy(), [0, 0, 0])
    assert np.isposinf(d2[1].numpy()).all()
    np.testing.assert_array_equal(idx[0].numpy(), [0, 1, 2])
    np.testing.assert_array_equal(d2[0].numpy(), [1.0, np.inf, 3.0])


def test_nearest_nan_rule():
    """A NaN d^2 wins over every number and the first NaN is kept, as
    torch.argmin keeps it; a masked destination holding a NaN stays +inf;
    a frame row with a NaN coordinate takes the first valid row.  On the
    card's kernel the moved row (inf, 0, 0) goes the same way."""
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    src = np.array([[[0.0, 0.0, 0.0], [nan, 0.0, 0.0], [inf, 0.0, 0.0], [3.0, 3.0, 3.0]]],
                   np.float32)
    dst = np.array([[[0.0, 0.0, 0.0], [0.0, nan, 1.0], [0.0, 0.0, 0.5], [inf, 0.0, 0.0],
                     [2.0, nan, 0.0], [3.0, 3.0, 3.0]]], np.float32)
    sm = np.array([[True, True, True, False]])
    dm = np.array([[False, True, True, True, True, True]])
    idx, d2, _ = _sweep(src, sm, dst, dm)
    # every row meets the NaN of destination row 1 first; frame rows 1 and
    # 2 are NaN themselves once moved (inf * 0 is NaN in the fused dot)
    np.testing.assert_array_equal(idx.numpy(), [[1, 1, 1, 1]])
    assert np.isnan(d2[0, :3].numpy()).all() and np.isposinf(float(d2[0, 3]))
    dm[0, 1] = dm[0, 4] = False  # the NaN rows masked: numbers only
    idx, d2, _ = _sweep(src, sm, dst, dm)
    np.testing.assert_array_equal(idx.numpy(), [[2, 2, 2, 5]])
    np.testing.assert_array_equal(d2[0, [0, 3]].numpy(), [0.25, inf])
    assert np.isnan(float(d2[0, 1])) and np.isnan(float(d2[0, 2]))
    eye = np.eye(3, dtype=np.float32)[None]
    moved = nearest._moved(*_t(src, eye, np.zeros((1, 3), np.float32))).numpy()
    ref_i, ref_d = _brute_nearest(moved, sm, dst, dm)
    np.testing.assert_array_equal(idx.numpy(), ref_i)
    np.testing.assert_array_equal(d2.numpy(), ref_d)


def test_nearest_non_prefix_masks():
    """Masks with holes on both sides (not pad_pairs' prefixes) and a
    moved frame: the sweep equals numpy's twin of it."""
    rng = np.random.default_rng(6)
    b, n, m = 3, 70, 333
    src = rng.normal(0, 5, (b, n, 3)).astype(np.float32)
    dst = rng.normal(0, 5, (b, m, 3)).astype(np.float32)
    sm = rng.random((b, n)) < 0.7
    dm = rng.random((b, m)) < 0.4
    dm[2, :] = False
    dm[2, 200] = True
    r = np.stack([_rot_z(a) for a in (0.1, -0.3, 0.7)]).astype(np.float32)
    t = rng.normal(0, 1, (b, 3)).astype(np.float32)
    idx, d2, matched = _sweep(src, sm, dst, dm, r, t)
    moved = nearest._moved(*_t(src, r, t)).numpy()
    ref_i, ref_d = _brute_nearest(moved, sm, dst, dm)
    np.testing.assert_array_equal(idx.numpy(), ref_i)
    np.testing.assert_array_equal(d2.numpy(), ref_d)
    assert (idx[2].numpy() == 200).all()
    np.testing.assert_array_equal(matched.numpy(), np.take_along_axis(dst, ref_i[..., None], 1))


def test_moved_fused_order():
    """_moved is fma(s2, r[i][2], fma(s1, r[i][1], s0 r[i][0])) + t[i],
    each step rounded to float32: the _dot3 order the card's kernel
    reproduces."""
    rng = np.random.default_rng(7)
    src = (rng.normal(0, 30, (4, 257, 3))).astype(np.float32)
    r = np.stack([_rot_z(a) @ _rot_z(0.2).T for a in rng.uniform(-1, 1, 4)]).astype(np.float32)
    r[:, 2, :] += rng.normal(0, 1e-3, (4, 3)).astype(np.float32)
    t = rng.normal(0, 10, (4, 3)).astype(np.float32)
    got = nearest._moved(*_t(src, r, t)).numpy()
    s = [src[..., k][..., None] for k in range(3)]
    rc = [r[:, None, :, k] for k in range(3)]
    want = (_fma32(s[2], rc[2], _fma32(s[1], rc[1], s[0] * rc[0])) + t[:, None, :]).astype(
        np.float32)
    np.testing.assert_array_equal(got, want)
    cols = [torch.from_numpy(c) for c in s]
    dot = nearest._dot3(cols, [torch.from_numpy(np.ascontiguousarray(c)) for c in rc])
    np.testing.assert_array_equal(got, (dot + torch.from_numpy(t)[:, None, :]).numpy())


def test_nearest_moved_cpu_takes_plain_path():
    """CPU tensors run the plain version: no launch, no count, and the
    results of _moved, _nearest and _gather_rows."""
    from pointcloudhookup_tpu_torch.utils import trace

    rng = np.random.default_rng(8)
    src, sm, dst, dm = _padded_pairs(rng, [40, 9], [30, 64], 40, 64)
    r = np.stack([_rot_z(0.05), _rot_z(-0.4)]).astype(np.float32)
    t = np.array([[0.5, 0.0, -1.0], [2.0, 1.0, 0.0]], np.float32)
    counted = trace.counter("icp.nearest_kernel")
    idx, d2, matched = nearest.nearest_moved(*_t(src, sm, dst, dm, r, t))
    assert trace.counter("icp.nearest_kernel") == counted
    ref_i, ref_d = nearest._nearest(nearest._moved(*_t(src, r, t)), *_t(sm, dst, dm))
    assert torch.equal(idx, ref_i) and torch.equal(d2, ref_d)
    assert torch.equal(matched, nearest._gather_rows(torch.from_numpy(dst), ref_i))


@pytest.mark.parametrize("shape,want", [
    ((50, 280, 14_000), (3, 3, 2, 15)),   # icp50.correct: 3 tiles of 96 rows a tower
    ((50, 2048, 2048), (4, 8, 1, 6)),     # config 4's batch
    ((24, 14_000, 600), (3, 8, 1, 2)),    # register: member clouds onto GIM pylons
    ((1, 1, 1), (2, 1, 8, 1)),
    ((3, 70, 333), (3, 1, 8, 1)),
])
def test_nearest_plan_follows_shape(shape, want):
    """The kernel's split on a 132-SM H100, from B, N and M alone: the
    fewest padded frame rows, up to eight warps a block, destination
    ranges until 32 warps an SM, each warp keeping 64 destination rows."""
    from pointcloudhookup_tpu_torch.ops.kernels import nearest

    b, n, m = shape
    rows, wt, wm, split = nearest.plan(b, n, m, 132)
    assert (rows, wt, wm, split) == want
    tiles = -(-n // (32 * rows))
    assert wt * wm <= 8 and wt <= tiles and split >= 1
    assert split <= max(1, -(-m // (wm * 64)))  # each warp keeps 64 destination rows


# an exact fit's rmse is the root of the rounding of |a|^2 + |b|^2 - 2 a.b
# (a few ulp of |a|^2 <= 40^2 a row): below this either way, and NaN in the
# JAX package where those roundings sum below 0 (the port clamps the sum)
RMSE_FLOOR = 0.03


def _check_icp(out, ref, n_valid):
    np.testing.assert_allclose(out["R"], ref["R"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["t"], ref["t"], rtol=0, atol=1e-4)
    got, want = np.atleast_1d(out["rmse"]), np.atleast_1d(ref["rmse"])
    exact = ~(want >= RMSE_FLOOR)
    assert (got[exact] < RMSE_FLOOR).all()
    np.testing.assert_allclose(got[~exact], want[~exact], rtol=0, atol=1e-4)
    assert (np.abs(np.asarray(out["inlier_frac"]) - ref["inlier_frac"])
            <= 1.0 / np.asarray(n_valid) + 1e-7).all()


@pytest.mark.parametrize("max_corr_dist", [float("inf"), 0.5])
def test_batched_icp_matches_jax(max_corr_dist):
    rng = np.random.default_rng(3)
    src, sm, dst, dm = _padded_pairs(rng, [300, 96, 512, 200], [256, 400, 500, 64], 512, 512)
    out = state.to_numpy(reg.batched_icp(*_t(src, sm, dst, dm), iters=12,
                                         max_corr_dist=max_corr_dist))
    ref = jreg.batched_icp(src, sm, dst, dm, iters=12, max_corr_dist=max_corr_dist)
    _check_icp(out, {k: np.asarray(v) for k, v in ref.items()}, sm.sum(1))
    one = state.to_numpy(reg.icp(*_t(src[1], sm[1], dst[1], dm[1]), iters=12,
                                 max_corr_dist=max_corr_dist))
    jone = jreg.icp(src[1], sm[1], dst[1], dm[1], iters=12, max_corr_dist=max_corr_dist)
    _check_icp(one, {k: np.asarray(v) for k, v in jone.items()}, sm[1].sum())


def test_register_tower_pairs_matches_jax():
    """Varied sizes padded as the JAX function pads them (N, M = the
    largest cloud, at least 8), including a cloud below 8 points."""
    rng = np.random.default_rng(4)
    sizes = [(150, 90), (5, 40), (230, 230), (60, 7)]
    src, dst = [], []
    for a, c in sizes:
        cloud = _tower_cloud(rng, max(a, c)).astype(np.float64)
        src.append(cloud[:a])
        dst.append(cloud[:c] @ _rot_z(0.05).T + rng.uniform(-0.5, 0.5, 3))
    got = reg.register_tower_pairs(src, dst, iters=10, max_corr_dist=3.0, device=CPU)
    ref = jreg.register_tower_pairs(src, dst, iters=10, max_corr_dist=3.0)
    for g, r, (a, _) in zip(got, ref, sizes):
        _check_icp(g, r, a)


@pytest.mark.parametrize("args", [(30.0, 12.0), (42.0, 9.5, 0.7), (35.0, 14.0, -1.2, 10, 4, 0.5)])
def test_tower_frame_template_bit_identical(args):
    got = tower_frame_template(*args)
    ref = jrefine.tower_frame_template(*args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _gim_scenario(tmp):
    """benchmarks/config4_icp.py::gim_scenario's corridor and GIM (seed 11:
    three towers, each with a one-sided stub, 杆塔高 35)."""
    rng = np.random.default_rng(11)
    e0, n0 = (float(v) for v in tm_forward(113.5, 28.2))
    tower_height = 35.0
    pts, centers = synthetic_corridor(
        rng, n_ground=4000, n_veg=800, pts_per_tower=500,
        towers=((0.0, 0.0), (160.0, 60.0), (-170.0, -80.0)),
        tower_height=tower_height, extent=300.0, origin=(e0, n0, 80.0),
    )
    stubs = []
    for c in centers:
        s = rng.uniform(0, 1, 120)
        stubs.append(np.column_stack([
            c[0] + 1.0 + s * 7.0, c[1] + rng.normal(0, 0.2, 120),
            c[2] + tower_height / 2 - 2.0 - 3.0 * s,
        ]))
    pts = np.vstack([pts] + stubs)
    gts = []
    for i, c in enumerate(centers):
        lon, lat = (float(v) for v in tm_inverse(c[0], c[1]))
        gts.append(dict(id=f"P{41 + i}", lat=lat, lng=lon, h=float(c[2]) - 25.0, r=0.0,
                        props={"杆塔编号": f"P{41 + i}", "杆塔高": f"{tower_height}",
                               "呼高": "24", "Kv值": "220", "转角": "0.0"}))
    gim = os.path.join(tmp, "truth.gim")
    build_synthetic_gim(gim, gts, workdir=os.path.join(tmp, "tree"))
    return pts, centers, gim


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cfg4"))
    pts, centers, gim = _gim_scenario(tmp)
    jparams = JExtractParams(ground=JGroundParams(min_points_after=100),
                             cluster=JClusterParams(eps=5.0, min_points=30),
                             max_clusters=32, obb_angles=128)
    jtowers, jstats, _ = jpipe.extract_from_points(pts, jparams, capacity=8192)
    params = state.extract_params_from_dict(dataclasses.asdict(jparams))
    towers, stats, _ = pipeline.extract_from_points(pts, params, capacity=8192, device=CPU)
    records, _, _ = pipeline.import_gim(gim, os.path.join(tmp, "out_t"))
    jrecords, _, _ = jpipe.import_gim(gim, os.path.join(tmp, "out_j"))
    jlab = jstats["labels"][: len(pts)]
    lab = stats["labels"][: len(pts)]
    return dict(pts=pts, centers=centers, towers=towers, jtowers=jtowers,
                clouds=[pts[lab == t.label] for t in towers],
                jclouds=[pts[jlab == t.label] for t in jtowers],
                records=records, jrecords=jrecords)


def test_refine_tower_centers_matches_jax(scenario):
    towers, clouds = scenario["jtowers"], scenario["jclouds"]
    assert len(towers) == len(scenario["centers"])
    tmpl = {i: (35.0, None) for i in range(len(towers))}
    got = refine_tower_centers(towers, clouds, list(range(len(towers))),
                               template_params=tmpl, device=CPU)
    ref = jrefine.refine_tower_centers(towers, clouds, list(range(len(towers))),
                                       template_params=tmpl)
    assert set(got) == set(ref)
    for i in ref:
        np.testing.assert_allclose(got[i]["center"], ref[i]["center"], rtol=0, atol=1e-3)
        assert abs(got[i]["rmse"] - ref[i]["rmse"]) < 1e-3


def test_correct_icp_matches_jax_on_gim_scenario(scenario):
    """Each package extracts, matches and refines on its own: the same
    pairs, the same partition, refined centres within 1e-3 m, and the ICP
    recovers most of the stub's bias."""
    s = scenario
    assert [t.num_points for t in s["towers"]] == [t.num_points for t in s["jtowers"]]
    got = pipeline.correct(s["records"], s["towers"], icp=True, pc_clouds=s["clouds"],
                           device=CPU)
    ref = jpipe.correct(s["jrecords"], s["jtowers"], icp=True, pc_clouds=s["jclouds"])
    assert got.pairs == ref.pairs and len(got.pairs) == len(s["centers"])
    for gi, pi in got.pairs:
        g, r = got.converted_towers[pi], ref.converted_towers[pi]
        np.testing.assert_allclose(g.original_center, r.original_center, rtol=0, atol=1e-3)
        assert abs(g.icp_rmse - r.icp_rmse) < 1e-3
        truth = s["centers"][gi]
        before = np.linalg.norm(s["towers"][pi].center[:2] - truth[:2])
        after = np.linalg.norm(np.asarray(g.original_center[:2]) - truth[:2])
        assert after < before


WIDENED = os.path.join(os.path.dirname(__file__), "fixtures", "torch_icp_widened.npz")


def test_refine_widened_boxes_match_jax():
    """The 4M bench tile's towers 2 and 10, whose boxes adopted vegetation
    (member clouds and box fields saved from the card by
    ``scripts/torch_icp_widened_fixture.py``): the port's refinement on
    the CPU gives the JAX refinement's centres and the card's within
    1e-3 m.  The JAX refinement too leaves each centre beyond 2 m (xy) of
    its member centroid, inside its box (within ey / 2)."""
    from pointcloudhookup_tpu_torch.models.towers import Tower

    fx = np.load(WIDENED)
    idx = [int(i) for i in fx["towers"]]
    assert idx == [2, 10]
    towers = [None] * (max(idx) + 1)
    clouds = [None] * (max(idx) + 1)
    tmpl = {}
    for i in idx:
        f = {k[len(f"t{i}_"):]: fx[k] for k in fx.files if k.startswith(f"t{i}_")}
        towers[i] = Tower(id=f"T{i}", center=f["center"], extent=f["extent"],
                          height=float(f["height"]), width=float(f["width"]),
                          north_angle=float(f["north_angle"]), angle=float(f["angle"]),
                          num_points=int(f["num_points"]), label=int(f["label"]))
        clouds[i] = f["cloud"]
        if np.isfinite(f["template_height"]):
            tmpl[i] = (float(f["template_height"]), None)
    kw = dict(iters=int(fx["iters"]), max_corr_dist=float(fx["max_corr_dist"]),
              template_params=tmpl or None)
    got = refine_tower_centers(towers, clouds, idx, device=CPU, **kw)
    ref = jrefine.refine_tower_centers(towers, clouds, idx, **kw)
    assert set(got) == set(ref) == set(idx)
    for i in idx:
        np.testing.assert_allclose(got[i]["center"], ref[i]["center"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[i]["center"], fx[f"t{i}_card_center"], rtol=0,
                                   atol=1e-3)
        off = np.linalg.norm(np.asarray(ref[i]["center"][:2]) - clouds[i].mean(axis=0)[:2])
        assert 2.0 < off <= towers[i].extent[1] / 2
