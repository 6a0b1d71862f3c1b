"""The port's host-side and tensor helpers against their JAX counterparts
on the same numpy inputs: Morton keys, both percentiles, label compaction,
stable row compaction, the OBB finisher, the tower filters, the state
converters and the parameter carrier, the host copies (config, LAS/LAZ
I/O, the synthetic corridor), and the import boundary (the port imports
nothing of jax or of the JAX package)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloudhookup_tpu import config as jconfig
from pointcloudhookup_tpu.config import TowerFilterParams
from pointcloudhookup_tpu.io import las as jlas
from pointcloudhookup_tpu.io import synthetic as jsynthetic
from pointcloudhookup_tpu.models import towers as jtowers
from pointcloudhookup_tpu.ops import cluster as jcluster
from pointcloudhookup_tpu.ops import morton as jmorton
from pointcloudhookup_tpu.ops import obb as jobb
from pointcloudhookup_tpu.ops import percentile as jpct
from pointcloudhookup_tpu.ops.pallas.obb_accum import obb_accumulate_xyz_reference
from pointcloudhookup_tpu_torch import config as tconfig
from pointcloudhookup_tpu_torch import state
from pointcloudhookup_tpu_torch.io import las as tlas
from pointcloudhookup_tpu_torch.io import synthetic as tsynthetic
from pointcloudhookup_tpu_torch.models import towers as ttowers
from pointcloudhookup_tpu_torch.ops import cluster as tcluster
from pointcloudhookup_tpu_torch.ops import morton as tmorton
from pointcloudhookup_tpu_torch.ops import obb as tobb
from pointcloudhookup_tpu_torch.ops import percentile as tpct

torch.set_num_threads(2)


def _n(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("bits", [(10, 10, 7), (8, 8, 5), (1, 12, 3), (11, 11, 10)])
def test_interleave_tight_matches_jax(bits):
    rng = np.random.default_rng(sum(bits))
    ijk = [rng.integers(0, 1 << b, 5000).astype(np.int32) for b in bits]
    ref = np.asarray(jmorton.interleave_tight(*map(jnp.asarray, ijk), bits))
    got = tmorton.interleave_tight(*map(torch.from_numpy, ijk), bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_n(got), ref.astype(np.int64))


def _pct_cases():
    rng = np.random.default_rng(11)
    for trial in range(10):
        n = int(rng.integers(2, 5000))
        x = rng.normal(scale=100, size=n).astype(np.float32)
        if trial % 3 == 0:
            x = np.round(x / 10) * 10  # heavy duplicates
        if trial % 4 == 1:
            x[: n // 3] = np.where(rng.random(n // 3) < 0.5, -0.0, 0.0)
        mask = rng.random(n) < 0.8
        mask[0] = True
        yield x.astype(np.float32), mask, float(rng.uniform(0, 100))
    yield np.array([7.5, -2.0], np.float32), np.array([True, False]), 25.0


def test_percentile_bisect_bit_identical():
    """The two order statistics are exactly the sorted masked values at
    floor(h) and floor(h)+1 (as np.sort orders them), and the lerp rounds
    exactly as the JAX function's: results are bit-identical."""
    for x, mask, q in _pct_cases():
        xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
        got = tpct.masked_percentile_bisect(xt, mt, q)
        ref = jpct.masked_percentile_bisect(jnp.asarray(x), jnp.asarray(mask), q)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert np.float32(_n(got)).view(np.uint32) == np.asarray(ref).view(np.uint32), q

        # order statistics against numpy's sort, bit for bit
        u = tpct._f32_ordered_bits(xt)
        np.testing.assert_array_equal(
            _n(u).astype(np.uint32),
            np.asarray(jpct._f32_ordered_bits(jnp.asarray(x))),
        )
        xs = np.sort(x[mask])
        h = np.float32(len(xs) - 1) * (np.float32(q) / np.float32(100))
        lo = int(np.floor(h))
        hi = min(lo + 1, len(xs) - 1)
        for rank, want in ((lo, xs[lo]), (hi, xs[hi])):
            bits = tpct._order_statistic_bits(u, mt, torch.tensor(rank))
            back = tpct._f32_from_ordered_bits(bits)
            assert np.float32(_n(back)) == want
        assert abs(float(got) - float(np.percentile(x[mask].astype(np.float64), q))) < 1e-2


def test_compact_labels_matches_jax():
    rng = np.random.default_rng(12)
    m = 4096
    raw = rng.choice(rng.integers(0, m, 50), m).astype(np.int32)
    raw[rng.random(m) < 0.3] = m  # noise
    ref = np.asarray(jcluster.compact_labels(jnp.asarray(raw), jnp.int32(m)))
    got = tcluster.compact_labels(torch.from_numpy(raw), m)
    np.testing.assert_array_equal(_n(got), ref)


@pytest.mark.parametrize("cap", [64, 300, 1000], ids=["overflow", "fits", "cap>n"])
def test_compact_valid_rows_matches_jax(cap):
    rng = np.random.default_rng(13)
    n = 700
    valid = rng.random(n) < 0.2
    pays = (np.arange(n, dtype=np.int32), rng.normal(size=n).astype(np.float32))
    (rf, rr), rn, ro = jobb._compact_valid_rows(
        jnp.asarray(valid), tuple(map(jnp.asarray, pays)), cap, fill=jnp.int32(n)
    )
    (gf, gr), gn, go = tobb._compact_valid_rows(
        torch.from_numpy(valid), tuple(map(torch.from_numpy, pays)), cap, fill=n
    )
    np.testing.assert_array_equal(_n(gf), np.asarray(rf))
    np.testing.assert_array_equal(_n(gr), np.asarray(rr))
    assert int(gn) == int(rn) and float(go) == float(ro)


def test_obb_from_accum_matches_jax():
    """Fed the SAME accumulators (from the JAX oracle, through state.py),
    the finisher agrees to one ULP of cos/sin: angles and north angles to
    1e-4 rad/deg, geometry to 1e-4 m on clusters of ~100 m extent."""
    rng = np.random.default_rng(14)
    k, a = 16, 64
    n = 6000
    xyz = rng.uniform(-60, 60, size=(n, 3)).astype(np.float32)
    lab = rng.integers(-1, k - 3, n).astype(np.int32)  # 3 dead clusters
    acc = obb_accumulate_xyz_reference(
        *(jnp.asarray(xyz[:, i]) for i in range(3)), jnp.asarray(lab),
        max_clusters=k, num_angles=a,
    )
    finish = jax.jit(jobb._obb_from_accum, static_argnums=(1, 2))  # as the JAX step runs it
    ref = {key: np.asarray(v) for key, v in finish(acc, k, a).items()}
    acc_t = state.to_torch({key: np.asarray(v) for key, v in acc.items()})
    got = state.to_numpy(tobb.obb_stats_from_accumulators(acc_t, k, a))
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape and got[key].dtype == ref[key].dtype
        if ref[key].dtype == bool:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=1e-4,
                                       err_msg=key)


def _stats_for_filters():
    rng = np.random.default_rng(15)
    k = 32
    center = rng.uniform(-100, 100, size=(k, 3)).astype(np.float32)
    center[5] = center[2] + np.float32(10.0)  # duplicate of an earlier one
    center[9] = center[5] + np.float32(5.0)  # chains through a rejected one
    ext = np.stack(
        [rng.uniform(5, 60, k), rng.uniform(1, 5, k), rng.uniform(5, 60, k)], 1
    ).astype(np.float32)
    alive = rng.random(k) < 0.9
    return dict(extent=ext, center=center, alive=alive)


@pytest.mark.parametrize(
    "fp", [TowerFilterParams(), TowerFilterParams(duplicate_threshold=80.0)],
    ids=["default", "wide-dedup"],
)
def test_filter_and_dedup_matches_jax(fp):
    stats = _stats_for_filters()
    ref = np.asarray(jtowers.filter_and_dedup(
        {k: jnp.asarray(v) for k, v in stats.items()}, fp
    ))
    got = ttowers.filter_and_dedup(state.to_torch(stats), fp)
    np.testing.assert_array_equal(_n(got), ref)
    assert ref.sum() > 0


def test_towers_from_stats_matches_jax():
    stats = _stats_for_filters()
    k = len(stats["alive"])
    stats.update(
        accepted=stats["alive"] & (np.arange(k) % 3 == 0),
        north_angle=np.linspace(0, 359, k).astype(np.float32),
        angle=np.linspace(0, 3, k).astype(np.float32),
        count=np.arange(k, dtype=np.float32) * 7,
    )
    origin = np.array([5e5, 3e6, 40.0])
    ref = jtowers.towers_from_stats(stats, origin)
    got = ttowers.towers_from_stats(stats, origin)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert (g.id, g.label, g.num_points) == (r.id, r.label, r.num_points)
        np.testing.assert_array_equal(g.center, r.center)
        np.testing.assert_array_equal(g.extent, r.extent)
        assert (g.height, g.width, g.north_angle, g.angle) == (
            r.height, r.width, r.north_angle, r.angle
        )


def test_state_roundtrip_dtypes():
    tree = dict(
        b=np.array([True, False]),
        i=np.array([1, -2], np.int32),
        f=np.float32(2.5),
        u=np.array([0, 0xFFFFFFFF], np.uint32),
        nested=(np.zeros(3, np.float32),),
    )
    t = state.to_torch(tree)
    assert t["b"].dtype == torch.bool and t["i"].dtype == torch.int32
    assert t["f"].dtype == torch.float32 and t["f"].dim() == 0
    assert t["u"].dtype == torch.int64 and int(t["u"][1]) == 0xFFFFFFFF
    back = state.to_numpy(t, u32=("u",))
    for key in ("b", "i", "f", "u"):
        assert back[key].dtype == np.asarray(tree[key]).dtype
        np.testing.assert_array_equal(back[key], tree[key])
    with pytest.raises(TypeError):
        state.to_torch(np.zeros(2, np.float64))


def test_port_never_imports_jax(tmp_path):
    """In a fresh interpreter, importing every module of the port and
    chip_smoke loads no jax* module, no module of the JAX package and none
    of PIL, pandas or matplotlib (the card's host has none of them); nor
    does a rank that parallel.launch spawns and that runs the sharded
    step."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pointcloudhookup_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) > 20, names\n"
        "new = {'ops.voxel', 'ops.geo', 'io.sevenzip', 'io.gim', 'io.cbm',\n"
        "       'ops.registration', 'models.refine', 'core.streaming', 'core.governor',\n"
        "       'utils.validate', 'parallel.sharded', 'parallel.launch', 'parallel.group',\n"
        "       'io.geoid', 'models.elevation_report', 'viz.boxes', 'viz.export',\n"
        "       'viz.render', 'ops.sample'}\n"
        "assert {pkg.__name__ + '.' + m for m in new} <= set(names), names\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'pointcloudhookup_tpu', 'PIL', 'pandas', 'matplotlib'))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=root,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    # a spawned rank imports its target's module: here a script that
    # imports only the port, whose two ranks run the modular step
    script = tmp_path / "ranks.py"
    script.write_text(
        "import sys\n"
        "import numpy as np\n"
        "from pointcloudhookup_tpu_torch.parallel import launch, sharded\n\n"
        "def target(device, xyz, mask):\n"
        "    group = sharded.tile_mesh()\n"
        "    import torch\n"
        "    sharded.make_sharded_extract(group)(torch.from_numpy(xyz), torch.from_numpy(mask))\n"
        "    return sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                  ('jax', 'jaxlib', 'pointcloudhookup_tpu'))\n\n"
        "if __name__ == '__main__':\n"
        "    rng = np.random.default_rng(0)\n"
        "    xyz = rng.uniform(-50, 50, (2, 512, 3)).astype(np.float32)\n"
        "    mask = np.ones((2, 512), bool)\n"
        "    out = launch.run_ranks(target, [(xyz[r], mask[r]) for r in range(2)],\n"
        "                           backend='gloo', devices='cpu', timeout=120)\n"
        "    assert out == [[], []], out\n"
        "    print('ranks ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=180, cwd=root, env=env)
    assert res.returncode == 0, res.stderr
    assert "ranks ok" in res.stdout


# (package, JAX name) -> (port module, its replacement): StageTracer's stage
# walls are the spans of the port's one tracer
REPLACED = {(".utils", "StageTracer"): ("pointcloudhookup_tpu_torch.utils.trace", "span")}


@pytest.mark.parametrize("package", ["", ".ops", ".models", ".core", ".utils", ".viz", ".io",
                                     ".parallel"])
def test_public_names_mirror_jax(package):
    """Every name that an __init__.py of the JAX package exports imports
    from the port's __init__.py of the same layout, but for the names the
    port replaced on purpose, whose replacement must exist (REPLACED)."""
    import importlib

    ref = importlib.import_module("pointcloudhookup_tpu" + package)
    mine = importlib.import_module("pointcloudhookup_tpu_torch" + package)
    names = [n for n, v in vars(ref).items()
             if not n.startswith("_") and not isinstance(v, type(importlib))]
    assert names or package == ""
    replaced = {n: r for (p, n), r in REPLACED.items() if p == package}
    missing = [n for n in names if not hasattr(mine, n) and n not in replaced]
    assert not missing, missing
    for name, (module, attr) in replaced.items():
        assert not hasattr(mine, name), name
        assert callable(getattr(importlib.import_module(module), attr)), (name, module, attr)
    if package == "":
        assert mine.__version__ == ref.__version__


def _morton_axes(seed, size):
    rng = np.random.default_rng(seed)
    # beyond 20 bits and negative values exercise the clip
    return [rng.integers(-5, (1 << 20) + 5, size).astype(np.int32) for _ in range(3)]


def test_morton_encode_decode_shift_match_jax():
    ijk = _morton_axes(20, 5000)
    ref = jmorton.morton_encode(*map(jnp.asarray, ijk))
    got = tmorton.morton_encode(*map(torch.from_numpy, ijk))
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_n(g), np.asarray(r))
    for g, r in zip(tmorton.morton_decode(*got), jmorton.morton_decode(*ref)):
        np.testing.assert_array_equal(_n(g), np.asarray(r))
    # the sentinel word decodes through the same arithmetic shifts
    hi = torch.full((4,), tmorton.SENTINEL_HI, dtype=torch.int32)
    for g, r in zip(tmorton.morton_decode(hi, got[1][:4]),
                    jmorton.morton_decode(jnp.asarray(_n(hi)), ref[1][:4])):
        np.testing.assert_array_equal(_n(g), np.asarray(r))
    for shift in (0, 6, 15, 30):
        for g, r in zip(tmorton.shift_code(*got, shift), jmorton.shift_code(*ref, shift)):
            np.testing.assert_array_equal(_n(g), np.asarray(r))
    # one int64 key (hi << 30) | lo orders as the two-word lexicographic sort
    key = (got[0].long() << 30) | got[1].long()
    np.testing.assert_array_equal(
        _n(torch.argsort(key, stable=True)), np.lexsort((_n(got[1]), _n(got[0])))
    )


def test_fma_f32_rounds_once():
    """fma_f32 equals an exact fused multiply-add (long double) on voxel
    decodes, and differs from the twice-rounded product + sum."""
    rng = np.random.default_rng(21)
    a = (rng.integers(0, 1 << 20, 100_000) + 0.5).astype(np.float32)
    vs, mn = np.float32(0.1), np.float32(-5.1)
    got = _n(tmorton.fma_f32(torch.from_numpy(a), torch.tensor(vs), torch.tensor(mn)))
    exact = (a.astype(np.longdouble) * vs + mn).astype(np.float32)
    np.testing.assert_array_equal(got, exact)
    assert (got != a * vs + mn).any()


def test_masked_percentile_bit_identical():
    """Bit-identical to the JAX function under jit, where XLA:CPU contracts
    the lerp into a fused multiply-add (as inside the fused front-end's
    graph).  The extra cases include lerps that the contraction rounds
    differently from the op-by-op JAX call, so the check tells them apart."""
    jf = jax.jit(jpct.masked_percentile, static_argnums=2)
    rng = np.random.default_rng(0)
    extra = []
    for _ in range(40):
        n = int(rng.integers(2, 300))
        x = rng.normal(scale=100, size=n).astype(np.float32)
        mask = rng.random(n) < 0.8
        mask[0] = True
        extra.append((x, mask, float(rng.uniform(0, 100))))
    rounds_differ = False
    for x, mask, q in [*_pct_cases(), *extra]:
        got = tpct.masked_percentile(torch.from_numpy(x), torch.from_numpy(mask), q)
        ref = jf(jnp.asarray(x), jnp.asarray(mask), q)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert np.float32(_n(got)) == np.float32(np.asarray(ref)), q
        eager = jpct.masked_percentile(jnp.asarray(x), jnp.asarray(mask), q)
        rounds_differ |= bool(np.float32(np.asarray(eager)) != np.float32(_n(got)))
    assert rounds_differ


@pytest.mark.parametrize(
    "jparams",
    [
        jconfig.ExtractParams(),
        jconfig.ExtractParams(
            ground=jconfig.GroundParams(percentile=20.0, min_points_after=10),
            cluster=jconfig.ClusterParams(eps=5.0, min_points=30, method="grid",
                                          max_cells=4096, min_cluster_size=7),
            filters=jconfig.TowerFilterParams(min_width=6.0),
            max_clusters=64, obb_angles=64,
        ),
    ],
    ids=["defaults", "custom"],
)
def test_extract_params_carried_across(jparams):
    """The port's config is a copy: the same dataclasses, fields and
    defaults, and state.extract_params_from_dict carries a JAX tree over
    field for field."""
    for name in ("VoxelParams", "GroundParams", "ClusterParams", "TowerFilterParams",
                 "ExtractParams", "MatchParams"):
        jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
        assert dataclasses.asdict(jcls()) == dataclasses.asdict(tcls()), name
        assert [f.name for f in dataclasses.fields(jcls)] == [
            f.name for f in dataclasses.fields(tcls)
        ], name
    got = state.extract_params_from_dict(dataclasses.asdict(jparams))
    assert isinstance(got, tconfig.ExtractParams)
    assert isinstance(got.cluster, tconfig.ClusterParams)
    assert dataclasses.asdict(got) == dataclasses.asdict(jparams)
    with pytest.raises(TypeError):
        state.extract_params_from_dict(dict(dataclasses.asdict(jparams), extra=1))


def test_synthetic_corridor_is_a_copy():
    kw = dict(n_ground=3000, n_veg=500, pts_per_tower=200, extent=250.0, n_line=50)
    got = tsynthetic.synthetic_corridor(np.random.default_rng(4), **kw)
    ref = jsynthetic.synthetic_corridor(np.random.default_rng(4), **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("fmt", [0, 1, 6], ids=["fmt0", "fmt1", "fmt6"])
def test_las_and_laz_read_write_match_jax(tmp_path, fmt):
    """LAS written by either package is byte-identical and reads back the
    same; a LAZ file written by the JAX package decodes through the port's
    copied codec to the JAX reader's records."""
    from pointcloudhookup_tpu.io.laz import write_laz

    pts, _ = tsynthetic.synthetic_corridor(
        np.random.default_rng(5), n_ground=2000, n_veg=300, pts_per_tower=100,
        extent=200.0, origin=(5e5, 3e6, 40.0),
    )
    a, b = tmp_path / "port.las", tmp_path / "jax.las"
    tlas.write_las(tlas.make_las(pts, point_format=fmt), str(a))
    jlas.write_las(jlas.make_las(pts, point_format=fmt), str(b))
    assert a.read_bytes() == b.read_bytes()
    assert tlas.peek_point_count(str(a)) == len(pts)
    got, ref = tlas.read_las(str(a)), jlas.read_las(str(b))
    np.testing.assert_array_equal(got.points, ref.points)
    np.testing.assert_array_equal(got.xyz(), ref.xyz())
    laz = tmp_path / "tile.laz"
    write_laz(jlas.make_las(pts, point_format=fmt), str(laz))
    got, ref = tlas.read_las(str(laz)), jlas.read_las(str(laz))
    assert (got.point_format, got.version, got.num_vlrs) == (
        ref.point_format, ref.version, ref.num_vlrs
    )
    np.testing.assert_array_equal(got.points, ref.points)
