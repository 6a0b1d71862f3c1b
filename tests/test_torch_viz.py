"""The port's viewers on the CPU against the JAX package's: display boxes,
presets, linesets and their JSON bit-equal; the PLY and coloured LAS/LAZ
scenes byte-equal for the same points, labels and geometries; render_scene
pixel-equal (any differing pixel counted and reported); the PNG that
save_png writes (zlib, no imaging library) decoded by PIL equal to the JAX
package's PNG.  Also the properties that tests/test_render.py,
tests/test_ply_export.py and the viz half of tests/test_viz_and_validate.py
hold for the JAX package."""

import json

import numpy as np
import pytest
import torch

from pointcloudhookup_tpu.viz import boxes as jboxes
from pointcloudhookup_tpu.viz import export as jexport
from pointcloudhookup_tpu.viz import render as jrender
from pointcloudhookup_tpu_torch.models.towers import Tower
from pointcloudhookup_tpu_torch.viz import boxes, export, render

PRESETS = sorted(jboxes.BBOX_PRESETS) + ["no_such_preset"]


def _towers(rng, k):
    """k tower dicts with centres, extents, widths, heights and yaws."""
    out = []
    for i in range(k):
        ext = rng.uniform([6, 4, 20], [14, 10, 60])
        out.append(dict(center=rng.uniform(-100, 100, 3), extent=ext,
                        width=float(max(ext[0], ext[1])), height=float(ext[2]),
                        angle=float(rng.uniform(-np.pi, np.pi))))
    return out


def _same_geoms(got, ref):
    assert len(got) == len(ref)
    for (gp, gc), (rp, rc) in zip(got, ref):
        assert gp.dtype == rp.dtype and np.array_equal(gp, rp) and gc == rc


def test_presets_and_box_helpers_bit_equal():
    assert boxes.BBOX_PRESETS == jboxes.BBOX_PRESETS
    for name in PRESETS:
        assert boxes.get_bbox_preset(name) == jboxes.get_bbox_preset(name)
    for h in (5.0, 19.99, 20.0, 39.9, 40.0, 80.0):
        assert boxes.adaptive_scale_for_height(h) == jboxes.adaptive_scale_for_height(h)
    c = np.array([1.5, -2.25, 30.0])
    for params in (jboxes.BBOX_PRESETS[n]["params"] for n in jboxes.BBOX_PRESETS
                   if n.startswith("kuangxuan")):
        got = boxes.expand_box_kuangxuan(c, 9.3, 41.7, **params)
        ref = jboxes.expand_box_kuangxuan(c, 9.3, 41.7, **params)
        assert all(np.array_equal(g, r) for g, r in zip(got, ref))
    mn, mx = np.array([-1.0, -2, -3]), np.array([4.0, 5, 6])
    lines = boxes.box_lineset(mn, mx)
    assert lines.shape == (24, 3) and np.array_equal(lines, jboxes.box_lineset(mn, mx))
    corners = np.random.default_rng(0).normal(size=(8, 3))
    assert np.array_equal(boxes.box_lineset(corners), jboxes.box_lineset(corners))


@pytest.mark.parametrize("method,preset", [("kuangxuan", p) for p in PRESETS]
                         + [("symmetric", None)])
def test_tower_display_geometries_bit_equal(method, preset):
    towers = _towers(np.random.default_rng(1), 5)
    kw = dict(method=method, preset=preset)
    _same_geoms(boxes.tower_display_geometries(towers, **kw),
                jboxes.tower_display_geometries(towers, **kw))
    for extra in (dict(scale_factors=[2.0, 2.5, 3.0]), dict(adaptive_scaling=False),
                  dict(color=(0.0, 1.0, 0.5))):
        _same_geoms(boxes.tower_display_geometries(towers, **kw, **extra),
                    jboxes.tower_display_geometries(towers, **kw, **extra))


def test_tower_display_geometries_of_port_towers_with_tensors():
    """The port's Tower records, numpy or tensors in their fields, give the
    JAX function's boxes for the same values."""
    towers = _towers(np.random.default_rng(2), 4)
    ported = [Tower(id=f"t{i}", center=torch.from_numpy(t["center"]),
                    extent=torch.from_numpy(t["extent"]),
                    height=torch.tensor(t["height"], dtype=torch.float64),
                    width=t["width"], north_angle=0.0,
                    angle=torch.tensor(t["angle"], dtype=torch.float64),
                    num_points=10, label=i) for i, t in enumerate(towers)]
    for method in ("kuangxuan", "symmetric"):
        _same_geoms(boxes.tower_display_geometries(ported, method=method),
                    jboxes.tower_display_geometries(towers, method=method))


def test_geometries_json_bytes_equal(tmp_path):
    geoms = jboxes.tower_display_geometries(_towers(np.random.default_rng(3), 6))
    boxes.export_geometries_json(geoms, str(tmp_path / "t.json"))
    jboxes.export_geometries_json(geoms, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    payload = json.loads((tmp_path / "t.json").read_text())
    assert len(payload) == 6 and all(len(g["points"]) == 24 for g in payload)


@pytest.mark.parametrize("n,cap", [(50, 100), (1000, 1000), (5000, 700)])
def test_subsample_indices_equal(n, cap):
    got = boxes.subsample_indices(n, cap, seed=4)
    assert np.array_equal(got, jboxes.subsample_indices(n, cap, seed=4))
    assert len(got) == min(n, cap) and len(np.unique(got)) == len(got)
    pts = np.random.default_rng(5).normal(size=(n, 3))
    assert np.array_equal(boxes.subsample_for_display(pts, cap, seed=4),
                          jboxes.subsample_for_display(pts, cap, seed=4))


def test_palette_and_colours_equal():
    for n in (1, 2, 24, 100):
        assert np.array_equal(export.cluster_palette(n), jexport.cluster_palette(n))
    labels = np.random.default_rng(6).integers(-1, 9, 500)
    for acc in (None, [0, 3], [7, 2, 5]):
        ref = jexport.colors_from_labels(labels, acc)
        assert np.array_equal(export.colors_from_labels(labels, acc), ref)
        assert np.array_equal(export.colors_from_labels(torch.from_numpy(labels), acc), ref)
    z = np.random.default_rng(7).normal(50, 20, 400)
    assert np.array_equal(export.height_colors(z), jexport.height_colors(z))
    assert np.array_equal(export.height_colors(np.full(5, 3.0)),
                          jexport.height_colors(np.full(5, 3.0)))


@pytest.mark.parametrize("cap", [500_000, 700])
@pytest.mark.parametrize("coloured", ["labels", "height", "colors"])
def test_ply_scene_bytes_equal(tmp_path, cap, coloured):
    rng = np.random.default_rng(8)
    pts = rng.normal(0, 30, (2000, 3)) + [5e5, 3.1e6, 80.0]
    labels = rng.integers(-1, 6, len(pts))
    kw = dict(labels=labels, accepted_labels=[1, 4]) if coloured == "labels" else (
        dict(colors=rng.integers(0, 256, (len(pts), 3)).astype(np.uint8))
        if coloured == "colors" else {})
    geoms = jboxes.tower_display_geometries(_towers(rng, 3))
    got = export.export_scene_ply(str(tmp_path / "t.ply"), pts, geoms=geoms,
                                  display_cap=cap, **kw)
    ref = jexport.export_scene_ply(str(tmp_path / "j.ply"), pts, geoms=geoms,
                                   display_cap=cap, **kw)
    assert got == ref
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    mine, theirs = (export.read_ply_scene(str(tmp_path / "t.ply")),
                    jexport.read_ply_scene(str(tmp_path / "t.ply")))
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(mine, theirs))
    assert len(mine[0]) == min(cap, len(pts)) + 3 * 24 and len(mine[2]) == 3 * 12


@pytest.mark.parametrize("ext", ["las", "laz"])
def test_las_scene_bytes_equal(tmp_path, ext):
    rng = np.random.default_rng(9)
    pts = rng.normal(0, 10, (3000, 3))
    labels = torch.from_numpy(rng.integers(-1, 4, len(pts)))
    got = export.export_scene_las(str(tmp_path / f"t.{ext}"), pts, labels=labels,
                                  display_cap=2500)
    ref = jexport.export_scene_las(str(tmp_path / f"j.{ext}"), pts, labels=labels.numpy(),
                                   display_cap=2500)
    assert got == ref and got["cloud_points"] == 2500
    assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()


def test_ply_roundtrip_with_boxes_and_errors(tmp_path):
    """tests/test_ply_export.py's round trip and reader errors, on the
    port."""
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 10, (500, 3))
    labels = np.repeat(np.arange(5) - 1, 100)
    corners = boxes.box_lineset(np.array([-1.0, -1, -1]), np.array([1.0, 1, 1]))
    geoms = [(corners, (1.0, 0.0, 0.0)), (corners + 5.0, (0.0, 1.0, 0.0))]
    path = str(tmp_path / "scene.ply")
    summary = export.export_scene_ply(path, pts, labels=labels, geoms=geoms)
    assert summary == dict(vertices=548, cloud_points=500, boxes=2, edges=24)
    xyz, rgb, edges = export.read_ply_scene(path)
    np.testing.assert_allclose(xyz[:500], pts, atol=1e-4)
    assert (rgb[:500] == export.colors_from_labels(labels)).all()
    assert (rgb[500] == [255, 0, 0]).all() and (rgb[524] == [0, 255, 0]).all()
    assert edges.min() >= 500 and edges.max() < len(xyz)
    odd = tmp_path / "odd.ply"
    odd.write_bytes(b"ply\nformat binary_little_endian 1.0\n"
                    b"element vertex 0\nproperty double x\nend_header\n")
    with pytest.raises(ValueError, match="unsupported PLY property type"):
        export.read_ply_scene(str(odd))
    odd.write_bytes(b"ply\nformat binary_little_endian 1.0\n"
                    b"element face 0\nproperty list uchar int vertex_indices\nend_header\n")
    with pytest.raises(ValueError, match="list properties"):
        export.read_ply_scene(str(odd))
    with pytest.raises(ValueError):
        export.export_scene_ply(str(tmp_path / "x.ply"), np.zeros((4, 3)),
                                colors=np.zeros((3, 3), np.uint8))


# ---------------------------------------------------------------- render
def _render_both(pts, geoms=(), **kw):
    """The port's render on the CPU and the JAX package's; returns both
    images and the number of pixels that differ (printed)."""
    got = render.render_scene(pts, geoms, device="cpu", **kw)
    ref = jrender.render_scene(pts, geoms, **kw)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    differ = int((got != ref).any(axis=2).sum())
    print(f"render_scene: {differ} of {got.shape[0] * got.shape[1]} pixels differ")
    return got, ref, differ


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_scene_pixel_equal_to_jax(seed):
    """A corridor-like scene with boxes of several colours: the port's image
    is the JAX package's pixel for pixel."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform([-200, -40, 0], [200, 40, 3], (20000, 3)),
                          rng.normal([0, 0, 20], [3, 3, 10], (3000, 3))]) + [4.3e5, 3.12e6, 80]
    geoms = [(lines, col) for (lines, _), col in zip(
        jboxes.tower_display_geometries(
            [dict(t, center=t["center"] + [4.3e5, 3.12e6, 80]) for t in _towers(rng, 4)]),
        [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.2, 0.4, 1.0), (1.0, 1.0, 0.0)])]
    _, _, differ = _render_both(pts, geoms, width=320, height=240, display_cap=15000,
                                seed=seed)
    assert differ == 0


def test_render_duplicate_pixels_resolve_as_jax():
    """Many points on one pixel at equal and unequal depths: the nearest
    wins, and among equally near ones the latest (the JAX splat's last
    write); overlapping edges of two colours: the later edge wins."""
    rng = np.random.default_rng(3)
    base = rng.uniform(-5, 5, (40, 3))
    pts = np.concatenate([np.repeat(base, 6, axis=0), base[::-1], base + 1e-9])
    colours = rng.integers(0, 256, (len(pts), 3)).astype(np.uint8)
    box = jboxes.box_lineset(np.array([-3.0, -3, -3]), np.array([3.0, 3, 3]))
    geoms = [{"lines": box, "color": (1.0, 0.0, 0.0)},
             {"lines": box, "color": (0.0, 0.0, 1.0)},
             {"lines": box[:8] * 0.5, "color": (0.0, 1.0, 0.0)}]
    got, _, differ = _render_both(pts, geoms, width=96, height=72, point_colors=colours)
    assert differ == 0
    assert ((got == [0, 0, 255]).all(axis=2)).sum() > 20


def test_render_properties():
    """tests/test_render.py's properties on the port: the camera fit, the
    colour ramp, points in view, a wireframe alone, occlusion, the cap."""
    cam = render.Camera.fit_bounds([-10, -10, 0], [10, 10, 20])
    ref = jrender.Camera.fit_bounds([-10, -10, 0], [10, 10, 20])
    assert np.array_equal(cam.position, ref.position)
    assert all(np.array_equal(a, b) for a, b in zip(cam.basis(), ref.basis()))
    z = np.linspace(0.0, 1.0, 101)
    assert np.array_equal(render.height_colormap(z), jrender.height_colormap(z))
    c = render.height_colormap(z)
    assert c[0, 2] > 200 and c[0, 0] == 0 and c[-1, 0] > 200 and c[-1, 2] == 0

    rng = np.random.default_rng(42)
    img = render.render_scene(rng.normal(0, 5.0, (5000, 3)), width=320, height=240,
                              background=(0, 0, 0), device="cpu")
    assert img.shape == (240, 320, 3) and 0.005 < (img.sum(axis=2) > 0).mean() < 0.9

    lines = boxes.box_lineset(np.array([-5.0, -5, -5]), np.array([5.0, 5, 5]))
    img = render.render_scene(np.zeros((0, 3)), [{"lines": lines, "color": (0.0, 1.0, 0.0)}],
                              width=200, height=200, background=(0, 0, 0),
                              camera=render.Camera.fit_bounds([-5] * 3, [5] * 3), device="cpu")
    assert ((img[:, :, 1] == 255) & (img[:, :, 0] == 0)).sum() > 50
    assert (img[:, :, 0] == 0).all()

    cam = render.Camera(position=(0, -20, 0), focal=(0, 0, 0), fov_deg=30.0)
    img = render.render_scene(np.array([[0.0, 0.0, 0.0], [0.0, 10.0, 0.0]]), width=64,
                              height=64, camera=cam, background=(0, 0, 0), device="cpu",
                              point_colors=np.array([[255, 0, 0], [0, 0, 255]], np.uint8))
    assert (img[:, :, 0] == 255).sum() == 1 and (img[:, :, 2] == 255).sum() == 0

    pts = rng.uniform(-10, 10, (10_000, 3))
    full = render.render_scene(pts, width=160, height=120, display_cap=10_000, device="cpu")
    cap = render.render_scene(pts, width=160, height=120, display_cap=500, device="cpu")
    assert (cap.sum(axis=2) > 44).sum() < (full.sum(axis=2) > 44).sum()


def test_png_decodes_as_jax_png(tmp_path):
    """save_png's file, decoded by PIL, equals the JAX package's PNG
    (written by PIL) decoded by PIL; the port's own reader agrees."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(11)
    pts = rng.uniform(-10, 10, (2000, 3))
    geoms = jboxes.tower_display_geometries(
        [dict(center=[0.0, 0.0, 10.0], extent=[8.0, 8.0, 20.0], width=8.0, height=20.0,
              angle=0.3)])
    mine = render.render_to_png(pts, geoms, str(tmp_path / "t.png"), width=320, height=240,
                                device="cpu")
    jrender.render_to_png(pts, geoms, str(tmp_path / "j.png"), width=320, height=240)
    got = np.asarray(Image.open(mine))
    assert got.shape == (240, 320, 3) and Image.open(mine).mode == "RGB"
    assert np.array_equal(got, np.asarray(Image.open(tmp_path / "j.png")))
    assert np.array_equal(render.read_png(mine), got)


def test_png_writer_alone(tmp_path):
    """save_png and read_png round-trip any u8 image; the reader refuses
    what it cannot read."""
    img = np.random.default_rng(12).integers(0, 256, (7, 13, 3)).astype(np.uint8)
    render.save_png(img, str(tmp_path / "a.png"))
    assert np.array_equal(render.read_png(str(tmp_path / "a.png")), img)
    (tmp_path / "b.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        render.read_png(str(tmp_path / "b.png"))
