"""Scene export (binary PLY, coloured LAS/LAZ) for external viewers.

Copy of ``pointcloudhookup_tpu/viz/export.py`` (host numpy): one binary
little-endian PLY holding the display-capped cloud with per-point RGB
(cluster colours where labels are given, else a height ramp) and the tower
wireframes (``viz/boxes.py`` linesets) as coloured vertices joined by
``edge`` elements; its LAS/LAZ twin (point format 2, RGB x257, .laz through
``io/laz.py::write_laz``); and a reader for the PLYs written here.  Labels
that come from the card are read to the host once.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from pointcloudhookup_tpu_torch.viz.boxes import _host, subsample_indices

# noise / ground / padding points
_GRAY = np.array([120, 120, 120], np.uint8)


def cluster_palette(n: int) -> np.ndarray:
    """u8[n,3] visually-distinct colors via golden-angle hue stepping
    (full saturation, alternating value so adjacent indices differ)."""
    h = (np.arange(n) * 0.61803398875) % 1.0
    v = np.where(np.arange(n) % 2 == 0, 1.0, 0.78)
    s = np.full(n, 0.95)
    i = np.floor(h * 6.0).astype(int) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    rgb = np.choose(
        i[:, None],
        [
            np.stack([v, t, p], 1),
            np.stack([q, v, p], 1),
            np.stack([p, v, t], 1),
            np.stack([p, q, v], 1),
            np.stack([t, p, v], 1),
            np.stack([v, p, q], 1),
        ],
    )
    return (rgb * 255.0 + 0.5).astype(np.uint8)


def colors_from_labels(
    labels: np.ndarray, accepted_labels: Optional[Sequence[int]] = None
) -> np.ndarray:
    """u8[N,3] per-point colors: label<0 -> gray; accepted tower labels
    get bright palette colors (in tower order); other clusters a dim
    blue-gray so towers stand out.  Labels may be a tensor on any device."""
    labels = np.asarray(_host(labels))
    out = np.tile(_GRAY, (len(labels), 1))
    if accepted_labels is None:
        accepted_labels = sorted(int(v) for v in np.unique(labels) if v >= 0)
    pal = cluster_palette(max(len(accepted_labels), 1))
    other = labels >= 0
    out[other] = np.array([90, 110, 150], np.uint8)
    for i, lab in enumerate(accepted_labels):
        out[labels == int(lab)] = pal[i]
    return out


def height_colors(z: np.ndarray) -> np.ndarray:
    """u8[N,3] blue->cyan->yellow ramp over the z range (the headless
    twin of the render widget's height shading, viz/render.py)."""
    z = np.asarray(z, np.float64)
    lo, hi = (float(z.min()), float(z.max())) if len(z) else (0.0, 1.0)
    t = (z - lo) / (hi - lo) if hi > lo else np.zeros_like(z)
    r = np.clip(2.0 * t - 0.5, 0, 1)
    g = np.clip(1.2 * t + 0.15, 0, 1)
    b = np.clip(1.0 - 1.6 * t, 0, 1)
    return (np.stack([r, g, b], 1) * 255.0 + 0.5).astype(np.uint8)


def export_scene_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    accepted_labels: Optional[Sequence[int]] = None,
    geoms: Optional[Sequence] = None,
    display_cap: int = 500_000,
    seed: int = 0,
) -> dict:
    """Write one binary little-endian PLY holding the (display-capped)
    cloud and the tower wireframes.  `geoms` is viz/boxes.py's
    [(f64[24,3] edge-pair points, rgb01)] lineset format.  Returns a
    small summary dict (counts written)."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if colors is None:
        colors = (
            colors_from_labels(labels, accepted_labels)
            if labels is not None
            else height_colors(points[:, 2])
        )
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    if len(colors) != len(points):
        raise ValueError("colors/points length mismatch")
    idx = subsample_indices(len(points), display_cap, seed)
    pts, cols = points[idx], colors[idx]

    box_pts, box_cols, edges = [], [], []
    base = len(pts)
    for g_pts, g_col in geoms or []:
        g_pts = np.asarray(g_pts, np.float64).reshape(-1, 3)
        c = (np.asarray(g_col, np.float64) * 255.0 + 0.5).astype(np.uint8)
        box_pts.append(g_pts)
        box_cols.append(np.tile(c, (len(g_pts), 1)))
        e = np.arange(len(g_pts), dtype=np.int32).reshape(-1, 2) + base
        edges.append(e)
        base += len(g_pts)
    if box_pts:
        pts = np.vstack([pts] + box_pts)
        cols = np.vstack([cols] + box_cols)
    edge_arr = (
        np.vstack(edges) if edges else np.zeros((0, 2), np.int32)
    )

    vert = np.empty(
        len(pts),
        dtype=[
            ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
            ("red", "u1"), ("green", "u1"), ("blue", "u1"),
        ],
    )
    vert["x"], vert["y"], vert["z"] = (pts[:, k].astype(np.float32) for k in range(3))
    vert["red"], vert["green"], vert["blue"] = cols[:, 0], cols[:, 1], cols[:, 2]
    edge = np.empty(len(edge_arr), dtype=[("vertex1", "<i4"), ("vertex2", "<i4")])
    if len(edge_arr):
        edge["vertex1"], edge["vertex2"] = edge_arr[:, 0], edge_arr[:, 1]

    header = "\n".join(
        [
            "ply",
            "format binary_little_endian 1.0",
            # the JAX package's comment line: the same bytes as its PLY
            "comment pointcloudhookup_tpu scene export",
            f"element vertex {len(vert)}",
            "property float x",
            "property float y",
            "property float z",
            "property uchar red",
            "property uchar green",
            "property uchar blue",
            f"element edge {len(edge)}",
            "property int vertex1",
            "property int vertex2",
            "end_header",
        ]
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii") + b"\n")
        f.write(vert.tobytes())
        f.write(edge.tobytes())
    return {
        "vertices": int(len(vert)),
        "cloud_points": int(len(idx)),
        "boxes": len(geoms or []),
        "edges": int(len(edge)),
    }


def export_scene_las(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    accepted_labels: Optional[Sequence[int]] = None,
    display_cap: int = 500_000,
    seed: int = 0,
) -> dict:
    """Colored LAS/LAZ twin of export_scene_ply: point format 2 (u16
    RGB, u8 colors scaled x257 per the LAS convention).  A path ending
    in `.laz` is LASzip-compressed via io.laz.write_laz; anything else
    gets raw LAS bytes.  Wireframes cannot ride in LAS — use the PLY
    export when boxes are wanted."""
    from pointcloudhookup_tpu_torch.io.las import make_las, write_las
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if colors is None:
        colors = (
            colors_from_labels(labels, accepted_labels)
            if labels is not None
            else height_colors(points[:, 2])
        )
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    if len(colors) != len(points):
        raise ValueError("colors/points length mismatch")
    idx = subsample_indices(len(points), display_cap, seed)
    las = make_las(points[idx], point_format=2)
    rgb16 = colors[idx].astype(np.uint16) * 257
    las.points["red"], las.points["green"], las.points["blue"] = (
        rgb16[:, 0], rgb16[:, 1], rgb16[:, 2],
    )
    if str(path).lower().endswith(".laz"):
        from pointcloudhookup_tpu_torch.io.laz import write_laz

        write_laz(las, path)
    else:
        write_las(las, path)
    return {"vertices": int(len(idx)), "cloud_points": int(len(idx)),
            "boxes": 0, "edges": 0}


def read_ply_scene(path: str):
    """Minimal reader for the PLYs this module writes (and any binary
    little-endian PLY restricted to the same two elements).  Returns
    (xyz f64[N,3], rgb u8[N,3], edges i32[E,2])."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    lines = data[:end].decode("ascii").splitlines()
    if lines[0] != "ply" or "format binary_little_endian 1.0" not in lines[1]:
        raise ValueError("not a binary little-endian PLY")
    counts, props, current = {}, {}, None
    for ln in lines[2:]:
        parts = ln.split()
        if parts[0] == "element":
            current = parts[1]
            counts[current] = int(parts[2])
            props[current] = []
        elif parts[0] == "property" and current:
            if parts[1] == "list":
                raise ValueError(
                    "list properties are not supported by this reader "
                    f"(element {current!r}: {ln.strip()!r})"
                )
            props[current].append((parts[-1], parts[1]))
    typemap = {"float": "<f4", "uchar": "u1", "int": "<i4"}
    off = end
    out = {}
    for el in counts:
        for _, t in props[el]:
            if t not in typemap:
                raise ValueError(
                    f"unsupported PLY property type {t!r} in element {el!r} "
                    "(this reader handles float/uchar/int)"
                )
        dt = np.dtype([(n, typemap[t]) for n, t in props[el]])
        n = counts[el]
        out[el] = np.frombuffer(data, dt, count=n, offset=off)
        off += dt.itemsize * n
    v = out.get("vertex", np.zeros(0, dtype=[("x", "<f4")]))
    xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64) if len(v) else np.zeros((0, 3))
    rgb = (
        np.stack([v["red"], v["green"], v["blue"]], 1)
        if len(v) and "red" in (v.dtype.names or ())
        else np.zeros((len(v), 3), np.uint8)
    )
    e = out.get("edge", np.zeros(0, dtype=[("vertex1", "<i4"), ("vertex2", "<i4")]))
    edges = np.stack([e["vertex1"], e["vertex2"]], 1).astype(np.int32) if len(e) else np.zeros((0, 2), np.int32)
    return xyz, rgb, edges
