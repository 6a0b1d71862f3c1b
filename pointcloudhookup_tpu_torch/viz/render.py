"""Headless offscreen renderer: points and tower wireframes to a PNG.

Counterpart of ``pointcloudhookup_tpu/viz/render.py``.  ``Camera`` (the
auto-fit along the bounds diagonal) and ``height_colormap`` are host
copies; ``render_scene`` projects, z-buffers and rasterises on torch tensors
on ``device`` (the card by default), and ``save_png`` writes the RGB PNG
with ``zlib`` and ``struct`` (no imaging library).

The image is the JAX package's, pixel for pixel:
- The JAX splat sorts points far to near (stable) and writes them in turn,
  so the last write wins.  Here each pixel is resolved once: the smallest
  z, and among equal z the point latest in that order (the largest position
  in the subsample).  The z-buffer is a ``scatter_reduce_`` "amin".
- Each edge is sampled at numpy's ``linspace(0, 1, n)`` (``arange(n) *
  (1 / (n - 1))``, the last sample 1), and where edges share a pixel the
  later edge's visible sample wins, as the JAX loop draws edge by edge.
- The projection's float64 dot products are three products summed left to
  right, on either device, so the card and the CPU round alike.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from pointcloudhookup_tpu_torch.viz.boxes import subsample_indices

# the display cap of the interactive viewer the renderer stands in for
DISPLAY_CAP = 500_000


class Camera:
    """Perspective camera auto-fitted along the bounds diagonal: focal
    point = bounds center, position = center + diagonal-scaled offset along
    a fixed view direction, view-up = +z."""

    def __init__(self, position, focal, up=(0.0, 0.0, 1.0), fov_deg=30.0):
        self.position = np.asarray(position, np.float64)
        self.focal = np.asarray(focal, np.float64)
        self.up = np.asarray(up, np.float64)
        self.fov_deg = float(fov_deg)

    @classmethod
    def fit_bounds(cls, mins, maxs, *, azimuth_deg=-60.0, elevation_deg=25.0,
                   distance_scale=1.8, fov_deg=30.0):
        mins = np.asarray(mins, np.float64)
        maxs = np.asarray(maxs, np.float64)
        center = (mins + maxs) / 2.0
        diag = float(np.linalg.norm(maxs - mins))
        diag = diag if diag > 0 else 1.0
        az = np.radians(azimuth_deg)
        el = np.radians(elevation_deg)
        direction = np.array(
            [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)]
        )
        pos = center + direction * diag * distance_scale
        return cls(pos, center, fov_deg=fov_deg)

    def basis(self):
        fwd = self.focal - self.position
        fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
        right = np.cross(fwd, self.up)
        nr = np.linalg.norm(right)
        if nr < 1e-9:  # looking straight along up: pick any right
            right = np.cross(fwd, np.array([1.0, 0.0, 0.0]))
            nr = np.linalg.norm(right)
        right = right / nr
        true_up = np.cross(right, fwd)
        return right, true_up, fwd


def _dot3(rel, axis):
    """rel @ axis for f64 rel[N, 3] and a host axis[3]: three products
    summed left to right, never a fused or blocked reduction."""
    a0, a1, a2 = (float(v) for v in axis)
    return rel[:, 0] * a0 + rel[:, 1] * a1 + rel[:, 2] * a2


def _project(pts, camera: Camera, width: int, height: int):
    """World points f64[N, 3] (a tensor) -> (ix, iy, depth, in_front)."""
    right, up, fwd = camera.basis()
    rel = pts - torch.as_tensor(camera.position, dtype=torch.float64, device=pts.device)
    x = _dot3(rel, right)
    y = _dot3(rel, up)
    z = _dot3(rel, fwd)  # camera-space depth
    in_front = z > 1e-6
    zs = torch.where(in_front, z, torch.ones_like(z))
    f = (height / 2.0) / np.tan(np.radians(camera.fov_deg) / 2.0)
    # (f * x) / zs, a true division by a tensor on either device
    ix = torch.round(width / 2.0 + f * x / zs).long()
    iy = torch.round(height / 2.0 - f * y / zs).long()
    return ix, iy, z, in_front


def height_colormap(z: np.ndarray) -> np.ndarray:
    """Blue->cyan->green->yellow->red by normalized height, u8[N,3]."""
    z = np.asarray(z, np.float64)
    lo, hi = np.nanmin(z), np.nanmax(z)
    t = (z - lo) / max(hi - lo, 1e-9)
    # piecewise-linear jet-like ramp without matplotlib
    r = np.clip(np.minimum(4 * t - 2, 1.0), 0.0, 1.0)
    g = np.clip(np.minimum(4 * t, 4 - 4 * t), 0.0, 1.0)
    b = np.clip(np.minimum(2 - 4 * t, 1.0), 0.0, 1.0)
    return (np.stack([r, g, b], axis=1) * 255).astype(np.uint8)


def _last_writer(flat, order, npix: int):
    """For each pixel, the largest ``order`` among the rows that write it
    (-1 where none does)."""
    win = torch.full((npix,), -1, dtype=torch.int64, device=flat.device)
    return win.scatter_reduce_(0, flat, order, "amax")


def _edge_samples(lines, camera: Camera, width: int, height: int):
    """Every sample point of every edge, in drawing order, as the JAX loop
    takes them: edges with both ends in front, n = min(max(|dx|, |dy|, 1) +
    1, 8192) samples each at numpy's linspace(0, 1, n).  lines: f64[E, 2, 3]
    on the device.  Returns (points f64[S, 3], edge index int64[S])."""
    e = lines.shape[0]
    ix, iy, _, front = _project(lines.reshape(-1, 3), camera, width, height)
    ends = torch.stack([ix, iy, front.long()], 1).reshape(e, 2, 3).cpu().numpy()
    keep = (ends[:, 0, 2] > 0) & (ends[:, 1, 2] > 0)
    span = np.maximum(np.abs(ends[:, 1, :2] - ends[:, 0, :2]).max(axis=1), 1)
    n = np.where(keep, np.minimum(span + 1, 8192), 0)
    edge = torch.repeat_interleave(torch.arange(e, device=lines.device),
                                   torch.as_tensor(n, device=lines.device))
    first = np.concatenate([[0], np.cumsum(n)[:-1]])
    i = (torch.arange(int(n.sum()), device=lines.device)
         - torch.as_tensor(first, device=lines.device)[edge])
    step = torch.as_tensor(1.0 / np.maximum(n - 1, 1), dtype=torch.float64,
                           device=lines.device)[edge]
    t = i.double() * step
    t = torch.where(i == torch.as_tensor(n - 1, device=lines.device)[edge],
                    torch.ones_like(t), t)[:, None]
    a, b = lines[edge, 0], lines[edge, 1]
    return a * (1 - t) + b * t, edge


def render_scene(
    points: np.ndarray,
    geometries=(),
    *,
    width: int = 1280,
    height: int = 960,
    camera: Camera | None = None,
    point_colors: np.ndarray | None = None,
    background=(12, 12, 20),
    display_cap: int = DISPLAY_CAP,
    seed: int = 0,
    device="cuda",
) -> np.ndarray:
    """Rasterize points + wireframe geometries to u8[H, W, 3] on ``device``.

    points: [N,3] float; geometries: the (lines, color) pairs that
    viz.boxes.tower_display_geometries emits, or dicts with a "lines" array
    of point PAIRS [(2E), 3] and an optional "color" (r,g,b floats 0-1).
    """
    dev = torch.device(device)
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    # subsample via indices so caller-supplied per-point colors stay
    # aligned with the displayed subset
    sub = subsample_indices(len(pts), display_cap, seed)
    pts = pts[sub]
    geometries = [
        g if isinstance(g, dict) else {"lines": g[0], "color": g[1]}
        for g in geometries
    ]
    if point_colors is None and len(pts):
        point_colors = height_colormap(pts[:, 2])
    elif point_colors is not None:
        point_colors = np.asarray(point_colors, np.uint8).reshape(-1, 3)[sub]

    # scene bounds over points AND geometry
    all_min = pts.min(axis=0) if len(pts) else np.zeros(3)
    all_max = pts.max(axis=0) if len(pts) else np.ones(3)
    for g in geometries:
        ln = np.asarray(g["lines"], np.float64).reshape(-1, 3)
        if len(ln):
            all_min = np.minimum(all_min, ln.min(axis=0))
            all_max = np.maximum(all_max, ln.max(axis=0))
    if camera is None:
        camera = Camera.fit_bounds(all_min, all_max)

    npix = height * width
    img = torch.as_tensor(np.asarray(background, np.uint8), device=dev).repeat(npix, 1)
    zbuf = torch.full((npix,), float("inf"), dtype=torch.float64, device=dev)

    if len(pts):
        ix, iy, z, ok = _project(torch.from_numpy(pts).to(dev), camera, width, height)
        ok &= (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
        pos = torch.nonzero(ok).squeeze(1)
        flat, z = iy[pos] * width + ix[pos], z[pos]
        zbuf.scatter_reduce_(0, flat, z, "amin")
        # the last write of the far-to-near splat: the nearest point, and
        # among equally near ones the latest
        near = z == zbuf[flat]
        win = _last_writer(flat[near], pos[near], npix)
        hit = torch.nonzero(win >= 0).squeeze(1)
        cols = torch.from_numpy(np.ascontiguousarray(point_colors)).to(dev)
        img[hit] = cols[win[hit]]

    # wireframes: each edge sampled at ~1 sample a pixel and drawn with a
    # small depth bias so boxes stay visible over their own points; the
    # z-buffer holds the points only
    lines = [np.asarray(g["lines"], np.float64).reshape(-1, 2, 3) for g in geometries]
    if sum(len(ln) for ln in lines):
        colors = np.concatenate([
            np.tile((np.clip(np.asarray(g.get("color", (1.0, 0.2, 0.2)), np.float64), 0, 1)
                     * 255).astype(np.uint8), (len(ln), 1))
            for g, ln in zip(geometries, lines)])
        seg, edge = _edge_samples(torch.from_numpy(np.concatenate(lines)).to(dev),
                                  camera, width, height)
        ix, iy, z, ok = _project(seg, camera, width, height)
        ok &= (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
        pos = torch.nonzero(ok).squeeze(1)
        flat = iy[pos] * width + ix[pos]
        vis = z[pos] <= zbuf[flat] * 1.02 + 1e-3  # depth bias
        win = _last_writer(flat[vis], pos[vis], npix)
        hit = torch.nonzero(win >= 0).squeeze(1)
        img[hit] = torch.from_numpy(colors).to(dev)[edge[win[hit]]]
    return img.reshape(height, width, 3).cpu().numpy()


def save_png(img: np.ndarray, path: str) -> None:
    """Write u8[H, W, 3] as an 8-bit RGB PNG (no filter, one zlib stream)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read the PNGs save_png writes (8-bit RGB, unfiltered rows) back to
    u8[H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a PNG: {path}")
    pos, idat, size = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, ctype, interlace) != (8, 2, 0):
                raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNGs are read")
            size = (h, w)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    h, w = size
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered PNG rows are not read")
    return rows[:, 1:].reshape(h, w, 3).copy()


def render_to_png(
    points,
    geometries=(),
    path: str = "scene.png",
    **kwargs,
) -> str:
    """Points + tower geometries -> PNG file on disk (kwargs go to
    render_scene, ``device`` among them)."""
    save_png(render_scene(points, geometries, **kwargs), path)
    return path
