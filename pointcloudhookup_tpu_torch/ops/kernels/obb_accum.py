"""Sort-free per-cluster OBB accumulators, over raw coordinates or over
Morton-coded voxel rows.

Counterpart of ``pointcloudhookup_tpu/ops/pallas/obb_accum.py::
obb_accumulate_xyz`` and ``::obb_accumulate``.  The CUDA kernels are
``csrc/obb_accum.cu``, one tile walk with two row loaders.  The plain
PyTorch version reduces with ``scatter_reduce`` over the labelled rows in
chunks (the JAX oracle's [N, K, A] one-hot would not fit at the path's
shapes).  Both take the angle table from ``angle_table`` so they project
with identical cos/sin values.  The Morton variant decodes a voxel centre
as ``ix * vs + off`` with ``off = mn + vs/2`` rounded once, as the TPU
kernel does (the JAX oracle adds mn and vs/2 separately, which can differ
by one ulp), and the product and sum rounded once, as XLA:CPU compiles the
kernel (a fused multiply-add: ``fma_f32`` here, ``__fmaf_rn`` in CUDA).
"""

from __future__ import annotations

import math

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build
from pointcloudhookup_tpu_torch.utils import trace
from pointcloudhookup_tpu_torch.ops.morton import fma_f32, morton_decode


_BIG = 3.0e38
_CHUNK_ROWS = 1 << 16
NAMES = ("cnt", "sx", "sy", "sz", "zlo", "zhi", "ulo", "uhi", "vlo", "vhi")


def angle_table(num_angles: int, device):
    """(cos, sin) float32[A] of angle_j = j * (pi/2) / A, computed in f32
    like the JAX kernel's table."""
    step = torch.tensor(math.pi / 2.0 / num_angles, dtype=torch.float32)
    ang = torch.arange(num_angles, dtype=torch.float32) * step
    return ang.cos().to(device), ang.sin().to(device)


_TABLES: dict = {}


def cached_angle_table(num_angles: int, device):
    """angle_table's values, copied to ``device`` once per (A, device): the
    copy from host memory waits for the device, so the kernels' wrappers
    must not make it on every call."""
    key = (num_angles, torch.device(device))
    if key not in _TABLES:
        _TABLES[key] = angle_table(num_angles, device)
    return _TABLES[key]


def obb_accumulate_xyz(x, y, z, labels, *, max_clusters: int = 128,
                       num_angles: int = 256):
    """x/y/z float32[N]; labels int32[N], id in [0, K) or anything else to
    skip.  Returns dict(cnt, sx, sy, sz, zlo, zhi [K]; ulo, uhi, vlo, vhi
    [K, A]) of the rotated-frame projection extremes; column 0 is the
    axis-aligned frame."""
    if x.device.type == "cpu":
        return obb_accumulate_xyz_plain(
            x, y, z, labels, max_clusters=max_clusters, num_angles=num_angles
        )
    build.require_cuda("obb_accumulate_xyz", x, y, z, labels)
    n = x.shape[0]
    for t in (x, y, z):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"x, y, z must be float32[{n}]")
    if labels.dtype != torch.int32 or labels.shape != (n,):
        raise ValueError(f"labels must be int32[{n}]")
    k, a = max_clusters, num_angles
    lib = build.library()
    cos_a, sin_a = cached_angle_table(a, x.device)
    out = torch.empty(6 * k + 4 * k * a, dtype=torch.float32, device=x.device)
    rc = lib.pch_obb_accumulate_xyz(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), labels.data_ptr(), n,
        cos_a.data_ptr(), sin_a.data_ptr(), k, a, out.data_ptr(),
        build.stream(x.device),
    )
    build.check(rc, "obb_accumulate_xyz")
    trace.count("kernel.obb_accumulate_xyz")
    return _unpack(out, k, a)


def _unpack(out, k: int, a: int):
    """The accumulators dict of a kernel's flat float32[6K + 4KA] output."""
    per_cluster = out[: 6 * k].view(6, k)
    per_angle = out[6 * k :].view(4, k, a)
    return dict(zip(NAMES, (*per_cluster.unbind(0), *per_angle.unbind(0))))


def obb_accumulate_xyz_plain(x, y, z, labels, *, max_clusters: int = 128,
                             num_angles: int = 256):
    """Plain PyTorch version: same contract."""
    k, a = max_clusters, num_angles
    dev = x.device
    sel = torch.nonzero((labels >= 0) & (labels < k)).squeeze(1)
    lab = labels[sel].long()
    xs, ys, zs = x[sel], y[sel], z[sel]
    f32 = torch.float32

    def fill(shape, v):
        return torch.full(shape, v, dtype=f32, device=dev)

    out = dict(
        cnt=torch.bincount(lab, minlength=k).to(f32),
        sx=fill((k,), 0.0).index_add_(0, lab, xs),
        sy=fill((k,), 0.0).index_add_(0, lab, ys),
        sz=fill((k,), 0.0).index_add_(0, lab, zs),
        zlo=fill((k,), _BIG).scatter_reduce_(0, lab, zs, "amin"),
        zhi=fill((k,), -_BIG).scatter_reduce_(0, lab, zs, "amax"),
    )
    cos_a, sin_a = angle_table(a, dev)
    ext = {
        "ulo": fill((k * a,), _BIG), "uhi": fill((k * a,), -_BIG),
        "vlo": fill((k * a,), _BIG), "vhi": fill((k * a,), -_BIG),
    }
    cols = torch.arange(a, device=dev)
    for r0 in range(0, sel.shape[0], _CHUNK_ROWS):
        px = xs[r0 : r0 + _CHUNK_ROWS, None]
        py = ys[r0 : r0 + _CHUNK_ROWS, None]
        u = (px * cos_a[None, :] + py * sin_a[None, :]).reshape(-1)
        v = (py * cos_a[None, :] - px * sin_a[None, :]).reshape(-1)
        idx = (lab[r0 : r0 + _CHUNK_ROWS, None] * a + cols[None, :]).reshape(-1)
        ext["ulo"].scatter_reduce_(0, idx, u, "amin")
        ext["uhi"].scatter_reduce_(0, idx, u, "amax")
        ext["vlo"].scatter_reduce_(0, idx, v, "amin")
        ext["vhi"].scatter_reduce_(0, idx, v, "amax")
    out.update({key: val.view(k, a) for key, val in ext.items()})
    return out


def _morton_offset(mn, voxel_size: float):
    """(vs, off): the float32 voxel size (a number) and mn + vs/2 as a
    float32 tensor on mn's device, rounded once as the TPU kernel rounds
    it.  vs/2 is exact in float32, so adding it as a number gives the same
    bits as adding a float32 tensor, with no copy to the device."""
    vs = torch.tensor(voxel_size, dtype=torch.float32).item()
    return vs, (mn + vs * 0.5).to(torch.float32)


def obb_accumulate(hi, lo, labels, mn, *, voxel_size: float = 0.1,
                   max_clusters: int = 128, num_angles: int = 256):
    """The accumulators of obb_accumulate_xyz over Morton-coded rows:
    hi/lo int32[N] voxel codes on the grid with origin mn float32[3],
    labels int32[N] (id in [0, K), anything else skips the row)."""
    if hi.device.type == "cpu":
        return obb_accumulate_plain(
            hi, lo, labels, mn, voxel_size=voxel_size,
            max_clusters=max_clusters, num_angles=num_angles,
        )
    build.require_cuda("obb_accumulate", hi, lo, labels, mn)
    n = hi.shape[0]
    for name, t in (("hi", hi), ("lo", lo), ("labels", labels)):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"{name} must be int32[{n}]")
    if mn.dtype != torch.float32 or mn.shape != (3,):
        raise ValueError("mn must be float32[3]")
    k, a = max_clusters, num_angles
    lib = build.library()
    _, off = _morton_offset(mn, voxel_size)
    cos_a, sin_a = cached_angle_table(a, hi.device)
    out = torch.empty(6 * k + 4 * k * a, dtype=torch.float32, device=hi.device)
    rc = lib.pch_obb_accumulate(
        hi.data_ptr(), lo.data_ptr(), labels.data_ptr(), n, off.data_ptr(),
        float(voxel_size), cos_a.data_ptr(), sin_a.data_ptr(), k, a,
        out.data_ptr(), build.stream(hi.device),
    )
    build.check(rc, "obb_accumulate")
    trace.count("kernel.obb_accumulate")
    return _unpack(out, k, a)


def obb_accumulate_plain(hi, lo, labels, mn, *, voxel_size: float = 0.1,
                         max_clusters: int = 128, num_angles: int = 256):
    """Plain PyTorch version: same contract."""
    vs, off = _morton_offset(mn, voxel_size)
    vs = torch.tensor(vs, dtype=torch.float32, device=hi.device)
    x, y, z = (
        fma_f32(v.to(torch.float32), vs, off[a])
        for a, v in enumerate(morton_decode(hi, lo))
    )
    return obb_accumulate_xyz_plain(
        x, y, z, labels, max_clusters=max_clusters, num_angles=num_angles
    )
