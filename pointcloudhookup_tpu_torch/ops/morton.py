"""Morton (Z-order) keys.

Counterpart of ``pointcloudhookup_tpu/ops/morton.py``.  The 60-bit voxel
code is two int32 words (hi: bits 30..59, lo: bits 0..29), with the same
arithmetic right shifts as the reference; lexicographic (hi, lo) order is
numeric Morton order, and ``(hi << 30) | lo`` packs the pair losslessly
into one int64 sort key.  ``interleave_tight`` keys are held in int64
(uint32 has thin operator coverage on CUDA), where every key of <= 31 bits
stays below the 0xFFFFFFFF sentinel.
"""

from __future__ import annotations

import torch

BITS_PER_AXIS = 20
SENTINEL_HI = 0x7FFFFFFF  # sorts after every valid code


def _spread10(v):
    """Spread the low 10 bits of v to bits 0,3,6,...,27 (30 bits)."""
    x = v & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact10(x):
    """Inverse of _spread10."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x3FF
    return x


def morton_encode(ix, iy, iz):
    """20-bit/axis Morton code as (hi, lo) int32 words; each axis is
    clipped to [0, 2**20)."""
    top = (1 << BITS_PER_AXIS) - 1
    ix, iy, iz = (torch.clamp(v, 0, top).to(torch.int32) for v in (ix, iy, iz))
    lo = _spread10(ix) | (_spread10(iy) << 1) | (_spread10(iz) << 2)
    hi = (
        _spread10(ix >> 10)
        | (_spread10(iy >> 10) << 1)
        | (_spread10(iz >> 10) << 2)
    )
    return hi, lo


def morton_decode(hi, lo):
    """(hi, lo) -> (ix, iy, iz)."""
    ix = _compact10(lo) | (_compact10(hi) << 10)
    iy = _compact10(lo >> 1) | (_compact10(hi >> 1) << 10)
    iz = _compact10(lo >> 2) | (_compact10(hi >> 2) << 10)
    return ix, iy, iz


def shift_code(hi, lo, shift3k: int):
    """Right-shift a 60-bit (hi, lo) code by shift3k <= 30 bits (a
    coarser grid)."""
    if shift3k == 0:
        return hi, lo
    if shift3k > 30:
        raise ValueError("shift must be <= 30")
    low_bits_of_hi = hi & ((1 << shift3k) - 1)
    lo_shifted = (lo >> shift3k) | (low_bits_of_hi << (30 - shift3k))
    return hi >> shift3k, lo_shifted


def fma_f32(a, b, c):
    """float32 a * b + c rounded ONCE, like the fused multiply-add that
    XLA:CPU makes of a product feeding a sum (its LLVM backend contracts
    them), and like ``__fmaf_rn`` on CUDA.

    On a CUDA tensor this is ``torch.addcmul``, whose elementwise CUDA
    kernel contracts the product into the sum (one float32 fused
    multiply-add, no float64 temporaries); ``chip_smoke.py`` and
    ``tests/test_torch_cuda.py`` hold it bit for bit against the float64
    form below, also where a * b nearly cancels c.  On the CPU the float64
    form: the product is exact, and the result is exact wherever the sum
    needs at most 53 bits.  The voxel-centre decodes always do: a is an
    integer or half-integer below 2**21, b the float32 voxel size (24-bit
    mantissa) and c an origin on the voxel lattice, so a * b + c is a
    multiple of ulp(b) / 2 below 2**25 voxels."""
    if a.is_cuda:
        return torch.addcmul(c, a, b)
    out = a.double() * b.double()
    if out.shape == torch.broadcast_shapes(out.shape, c.shape):
        out += c  # in place: c widens to float64 exactly, no float64 copy of it
    else:
        out = out + c.double()
    return out.to(torch.float32)


def interleave_tight(ix, iy, iz, bits: tuple):
    """Tight Morton-style interleave with STATIC per-axis bit widths
    (bx, by, bz), sum(bits) <= 32: bit positions are assigned round-robin
    over the axes that still have bits at each level, so the key occupies
    exactly sum(bits) bits.  Values are masked to their widths.  Returns
    int64 keys in [0, 2**sum(bits))."""
    bx, by, bz = bits
    if bx + by + bz > 32:
        raise ValueError(f"sum(bits)={bx + by + bz} exceeds 32")
    out = torch.zeros(ix.shape, dtype=torch.int64, device=ix.device)
    p = 0
    for lvl in range(max(bits)):
        for v, b in ((ix, bx), (iy, by), (iz, bz)):
            if lvl < b:
                out |= ((v.to(torch.int64) >> lvl) & 1) << p
                p += 1
    return out
