"""Morton-style cell keys.

Counterpart of ``pointcloudhookup_tpu/ops/morton.py``; only
``interleave_tight`` is on the exact extraction path so far.  The JAX key
is uint32; here it is held in int64 (uint32 has thin operator coverage on
CUDA), where every key of <= 31 bits stays below the 0xFFFFFFFF sentinel.
"""

from __future__ import annotations

import torch


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
